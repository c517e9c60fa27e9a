"""The port's detector int8 gates (``yolo_deepsort_tpu_torch/tools/
int8_detect_gate.py``, ``int8_gate_trained.py``) against the reference
tools and the JAX package on the CPU, from the same seeded numpy inputs
(their numpy helpers, the honest load and the ReID gate:
``test_torch_port_int8_gates.py``, whose fixtures this file shares):

* the detect gate at yolov3-tiny-64: ``wq`` byte-equal to the JAX
  package's on the same folded weights (scales and biases within 1e-5:
  the calibration forwards sum in another order), and the plain twin's
  decoded output against the XLA twin's (``DECODED_TOL``);
* ``ClippedAdam`` against ``optax.chain(clip_by_global_norm, adam)``, 3
  steps above and below the clip; the trained gate's first 3 losses
  against the JAX step's (``TRAINED_LOSS_RTOL``);
* both tools' ``main`` with ``--device cpu`` at tiny sizes: one JSON line with the reference's keys, ``route`` and ``launches``.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from test_torch_port_int8_gates import (  # noqa: F401 (fixtures)
    TINY,
    _darknet,
    check_main,
    loads,
    ref,
)
from yolo_deepsort_tpu.cfg.architectures import ARCHITECTURES as J_ARCH
from yolo_deepsort_tpu.models import weights as JW
from yolo_deepsort_tpu.models.darknet import build_network as j_build
from yolo_deepsort_tpu.models.darknet import network_apply
from yolo_deepsort_tpu.models.quantize_darknet import (
    make_xla_int8_conv_impl,
    quantize_darknet_convs as j_quantize_convs,
)
from yolo_deepsort_tpu.train import yolo_cli as JYC
from yolo_deepsort_tpu_torch.models.quantize_darknet import quantize_darknet_convs
from yolo_deepsort_tpu_torch.ops.letterbox import letterbox_batch
from yolo_deepsort_tpu_torch.tools import int8_detect_gate as TDG
from yolo_deepsort_tpu_torch.tools import int8_gate_trained as TTG
from torch_port_threads import torch_threads  # noqa: F401

# the plain int8 twin against the XLA twin on the same folded weights and
# package: both bf16 forwards round once per conv, so they differ only
# where an f32 sum's order tips a bf16 rounding (or an int8 code) -- the
# decoded boxes are pixels at 64 px, scores in [0, 1]
DECODED_TOL = 4e-2
# the trained gate's loss per step against the JAX step (both Adam after a
# global-norm clip; Adam's normalised update turns tiny gradient
# differences into whole steps of lr on a few leaves)
TRAINED_LOSS_RTOL = 1e-4


# --- the detect gate


def test_detect_gate_package_and_twin_match_jax(loads):
    """On the JAX package's folded weights and one letterboxed batch: the
    port's package byte-equal (``wq``) and within float rounding (scales,
    biases); the plain twin's decoded output against the XLA twin's."""
    load, jfolded = loads["load"], loads["jfolded"]
    xs = letterbox_batch(load.frames[0], TINY[1])
    det = _darknet(load.plan, jfolded)
    pkg = quantize_darknet_convs(det, xs)
    jpkg = j_quantize_convs(loads["jplan"], jax.tree_util.tree_map(
        jnp.asarray, jfolded), jnp.asarray(xs.numpy()))
    assert set(pkg) == set(jpkg) and pkg
    for i in pkg:
        np.testing.assert_array_equal(pkg[i]["wq"], np.asarray(jpkg[i]["wq"]))
        for k in ("scale", "b", "xinv"):
            np.testing.assert_allclose(pkg[i][k], np.asarray(jpkg[i][k]),
                                       rtol=1e-5, err_msg=f"{i} {k}")
    det16 = _darknet(load.plan, jfolded, torch.bfloat16)
    with torch.no_grad():
        got, k7 = TDG.int8_decode(det16, xs, jpkg, plain_twin=True)
        kernel_route, _ = TDG.int8_decode(det16, xs, jpkg, plain_twin=False)
    jparams = jax.tree_util.tree_map(jnp.asarray, jfolded)
    twin = jax.jit(lambda x: network_apply(
        loads["jplan"], jparams, x, compute_dtype=jnp.bfloat16,
        conv_impl=make_xla_int8_conv_impl(jpkg)))
    want = np.asarray(twin(jnp.asarray(xs.numpy())), np.float32)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= DECODED_TOL
    # on the CPU both routes are plain versions: equal, no launch counted
    assert torch.equal(got, kernel_route) and k7 == 0


# --- the trained gate


def test_clipped_adam_matches_optax():
    """Three updates, gradient norms above and below max_norm 5: params
    within 1e-6 of optax's."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(scale=sc, size=s).astype(np.float32)
              for s in shapes] for sc in (3.0, 0.1, 2.0)]
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-2))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in p0]
    opt = TTG.ClippedAdam(tp, 1e-2, max_norm=5.0)
    for g in grads:
        norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g))
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"norm {norm:.2f}")


def test_trained_gate_first_losses_match_jax(ref):
    model, size, steps, batch = "yolov3-tiny", 64, 3, 4
    from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
    from yolo_deepsort_tpu_torch.models.darknet import build_network

    plan = build_network(ARCHITECTURES[model](img_size=size))
    raw = JW.random_raw_params(plan.defs(), seed=0)
    rng = np.random.default_rng(0)
    scenes = [TTG.synth_scene(rng, size) for _ in range(4 * batch)]
    _, _, losses, _ = TTG.train_detector(plan, raw, scenes, rng, steps,
                                         batch, 5e-4, "cpu")

    jplan = j_build(J_ARCH[model](img_size=size))
    params, stats = JYC.raw_params_to_train(raw, jplan.defs())
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(5e-4))
    opt_state = tx.init(params)
    step = jax.jit(JYC.make_detection_train_step(jplan, tx))
    rng = np.random.default_rng(0)
    scenes = [ref["int8_gate_trained"].synth_scene(rng, size)
              for _ in range(4 * batch)]
    imgs_all = np.stack([s[0] for s in scenes]).astype(np.float32) / 255.0
    want = []
    for _ in range(steps):
        idx = rng.choice(4 * batch, batch, replace=False)
        targets, tmask = ref["int8_gate_trained"].batch_targets(
            [scenes[i][1] for i in idx])
        params, opt_state, stats, loss, _ = step(
            params, opt_state, stats, imgs_all[idx], targets, tmask)
        want.append(float(loss))
    np.testing.assert_allclose(losses.numpy(), want,
                               rtol=TRAINED_LOSS_RTOL, atol=0)



@pytest.mark.parametrize("tool", ["int8_detect_gate", "int8_gate_trained"])
def test_main_prints_one_json_line(tool, capsys):
    check_main({"int8_detect_gate": TDG, "int8_gate_trained": TTG}[tool],
               tool, capsys)
