"""The port's honest load and ReID int8 accuracy gate
(``yolo_deepsort_tpu_torch/tools/honest_load.py``, ``int8_gate.py``)
against the reference tools and the JAX package on the CPU, from the same
seeded numpy inputs (the detector gates: ``test_torch_port_int8_detect_
gates.py``):

* every numpy helper of the three gates, and ``plant_box_prior``, equal to
  the reference's bit for bit (the reference tool modules import only
  numpy at their top level);
* ``bn_weights_and_frames`` at yolov3-tiny, img 64, 2 x 64x128: frames
  equal, folded params within 1e-4 of each layer's largest magnitude (the
  two frameworks' f32 batch statistics sum in another order), the port's
  calibration on the JAX package's folded params equal to the JAX
  thresholds (within 1e-6), and its own thresholds within 1e-2 of them;
* the ReID gate at 4 ids, 3 steps, batch 8: every step's loss within 1e-5
  relative of the JAX step from the same state; the routes' features from one folded net
  against the JAX routes': f32 within 1e-5, bf16 and both int8 routes at
  a mean cosine > 0.9999;
* the ReID gate's ``main`` with ``--device cpu`` at a tiny size: one JSON
  line with the reference's keys, ``route`` and ``launches``.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import bench
from yolo_deepsort_tpu.cfg.architectures import ARCHITECTURES as J_ARCH
from yolo_deepsort_tpu.models import weights as JW
from yolo_deepsort_tpu.models.darknet import build_network as j_build
from yolo_deepsort_tpu.models.darknet import network_apply
from yolo_deepsort_tpu.models import quantize as JQ
from yolo_deepsort_tpu.models.quantize_darknet import (
    make_xla_int8_conv_impl,
    quantize_darknet_convs as j_quantize_convs,
)
from yolo_deepsort_tpu.models.reid import fold_train_params as j_fold
from yolo_deepsort_tpu.models.reid import reid_apply
from yolo_deepsort_tpu.train import reid_train as JRT
from yolo_deepsort_tpu.train import yolo_cli as JYC
from yolo_deepsort_tpu_torch.kernels.launches import LAUNCH_COUNTERS
from yolo_deepsort_tpu_torch.models.darknet import Darknet
from yolo_deepsort_tpu_torch.models.quantize_darknet import quantize_darknet_convs
from yolo_deepsort_tpu_torch.ops.letterbox import letterbox_batch
from yolo_deepsort_tpu_torch.tools import honest_load as HL
from yolo_deepsort_tpu_torch.tools import int8_detect_gate as TDG
from yolo_deepsort_tpu_torch.tools import int8_gate as TRG
from yolo_deepsort_tpu_torch.tools import int8_gate_trained as TTG
from yolo_deepsort_tpu_torch.weights import (
    darknet_params_from_folded,
    fold_inference_params,
)
from torch_port_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TINY = ("yolov3-tiny", 64, (64, 128))  # model, img size, frame (h, w)
TARGET = 8


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return {name: _reference_tool(name)
            for name in ("int8_gate", "int8_detect_gate",
                         "int8_gate_trained", "bench_probes")}


# --- the numpy helpers, bit for bit


def _boxes7(rng, n):
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(2, 30, (n, 2))
    return np.concatenate([xy, xy + wh, rng.uniform(0, 1, (n, 2)),
                           rng.integers(0, 3, (n, 1))], 1).astype(np.float32)


@pytest.mark.parametrize("gate", ["int8_gate", "int8_detect_gate",
                                  "int8_gate_trained"])
def test_numpy_helpers_equal_the_reference(ref, gate):
    r = ref[gate]
    if gate == "int8_gate":
        for seed in (0, 1):
            got, want = TRG.make_dataset(3, 2, seed), r.make_dataset(3, 2, seed)
            for a, b in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(a, b)
            pal = np.full((3, 3), 0.5, np.float32)
            np.testing.assert_array_equal(
                TRG.render_identity(np.random.default_rng(seed), pal, 3),
                r.render_identity(np.random.default_rng(seed), pal, 3))
        rng = np.random.default_rng(2)
        qf, gf = rng.normal(size=(6, 8)), rng.normal(size=(5, 8))
        qy, gy = rng.integers(0, 3, 6), rng.integers(0, 3, 5)
        assert TRG.rank1(qf, gf, qy, gy) == r.rank1(qf, gf, qy, gy)
    elif gate == "int8_detect_gate":
        rng = np.random.default_rng(3)
        a, b = _boxes7(rng, 9), _boxes7(rng, 7)
        np.testing.assert_array_equal(TDG.iou_matrix(a[:, :4], b[:, :4]),
                                      r.iou_matrix(a[:, :4], b[:, :4]))
        assert TDG.iou_matrix(a[:0, :4], b[:, :4]).shape == (0, 7)
        for aware in (False, True):
            assert (TDG.greedy_match(a, b, 0.1, aware)
                    == r.greedy_match(a, b, 0.1, aware))
    else:
        for seed in (0, 5):
            got = TTG.synth_scene(np.random.default_rng(seed), 64)
            want = r.synth_scene(np.random.default_rng(seed), 64)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        labels = [TTG.synth_scene(np.random.default_rng(s), 64)[1]
                  for s in range(12)]
        for max_t in (48, 10):
            for a, b in zip(TTG.batch_targets(labels, max_t),
                            r.batch_targets(labels, max_t)):
                np.testing.assert_array_equal(a, b)
        rng = np.random.default_rng(4)
        b7 = np.stack([_boxes7(rng, 6) for _ in range(3)])
        mask = rng.uniform(size=(3, 6)) < 0.6

        def nms(decoded, conf):
            return decoded, mask & (decoded[..., 4] >= conf)

        sets = [TTG.postnms(b7, 0.3, nms), r.postnms(b7, 0.3, nms)]
        for a, b in zip(*sets):
            np.testing.assert_array_equal(a, b)
        other = TTG.postnms(b7 + 1.0, 0.2, nms)
        assert (TTG.match_sets(sets[0], other)
                == r.match_sets(sets[0], other))


def test_plant_box_prior_equals_the_reference():
    from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
    from yolo_deepsort_tpu_torch.models.darknet import build_network

    for model, size, hw in (("yolov3", 416, (1080, 1920)),
                            ("yolov3-tiny", 64, (64, 128))):
        plan = build_network(ARCHITECTURES[model](img_size=size))
        rng = np.random.default_rng(1)
        raw = {}  # the head convs, which are all the prior touches
        for head in plan.heads:
            i = head.module_index - 1
            co = (5 + head.num_classes) * len(head.anchors)
            raw[i] = {"conv_weight": rng.normal(size=(co, 16, 1, 1)).astype(
                np.float32), "conv_bias": rng.normal(size=co).astype(
                np.float32)}
        got = HL.plant_box_prior({i: dict(l) for i, l in raw.items()}, plan,
                                 hw)
        want = bench.plant_box_prior({i: dict(l) for i, l in raw.items()},
                                     j_build(J_ARCH[model](img_size=size)),
                                     hw)
        for i in raw:
            for k in raw[i]:
                np.testing.assert_array_equal(got[i][k], want[i][k])
    assert (HL.BOX_PRIOR_HEIGHTS, HL.BOX_PRIOR_ASPECT) == (
        bench.BOX_PRIOR_HEIGHTS, bench.BOX_PRIOR_ASPECT)


# --- the honest load


@pytest.fixture(scope="module")
def loads(ref):
    model, size, hw = TINY
    jplan, jparams, jframes, jconf = ref["bench_probes"].bn_weights_and_frames(
        model, size, 2, 2, hw, TARGET)
    load = HL.bn_weights_and_frames(model, size, 2, 2, hw, TARGET,
                                    device="cpu")
    jfolded = {i: {k: np.asarray(v) for k, v in p.items()}
               for i, p in jparams.items()}
    return dict(jplan=jplan, jfolded=jfolded, jframes=np.asarray(jframes),
                jconf=np.asarray(jconf), load=load)


def _darknet(plan, folded, dtype=torch.float32):
    m = Darknet(plan)
    m.load_params(darknet_params_from_folded(folded))
    m = m.eval()
    if dtype == torch.bfloat16:
        m = m.to(torch.bfloat16, memory_format=torch.channels_last)
    return m


def test_bn_weights_and_frames_match_the_reference(loads):
    load = loads["load"]
    np.testing.assert_array_equal(load.frames.numpy(), loads["jframes"])
    folded = fold_inference_params(load.raw, load.plan.defs())
    assert set(folded) == set(loads["jfolded"])
    for i, p in folded.items():
        for k in ("w", "b"):
            want = loads["jfolded"][i][k]
            err = np.abs(p[k] - want).max()
            assert err <= 1e-4 * max(np.abs(want).max(), 1e-6), (i, k, err)
    # the calibration alone, on the JAX package's weights: the same
    # thresholds; end to end (the port's own weights) within 1e-2
    det16 = _darknet(load.plan, loads["jfolded"], torch.bfloat16)
    conf = HL.calibrate_conf(det16, load.frames[0], TINY[1], TARGET)
    np.testing.assert_allclose(conf, loads["jconf"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(load.conf_vec, loads["jconf"], rtol=0,
                               atol=1e-2)
    assert load.detector.convs["0"].weight.dtype == torch.float32
    assert load.detector_bf16.convs["0"].weight.dtype == torch.bfloat16


# --- the ReID gate

N_IDS, STEPS, BATCH, VIEWS = 4, 3, 8, 2


@pytest.fixture(scope="module")
def reid_run():
    """Both frameworks' gate training on one dataset and batch draw; the
    JAX run keeps its state before every step."""
    x, y, pal, rng = TRG.make_dataset(N_IDS, VIEWS, 0)
    folded, losses, _ = TRG.train_embedder(x, y, rng, N_IDS, STEPS, BATCH,
                                           0.05, 0, "cpu")
    x, y, pal, rng = TRG.make_dataset(N_IDS, VIEWS, 0)
    params, stats = JRT.init_train_params(num_classes=N_IDS, seed=0)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    stats = jax.tree_util.tree_map(jnp.asarray, stats)
    opt_init, train_step = JRT.make_train_step(lr=0.05)
    opt_state = opt_init(params)
    step = jax.jit(train_step)
    j_losses, before = [], []
    for _ in range(STEPS):
        idx = rng.choice(len(x), size=min(BATCH, len(x)), replace=False)
        before.append((jax.device_get(params), jax.device_get(
            opt_state[1][0].trace), jax.device_get(stats), idx))
        params, opt_state, stats, loss, _ = step(params, opt_state, stats,
                                                 x[idx], y[idx])
        j_losses.append(float(loss))
    j_folded = j_fold(jax.device_get(params), jax.device_get(stats))
    return dict(x=x, y=y, pal=pal, losses=losses,
                j_losses=np.array(j_losses), before=before, folded=folded,
                j_folded=j_folded)


def test_reid_gate_training_matches_jax(reid_run):
    """The gate's training (``train_embedder``: its dataset, batch draw, lr
    0.05) against the reference's loop on the JAX step. Each port step
    started from the JAX step's own state (params, momentum trace, BN
    stats) on the gate's batch: loss within 1e-5 relative. The first step
    of the port's own run likewise. Two whole runs then drift apart: a
    ReLU whose input lies within f32 rounding of zero passes its gradient
    in one framework only (``test_torch_port_train_reid.py``), and lr 0.05
    on 8 crops amplifies it (measured 7.4e-4 at the second step and
    2.4e-2 at the third): held to 5e-2."""
    from yolo_deepsort_tpu_torch.train.reid_train import make_train_step
    from yolo_deepsort_tpu_torch.train.trees import to_torch
    from yolo_deepsort_tpu_torch.utils.checkpoint import tree_leaves

    init, step = make_train_step(lr=0.05)
    x, y = reid_run["x"], reid_run["y"]
    for k, (params, trace, stats, idx) in enumerate(reid_run["before"]):
        t_params = to_torch(params, "cpu", trainable=True)
        opt = init(t_params)
        if k:
            for p, buf in zip(tree_leaves(t_params), tree_leaves(trace)):
                opt.state[p]["momentum_buffer"] = torch.from_numpy(
                    np.array(buf))
        _, loss, _ = step(t_params, opt, to_torch(stats, "cpu"), x[idx],
                          y[idx])
        np.testing.assert_allclose(float(loss), reid_run["j_losses"][k],
                                   rtol=1e-5, err_msg=f"step {k}")
    losses = reid_run["losses"]
    assert losses.shape == (STEPS,)
    np.testing.assert_allclose(losses[0], reid_run["j_losses"][0], rtol=1e-5)
    np.testing.assert_allclose(losses, reid_run["j_losses"], rtol=5e-2)


def test_reid_gate_routes_match_jax(reid_run):
    folded = reid_run["j_folded"]
    calib = reid_run["x"][:64]
    r = np.random.default_rng(1000)
    qx = np.stack([TRG.render_identity(r, reid_run["pal"][i], 1)
                   for i in range(N_IDS)]).reshape(-1, 128, 64, 3)
    got = TRG.embed_routes(folded, calib, {"q": qx}, "cpu")
    jx = jnp.asarray(qx)
    qp = JQ.quantize_reid_params(folded, calib)
    qres = JQ.quantize_reid_params_resident(folded, calib)
    want = {  # jitted, as the reference gate runs them
        "f32": reid_apply(folded, jx),
        "bf16": jax.jit(lambda v: reid_apply(
            folded, v, compute_dtype=jnp.bfloat16))(jx),
        "int8": jax.jit(lambda v: JQ.reid_apply_int8(qp, v))(jx),
        "int8_res": JQ.reid_apply_int8_resident(qres, jx),
    }
    want["walker"] = want["f32"]  # the walker is held to the f32 net
    for route, w in want.items():
        g, w = got[route]["q"], np.asarray(w, np.float32)
        assert g.shape == w.shape == (len(qx), 512)
        if route in ("f32", "walker"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=route)
        else:
            assert TRG.mean_cos(g, w) > 0.9999, route
    np.testing.assert_array_equal(got["int8_res"]["q"],
                                  got["int8_res_plain"]["q"])


# --- the command lines


REFERENCE_KEYS = {
    "int8_gate": {"metric", "ok", "train_acc", "rank1_f32", "rank1_bf16",
                  "rank1_int8", "rank1_int8_res", "cos_bf16_vs_f32",
                  "cos_int8_vs_f32", "cos_int8_res_vs_f32",
                  "walker_max_diff", "ids", "steps", "secs"},
    "int8_detect_gate": {"gate", "ok", "model", "route", "pct", "k3_only",
                         "int8_layers", "dets_f32", "dets_int8",
                         "matched_frac_f32", "matched_frac_int8", "mean_iou",
                         "conf_mae", "cls_agreement", "elapsed_s"},
    "int8_gate_trained": {"metric", "ok", "model", "img_size", "train_loss",
                          "dets_per_frame", "score_margin_above_thr",
                          "int8_layers", "int8_route", "int8_vs_f32",
                          "bf16_vs_f32_yardstick", "bars"},
}
TINY_ARGV = {
    "int8_gate": ["--ids", "2", "--steps", "1", "--batch", "2", "--views",
                  "1", "--eval-views", "1"],
    "int8_detect_gate": ["--model", "yolov3-tiny", "--img-size", "64",
                         "--frames", "2", "--frame-h", "64", "--frame-w",
                         "128", "--target-dets", "8"],
    "int8_gate_trained": ["--img-size", "64", "--steps", "2", "--batch", "4",
                          "--eval-frames", "2"],
}


def check_main(mod, tool, capsys):
    """``mod.main`` at the tool's tiny argv with ``--device cpu``: one
    JSON line with the reference's keys, ``route`` and ``launches``."""
    rc = mod.main(TINY_ARGV[tool] + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert REFERENCE_KEYS[tool] <= set(rec), REFERENCE_KEYS[tool] - set(rec)
    assert rc == (0 if rec["ok"] else 1)
    assert rec["route"] == "cpu"
    assert set(rec["launches"]) == set(LAUNCH_COUNTERS)
    assert not any(rec["launches"].values())  # nothing launches on the CPU
    # on the CPU the kernel routes are the plain versions
    for key in ("int8_res_kernel_vs_plain_max_abs",
                "decoded_kernel_vs_plain_max_abs"):
        assert rec.get(key, 0) == 0


def test_main_prints_one_json_line(capsys):
    check_main(TRG, "int8_gate", capsys)
