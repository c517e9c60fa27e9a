"""The port's YOLO detection training (``train/yolo_loss.py``,
``train/yolo_cli.py``) against the JAX package's on the CPU, from the same
seeded params (``raw_params_to_train`` gives both the same numpy trees;
``trees.to_torch`` makes them the port's tensors):

* the loss per term against JAX's and the numpy oracle
  (``specs/yolo_loss_np.py``), MSE and CIoU boxes, with 0, 1 and many
  targets and two targets in one cell: f32 rtol 1e-5 against JAX, the
  JAX suite's 2e-3 against the f64 oracle;
* the gradient of the total loss through ``make_forward_train`` for every
  leaf against ``jax.grad``: within 1e-4 of the leaf's largest gradient;
* three ``make_detection_train_step`` steps with ``build_optimizer`` (SGD,
  momentum, decay, burn-in) against JAX's three optax steps: params, BN
  stats and loss;
* overfitting one batch, resume, and the CLI on a generated image list
  (``--device cpu``): train, checkpoint, resume, export ``.weights`` that
  the port's inference ``Darknet`` loads.

The network is the JAX CLI tests' ``TINY_CFG`` (64-px input, 3 stride-2
convs and a head of 2 classes).
"""

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from specs.yolo_loss_np import yolo_head_loss as loss_np
from test_yolo_cli import TINY_CFG
from yolo_deepsort_tpu.cfg import parse_model_config as j_parse
from yolo_deepsort_tpu.models.darknet import build_network as j_build
from yolo_deepsort_tpu.models.weights import random_raw_params
from yolo_deepsort_tpu.train import yolo_cli as JC
from yolo_deepsort_tpu.train.yolo_loss import yolo_head_loss as j_head_loss
from yolo_deepsort_tpu_torch.cfg import parse_model_config
from yolo_deepsort_tpu_torch.models.darknet import build_network
from yolo_deepsort_tpu_torch.train import yolo_cli as TC
from yolo_deepsort_tpu_torch.train.trees import to_numpy, to_torch
from yolo_deepsort_tpu_torch.train.yolo_loss import yolo_head_loss
from yolo_deepsort_tpu_torch.utils.checkpoint import tree_leaves
from torch_port_threads import torch_threads  # noqa: F401


ANCHORS = ((16.0, 32.0), (32.0, 16.0), (48.0, 48.0))
_j_head_loss = jax.jit(j_head_loss, static_argnums=(3, 4, 5),
                       static_argnames=("box_loss",))
TERMS = ("loss_x", "loss_y", "loss_w", "loss_h", "loss_conf", "loss_cls")


def _loss_case(n_targets, duplicate=False, nB=2, g=8, nC=4, seed=0):
    """A raw NHWC head map and ``n_targets`` padded target rows in distinct
    cells (``duplicate``: a last row in the cell of the first, another
    class and box)."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(0, 1, (nB, g, g, len(ANCHORS) * (5 + nC))).astype(
        np.float32)
    rows, used = [], set()
    while len(rows) < n_targets:
        b = int(rng.integers(0, nB))
        cx, cy = rng.uniform(0.05, 0.95, 2)
        if (b, int(cx * g), int(cy * g)) in used:
            continue
        used.add((b, int(cx * g), int(cy * g)))
        rows.append([b, rng.integers(0, nC), cx, cy, rng.uniform(0.05, 0.4),
                     rng.uniform(0.05, 0.4)])
    if duplicate:
        b, c, cx, cy, w, h = rows[0]
        rows.append([b, (c + 1) % nC, cx + 0.01, cy + 0.01, w, h])
    t = np.zeros((16, 6), np.float32)
    mask = np.zeros(16, bool)
    t[:len(rows)] = np.asarray(rows, np.float32).reshape(-1, 6)
    mask[:len(rows)] = True
    return raw, t, mask, nC


CASES = {"none": (0, False), "one": (1, False), "many": (9, False),
         "duplicate": (4, True)}


@pytest.mark.parametrize("box_loss", ["mse", "ciou"])
@pytest.mark.parametrize("case", list(CASES))
def test_yolo_loss_matches_jax_and_oracle(case, box_loss):
    """Per term against JAX (f32 rtol 1e-5) and, for MSE boxes, against
    the f64 oracle (rel 2e-3). A cell two targets share takes the later
    target's box (the oracle's numpy assignment; JAX's scatter on the CPU
    agrees), and a 1 at both classes."""
    n, dup = CASES[case]
    raw, t, mask, nC = _loss_case(n, dup)
    img = 128
    total_t, m_t = yolo_head_loss(torch.from_numpy(raw), torch.from_numpy(t),
                                  torch.from_numpy(mask), ANCHORS, nC, img,
                                  box_loss=box_loss)
    total_j, m_j = _j_head_loss(jnp.asarray(raw), jnp.asarray(t),
                                jnp.asarray(mask), ANCHORS, nC, img,
                                box_loss=box_loss)
    np.testing.assert_allclose(float(total_t), float(total_j), rtol=1e-5)
    for k in TERMS:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    if box_loss == "mse":
        total_o, m_o = loss_np(raw.transpose(0, 3, 1, 2).astype(np.float64),
                               t[mask].astype(np.float64), ANCHORS, nC, img)
        assert float(total_t) == pytest.approx(total_o, rel=2e-4, abs=1e-5)
        for k in TERMS:
            assert float(m_t[k]) == pytest.approx(m_o[k], rel=2e-3,
                                                  abs=1e-5), k
    if dup:  # the later target's box is the one regressed
        assert float(m_t["loss_x"]) > 0


@pytest.mark.parametrize("logit", [12.0, 24.35])
def test_saturated_objectness_matches_jax(logit):
    """One objectness logit set to ``logit`` in a cell with no target.
    Below ~16.6 the sigmoid stays under 1.0 in f32 and both losses are
    finite and agree (rtol 1e-5). Above it the sigmoid rounds to 1.0, the
    BCE's clamp to 1 - 1e-12 is 1.0 in f32 too, and both losses are not
    finite: the port keeps the reference's loss there as well."""
    raw, t, mask, nC = _loss_case(1)
    b, gx, gy = int(t[0, 0]), int(t[0, 2] * 8), int(t[0, 3] * 8)
    cell = (1 - b, gy, gx)  # the other image: no target in it
    raw[cell + (4,)] = logit
    total_t, _ = yolo_head_loss(torch.from_numpy(raw), torch.from_numpy(t),
                                torch.from_numpy(mask), ANCHORS, nC, 128)
    total_j, _ = _j_head_loss(jnp.asarray(raw), jnp.asarray(t),
                              jnp.asarray(mask), ANCHORS, nC, 128)
    finite = logit < 16.6
    assert bool(torch.isfinite(total_t)) == finite
    assert bool(jnp.isfinite(total_j)) == finite
    if finite:
        np.testing.assert_allclose(float(total_t), float(total_j), rtol=1e-5)


def test_yolo_loss_drops_what_the_reference_drops():
    """Padded rows and rows whose batch index lies outside the batch write
    nothing (the reference's out-of-bounds drop): the loss equals that of
    the valid rows alone."""
    raw, t, mask, nC = _loss_case(3)
    t2, mask2 = t.copy(), mask.copy()
    t2[5] = [7, 1, 0.5, 0.5, 0.2, 0.2]   # batch index 7 of 2
    mask2[5] = True
    t2[6] = [0, 2, 0.3, 0.3, 0.2, 0.2]   # a padded row with a box
    args = (torch.from_numpy(raw), ANCHORS, nC, 128)
    a, _ = yolo_head_loss(args[0], torch.from_numpy(t), torch.from_numpy(mask),
                          *args[1:])
    b, _ = yolo_head_loss(args[0], torch.from_numpy(t2),
                          torch.from_numpy(mask2), *args[1:])
    assert float(a) == float(b)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    cfg = tmp_path_factory.mktemp("cfg") / "tiny.cfg"
    cfg.write_text(TINY_CFG)
    defs = parse_model_config(str(cfg))
    assert defs == j_parse(str(cfg))
    jplan, tplan = j_build(defs), build_network(defs)
    raw = random_raw_params(jplan.defs())
    params, stats = JC.raw_params_to_train(raw, jplan.defs())
    t_params, t_stats = TC.raw_params_to_train(raw, tplan.defs())
    for a, b in zip(tree_leaves(params), tree_leaves(t_params)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(7)
    imgs = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    targets = np.zeros((8, 6), np.float32)
    tmask = np.zeros(8, bool)
    for i in range(4):  # one object per image
        targets[i] = [i, i % 2, 0.25 + 0.15 * i, 0.5, 0.25, 0.25]
        tmask[i] = True
    return dict(cfg=cfg, defs=defs, jplan=jplan, tplan=tplan, raw=raw,
                params=params, stats=stats, imgs=imgs, targets=targets,
                tmask=tmask)


def _close_trees(got, want, rtol, atol, tag):
    for i, (a, b) in enumerate(zip(tree_leaves(to_numpy(got)), tree_leaves(want))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=f"{tag} leaf {i}")


def test_gradients_match_jax(tiny):
    """The gradient of the total loss through ``make_forward_train`` for
    every leaf against ``jax.grad`` of the JAX loss, from the same params:
    each leaf's largest difference within 1e-4 of its largest gradient;
    the loss and the BN stats the forward returns within rtol 1e-5."""
    from yolo_deepsort_tpu.train.yolo_loss import yolo_loss as j_loss

    from yolo_deepsort_tpu_torch.train.yolo_loss import yolo_loss

    su = tiny
    j_fwd = JC.make_forward_train(su["jplan"])

    def j_fn(params):
        maps, new = j_fwd(params, su["stats"], jnp.asarray(su["imgs"]))
        return j_loss(su["jplan"], maps, su["targets"], su["tmask"])[0], new

    (j_l, j_new), j_grads = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, su["params"]))
    params = to_torch(su["params"], "cpu", trainable=True)
    maps, new = TC.make_forward_train(su["tplan"])(
        params, to_torch(su["stats"], "cpu"), torch.from_numpy(su["imgs"]))
    loss, _ = yolo_loss(su["tplan"], maps, torch.from_numpy(su["targets"]),
                        torch.from_numpy(su["tmask"]))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_l), rtol=1e-5)
    _close_trees(new, j_new, 1e-5, 1e-6, "stats")
    for i, (p, g) in enumerate(zip(tree_leaves(params), tree_leaves(j_grads))):
        g = np.asarray(g)
        scale = max(float(np.abs(g).max()), 1e-12)
        assert np.abs(p.grad.numpy() - g).max() <= 1e-4 * scale, i


def test_learning_rate_schedule_matches_optax(tiny):
    """``build_optimizer``'s learning rate at each update count is optax's
    (burn-in from count 0, held at max(count, 1), then the step decays)."""
    net_info = dict(learning_rate="0.001", burn_in="4", steps="6,8",
                    scales=".1,.5", momentum="0.9", decay="0.0005")
    tx = JC.build_optimizer(net_info)
    params = {"w": jnp.ones(3)}
    state = tx.init(params)
    opt = TC.build_optimizer(net_info, {"w": torch.ones(3,
                                                        requires_grad=True)})
    for count in range(10):
        upd, state = tx.update({"w": jnp.ones(3)}, state, params)
        # the update is -lr times the momentum trace
        trace = float(state[1][0].trace["w"][0])
        lr = -float(upd["w"][0]) / trace
        assert opt.lr_at(count) == pytest.approx(lr, rel=1e-6), count


def test_three_steps_match_jax(tiny):
    """Three ``make_detection_train_step`` steps with the cfg's optimizer
    (SGD, momentum 0.9, decay 5e-4, burn-in 2) against the JAX package's
    three optax steps: loss per step rtol 1e-5; params and BN stats after
    each step rtol 1e-4, atol 1e-6."""
    su = tiny
    net_info = su["defs"][0]
    tx = JC.build_optimizer(net_info)
    j_params = jax.tree.map(jnp.asarray, su["params"])
    j_state = tx.init(j_params)
    j_stats = jax.tree.map(jnp.asarray, su["stats"])
    j_step = jax.jit(JC.make_detection_train_step(su["jplan"], tx))
    params = to_torch(su["params"], "cpu", trainable=True)
    stats = to_torch(su["stats"], "cpu")
    opt = TC.build_optimizer(net_info, params)
    step = TC.make_detection_train_step(su["tplan"])
    batch = (su["imgs"], su["targets"], su["tmask"])
    for k in range(3):
        j_params, j_state, j_stats, j_l, _ = j_step(j_params, j_state,
                                                    j_stats, *batch)
        stats, loss, metrics = step(params, opt, stats, *batch)
        np.testing.assert_allclose(float(loss), float(j_l), rtol=1e-5)
        _close_trees(params, j_params, 1e-4, 1e-6, f"params step {k}")
        _close_trees(stats, j_stats, 1e-4, 1e-6, f"stats step {k}")
    assert opt.count == 3


def test_detection_training_learns(tiny):
    """Overfit one fixed batch, as the JAX suite's
    ``test_detection_training_learns`` (Adam 5e-3, 80 steps): the total
    loss must fall by more than 10x."""
    su = tiny
    params = to_torch(su["params"], "cpu", trainable=True)
    stats = to_torch(su["stats"], "cpu")
    opt = torch.optim.Adam(tree_leaves(params), lr=5e-3)
    step = TC.make_detection_train_step(su["tplan"])
    losses = []
    for _ in range(80):
        stats, loss, _ = step(params, opt, stats, su["imgs"], su["targets"],
                              su["tmask"])
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.1 * losses[0], (losses[0], losses[-1])


def test_resume_restores_trainable_state(tiny, tmp_path):
    """save_pytree -> load_pytree -> restore: params, stats, the momentum
    buffers and the update count; the resumed step equals the
    uninterrupted one bit for bit."""
    from yolo_deepsort_tpu_torch.utils.checkpoint import (load_pytree,
                                                          restore_like,
                                                          save_pytree)

    su = tiny
    net_info = su["defs"][0]
    batch = (su["imgs"][:2], su["targets"], su["tmask"])
    step = TC.make_detection_train_step(su["tplan"])

    def fresh():
        params = to_torch(su["params"], "cpu", trainable=True)
        return params, TC.build_optimizer(net_info, params), to_torch(
            su["stats"], "cpu")

    params, opt, stats = fresh()
    stats, _, _ = step(params, opt, stats, *batch)
    ckpt = tmp_path / "yolo.npz"
    save_pytree(ckpt, {"params": params, "stats": stats,
                       "opt_state": opt.state(), "seen": np.int64(2)})
    ck = load_pytree(ckpt)
    assert int(ck["seen"]) == 2
    p2 = to_torch(restore_like(su["params"], ck["params"]), "cpu",
                  trainable=True)
    assert all(isinstance(k, int) for k in p2)
    s2 = to_torch(restore_like(su["stats"], ck["stats"]), "cpu")
    o2 = TC.build_optimizer(net_info, p2)
    o2.load_state(ck["opt_state"])
    assert o2.count == 1
    s2, l2, _ = step(p2, o2, s2, *batch)
    stats, l1, _ = step(params, opt, stats, *batch)
    assert float(l1) == float(l2)
    for a, b in zip(tree_leaves(params) + tree_leaves(stats), tree_leaves(p2) + tree_leaves(s2)):
        assert torch.equal(a, b)


def test_yolo_cli_trains_resumes_and_exports(tiny, tmp_path):
    """The CLI on a generated image list with ``--device cpu``: 1 epoch of
    2 batches, then ``--resume`` for a second; the checkpoint's seen
    counter and update count, and the exported ``.weights`` equal the
    checkpoint's params bit for bit and load into the port's inference
    ``Darknet``, whose forward equals the one built from the checkpoint."""
    from PIL import Image

    from yolo_deepsort_tpu_torch.utils.checkpoint import load_pytree
    from yolo_deepsort_tpu_torch.weights import (darknet_from_raw,
                                                 load_darknet_weights)

    img_dir, lbl_dir = tmp_path / "images", tmp_path / "labels"
    img_dir.mkdir()
    lbl_dir.mkdir()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(8):
        p = img_dir / f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (48, 64, 3), np.uint8)).save(p)
        (lbl_dir / f"im{i}.txt").write_text(
            "0 0.5 0.5 0.3 0.3\n1 0.2 0.3 0.1 0.2")
        paths.append(str(p))
    lst = tmp_path / "train.txt"
    lst.write_text("\n".join(paths))
    ckpt, out = tmp_path / "yolo.npz", tmp_path / "out.weights"
    args = ["--cfg", str(tiny["cfg"]), "--data", str(lst), "--batch-size",
            "4", "--max-targets", "16", "--ckpt", str(ckpt),
            "--log-interval", "1", "--device", "cpu", "--mosaic"]
    TC.main(args + ["--epochs", "1"])
    assert int(load_pytree(ckpt)["opt_state"]["count"]) == 2
    TC.main(args + ["--epochs", "1", "--resume", "--export-weights",
                    str(out), "--box-loss", "ciou"])
    ck = load_pytree(ckpt)
    assert int(ck["seen"]) == 16 and int(ck["opt_state"]["count"]) == 4
    defs = tiny["tplan"].defs()
    header, raw = load_darknet_weights(str(out), defs)
    assert header[3] == 16
    want_raw = TC.train_params_to_raw(ck["params"], ck["stats"], defs)
    for idx, layer in want_raw.items():
        for name, v in layer.items():
            np.testing.assert_array_equal(raw[idx][name], v)
    x = torch.from_numpy(tiny["imgs"][:2].clip(0, 1))
    with torch.no_grad():
        got = darknet_from_raw(tiny["tplan"], raw)(x)
        want = darknet_from_raw(tiny["tplan"], want_raw)(x)
    assert got.shape == (2, 3 * 8 * 8, 7) and torch.isfinite(got).all()
    assert torch.equal(got, want)
