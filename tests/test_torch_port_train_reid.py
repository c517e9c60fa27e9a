"""The port's ReID classifier training (``train/reid_train.py``,
``train/reid_cli.py``) and the classifier head of ``models/reid.py``
against the JAX package's on the CPU, from the same seeded params
(``init_train_params`` draws the reference's arrays; ``trees.to_torch``
makes them the port's tensors):

* the train-layout forward (train and eval BN, logits, features, stats);
* three ``make_train_step`` steps (SGD momentum 0.9, decay 5e-4,
  cross-entropy): loss, accuracy, logits-side BN stats and params after
  each step;
* the folded inference net's classifier head against ``reid_apply(
  classify=True)``, and against the train-layout forward in eval mode;
* the CLI on a generated image folder with ``--device cpu``: train,
  checkpoint, resume, test (features) and evaluate.

Crops are 128 x 64 (the net's input); batches of 4, 5 identities.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from yolo_deepsort_tpu.models import reid as JR
from yolo_deepsort_tpu.train import reid_train as JT
from yolo_deepsort_tpu_torch.models import reid as TR
from yolo_deepsort_tpu_torch.train import reid_cli as TCLI
from yolo_deepsort_tpu_torch.train import reid_train as TT
from yolo_deepsort_tpu_torch.train.trees import to_numpy, to_torch
from yolo_deepsort_tpu_torch.utils.checkpoint import tree_leaves
from yolo_deepsort_tpu_torch.weights import reid_from_params
from torch_port_threads import torch_threads  # noqa: F401


N_CLASSES, BATCH = 5, 4


def _crops(seed, n=BATCH):
    return np.random.default_rng(seed).normal(0, 1, (n, 128, 64, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def trees():
    params, stats = JT.init_train_params(num_classes=N_CLASSES, seed=3)
    t_params, t_stats = TT.init_train_params(num_classes=N_CLASSES, seed=3)
    for a, b in zip(tree_leaves(params) + tree_leaves(stats),
                    tree_leaves(t_params) + tree_leaves(t_stats)):
        np.testing.assert_array_equal(a, b)
    return params, stats


def _close(got, want, rtol, atol, tag):
    got, want = tree_leaves(to_numpy(got)), tree_leaves(want)
    assert len(got) == len(want), tag
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=f"{tag} leaf {i}")


@pytest.mark.parametrize("mode", ["train", "eval", "features"])
def test_reid_train_apply_matches_jax(trees, mode):
    """Logits (or features) within 1e-4 of their largest magnitude and the
    new BN stats within rtol 1e-4, atol 1e-5."""
    params, stats = trees
    x = _crops(1)
    kw = dict(train=mode == "train", features_only=mode == "features")
    want, want_stats = JT.reid_train_apply(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        jnp.asarray(x), **kw)
    with torch.no_grad():
        got, got_stats = TT.reid_train_apply(to_torch(params, "cpu"),
                                             to_torch(stats, "cpu"),
                                             torch.from_numpy(x), **kw)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    _close(got_stats, want_stats, 1e-4, 1e-5, "stats")


def test_three_train_steps_match_jax(trees):
    """Three SGD steps (lr 0.1, momentum 0.9, decay 5e-4) on one seeded
    batch of 4, each port step started from the JAX step's own params,
    momentum trace and stats: per step the loss rtol 1e-5, the accuracy
    equal, the new BN stats rtol 1e-4 (atol 1e-6), and the step's update
    of all params together within 1e-2 of its norm (the L2 norm of the
    difference over the L2 norm of JAX's update; measured 1.1e-3, 4.6e-4
    and 5.9e-6). A ReLU whose input lies within f32 rounding of zero
    passes its gradient in one framework and not in the other, and the
    batch-statistics BN spreads that over the channel, so single leaves
    can differ by a few percent of their own change (the port's f32
    gradient against its own f64 gradient differs by up to 1.7e-2 of the
    largest at the first block, the JAX package's by up to 1.3e-3); the
    whole update cannot."""
    params, stats = trees
    x, labels = _crops(2), np.array([0, 1, 2, 3], np.int32)
    j_init, j_step = JT.make_train_step()
    j_params = jax.tree.map(jnp.asarray, params)
    j_stats = jax.tree.map(jnp.asarray, stats)
    j_opt = j_init(j_params)
    j_step = jax.jit(j_step)
    t_init, t_step = TT.make_train_step()
    for k in range(3):
        t_params = to_torch(to_numpy_tree(j_params), "cpu", trainable=True)
        t_opt = t_init(t_params)
        if k:
            for p, buf in zip(tree_leaves(t_params), tree_leaves(j_opt[1][0].trace)):
                t_opt.state[p]["momentum_buffer"] = torch.from_numpy(
                    np.array(buf))
        t_stats = to_torch(to_numpy_tree(j_stats), "cpu")
        before = tree_leaves(to_numpy_tree(j_params))
        j_params, j_opt, j_stats, j_loss, j_acc = j_step(
            j_params, j_opt, j_stats, jnp.asarray(x), jnp.asarray(labels))
        t_stats, t_loss, t_acc = t_step(t_params, t_opt, t_stats, x, labels)
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
        assert float(t_acc) == float(j_acc)
        _close(t_stats, j_stats, 1e-4, 1e-6, f"stats step {k}")
        got = np.concatenate([a.ravel() for a in tree_leaves(to_numpy(t_params))])
        want = np.concatenate([np.asarray(a).ravel()
                               for a in tree_leaves(j_params)])
        moved = want - np.concatenate([a.ravel() for a in before])
        ratio = np.linalg.norm(got - want) / np.linalg.norm(moved)
        assert ratio <= 1e-2, (k, ratio)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_classifier_head_matches_the_reference():
    """The folded net's classifier head (``random_reid_params(
    num_classes=)``, ``ReIDNet.forward(classify=True)``) against
    ``reid_apply(classify=True)``, f32: logits within 1e-4 of their
    largest magnitude; the twin params equal the reference's; the 128-d
    layout refuses classify mode, as the reference's does."""
    params = TR.random_reid_params(4, num_classes=N_CLASSES)
    j_params = JR.random_reid_params(4, num_classes=N_CLASSES)
    for a, b in zip(tree_leaves(params), tree_leaves(j_params)):
        np.testing.assert_array_equal(a, b)
    params["classifier"]["bn_m"] = np.linspace(-0.1, 0.1, 256).astype(
        np.float32)
    params["classifier"]["bn_v"] = np.linspace(0.5, 2.0, 256).astype(
        np.float32)
    x = _crops(5)
    want = np.asarray(JR.reid_apply(params, jnp.asarray(x), classify=True))
    net = reid_from_params(params)
    with torch.no_grad():
        got = net(torch.from_numpy(x), classify=True).numpy()
        feats = net(torch.from_numpy(x)).numpy()
    assert got.shape == (BATCH, N_CLASSES) and feats.shape == (BATCH, 512)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    with pytest.raises(ValueError, match="classify"):
        reid_from_params(TR.random_original_reid_params(0))(
            torch.from_numpy(x), classify=True)
    with pytest.raises(ValueError, match="classify"):
        reid_from_params(TR.random_reid_params(4))(torch.from_numpy(x),
                                                   classify=True)


def test_folded_train_params_give_the_eval_forward(trees):
    """``fold_train_params`` of the training layout, loaded into the
    inference ``ReIDNet``: its features and classifier logits equal the
    train-layout forward in eval mode (within 1e-4 relative)."""
    params, stats = trees
    rng = np.random.default_rng(6)
    with torch.no_grad():  # running stats moved off their init
        stats = to_numpy(TT.reid_train_apply(
            to_torch(params, "cpu"), to_torch(stats, "cpu"),
            torch.from_numpy(_crops(7)))[1])
    net = reid_from_params(TR.fold_train_params(params, stats))
    x = torch.from_numpy(_crops(8, 2) + rng.normal(0, 0.1, (2, 128, 64, 3))
                         .astype(np.float32))
    with torch.no_grad():
        logits, _ = TT.reid_train_apply(to_torch(params, "cpu"),
                                        to_torch(stats, "cpu"), x,
                                        train=False)
        feats, _ = TT.reid_train_apply(to_torch(params, "cpu"),
                                       to_torch(stats, "cpu"), x,
                                       train=False, features_only=True)
        got_logits = net(x, classify=True)
        got_feats = net(x)
    for got, want in ((got_logits, logits), (got_feats, feats)):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_reid_cli_trains_resumes_tests_and_evaluates(tmp_path):
    """The CLI on a generated image folder (2 identities x 2 images in
    train, test, query and gallery) with ``--device cpu``: train 1 epoch,
    resume for a second (the checkpoint's epoch moves on), dump features
    (unit norm) and evaluate; the checkpoint folds into an inference net
    through ``load_reid_checkpoint``."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for split in ("train", "test", "query", "gallery"):
        for c in range(2):
            d = tmp_path / "data" / split / f"id{c}"
            d.mkdir(parents=True)
            for i in range(2):
                img = np.clip(rng.normal(60 * c + 40, 30, (128, 64, 3)), 0,
                              255).astype(np.uint8)
                Image.fromarray(img).save(d / f"{i}.png")
    ckpt, feats = tmp_path / "ckpt.npz", tmp_path / "feats.npz"
    common = ["--data-dir", str(tmp_path / "data"), "--ckpt", str(ckpt),
              "--batch-size", "2", "--log-interval", "1", "--device", "cpu",
              "--features", str(feats)]
    TCLI.main(["train", "--epochs", "1"] + common)
    from yolo_deepsort_tpu_torch.utils.checkpoint import load_pytree

    assert int(load_pytree(ckpt)["epoch"]) == 0
    TCLI.main(["train", "--epochs", "2", "--resume"] + common)
    ck = load_pytree(ckpt)
    assert int(ck["epoch"]) in (0, 1) and 0.0 <= float(ck["acc"]) <= 1.0
    TCLI.main(["test"] + common)
    z = np.load(feats)
    assert z["query"].shape == (4, 512) and z["gallery"].shape == (4, 512)
    np.testing.assert_allclose(np.linalg.norm(z["query"], axis=1), 1.0,
                               atol=1e-5)
    TCLI.main(["evaluate"] + common)
    net = reid_from_params(TR.load_reid_checkpoint(str(ckpt)))
    with torch.no_grad():
        assert net(torch.from_numpy(_crops(9, 2)), classify=True).shape == (
            2, 2)
