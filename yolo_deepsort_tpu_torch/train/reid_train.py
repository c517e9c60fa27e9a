"""ReID classifier training in torch (port of
yolo_deepsort_tpu/train/reid_train.py).

The reference's deep_sort/deep/train.py: the Net with its classifier head
on Market-1501 crops (3 x 128 x 64), SGD lr 0.1, momentum 0.9, weight decay
5e-4, cross-entropy, top-1 accuracy. Params and statistics are trees in
the JAX package's layout (HWIO convs, explicit BN gamma/beta beside them,
running statistics apart), so ``trees.to_torch`` / ``to_numpy`` carry them
across and ``models/reid.fold_train_params`` folds them into inference
params. BN is written out: batch statistics with the biased variance in
train mode, running ones updated (1 - BN_UPDATE) * running + BN_UPDATE *
batch, detached. Convs and matmuls run in float32 without TF32
(``trees.full_f32``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.collectives import (
    all_reduce_sum,
    check_equal_shards,
    copy_to_mp,
    reduce_from_mp,
    sum_grads,
)
from ..utils.checkpoint import tree_leaves
from .sync_bn import batch_stats
from .trees import full_f32

BN_EPS = 1e-5
# torch BatchNorm's momentum 0.1: running' = (1 - 0.1) * running + 0.1 * batch
BN_UPDATE = 0.1

STAGES = [(64, 64, False), (64, 128, True), (128, 256, True), (256, 512, True)]


def _conv_init(rng, ci, co, k):
    std = np.sqrt(2.0 / (ci * k * k))
    return (rng.normal(0, std, (k, k, ci, co))).astype(np.float32)


def init_train_params(num_classes: int = 751, seed: int = 0):
    """(params, stats) numpy trees: raw conv/BN/fc params and running BN
    statistics -- the reference's, same generator and draw order."""
    rng = np.random.default_rng(seed)

    def bn(c):
        return {"gamma": np.ones(c, np.float32),
                "beta": np.zeros(c, np.float32)}

    def bn_stats(c):
        return {"mean": np.zeros(c, np.float32),
                "var": np.ones(c, np.float32)}

    params: Dict = {
        "stem": {"w": _conv_init(rng, 3, 64, 3), "b": np.zeros(64, np.float32),
                 "bn": bn(64)},
        "layers": [],
        "classifier": {
            "fc1_w": rng.normal(0, 0.05, (512, 256)).astype(np.float32),
            "fc1_b": np.zeros(256, np.float32),
            "bn": bn(256),
            "fc2_w": rng.normal(0, 0.05, (256, num_classes)).astype(
                np.float32),
            "fc2_b": np.zeros(num_classes, np.float32),
        },
    }
    stats: Dict = {"stem": bn_stats(64), "layers": [],
                   "classifier": bn_stats(256)}
    for ci, co, down in STAGES:
        blocks, sblocks = [], []
        for bi in range(2):
            first = bi == 0
            cin = ci if first else co
            block = {
                "conv1": {"w": _conv_init(rng, cin, co, 3), "bn": bn(co)},
                "conv2": {"w": _conv_init(rng, co, co, 3), "bn": bn(co)},
                "down": ({"w": _conv_init(rng, cin, co, 1), "bn": bn(co)}
                         if (first and (down or cin != co)) else None),
            }
            blocks.append(block)
            sblocks.append({
                "conv1": bn_stats(co), "conv2": bn_stats(co),
                "down": bn_stats(co) if block["down"] is not None else None})
        params["layers"].append(blocks)
        stats["layers"].append(sblocks)
    return params, stats


def _conv(x, w, stride, pad):
    """NCHW x, HWIO w."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, padding=pad)


def _bn(x, bn_params, stats, train: bool, dims=(0, 2, 3), mesh=None):
    """BatchNorm over ``dims`` (channels at dim 1), its batch statistics
    over the mesh's dp ranks when given (``sync_bn.batch_stats``). Returns
    (out, new_stats)."""
    shape = [1] * x.dim()
    shape[1] = -1
    if train:
        mean, var = batch_stats(x, dims, mesh)
        new_stats = {
            "mean": (1 - BN_UPDATE) * stats["mean"]
            + BN_UPDATE * mean.detach(),
            "var": (1 - BN_UPDATE) * stats["var"] + BN_UPDATE * var.detach()}
    else:
        mean, var = stats["mean"], stats["var"]
        new_stats = stats
    inv = torch.rsqrt(var + BN_EPS)
    out = ((x - mean.reshape(shape)) * inv.reshape(shape)
           * bn_params["gamma"].reshape(shape)
           + bn_params["beta"].reshape(shape))
    return out, new_stats


def reid_train_apply(params, stats, x, train: bool = True,
                     features_only: bool = False, mesh=None):
    """Forward with explicit BN. x (N, 128, 64, 3) NHWC. Returns (logits,
    new_stats); with ``features_only`` (L2-normed 512-d features,
    new_stats) -- the reid=True head of the reference Net.

    With a training ``mesh`` (``parallel/mesh.py``) ``x`` is this rank's dp
    shard and every BN takes its batch statistics over the dp ranks. The
    classifier head is this rank's mp slice (``trees.shard_train_tree``):
    fc1 columns, fc1_b, the BN and its running stats, fc2 rows; ``feat``
    enters it through ``copy_to_mp`` and the partial logits leave through
    ``reduce_from_mp`` before the replicated fc2_b is added once."""
    new_stats: Dict = {"layers": []}
    x = x.to(params["stem"]["w"].dtype).permute(0, 3, 1, 2)
    out = _conv(x, params["stem"]["w"], 1, 1) \
        + params["stem"]["b"][:, None, None]
    out, new_stats["stem"] = _bn(out, params["stem"]["bn"], stats["stem"],
                                 train, mesh=mesh)
    out = F.max_pool2d(torch.relu(out), 3, 2, 1)
    for blocks, sblocks in zip(params["layers"], stats["layers"]):
        nblocks = []
        for block, sblock in zip(blocks, sblocks):
            w1 = block["conv1"]["w"]
            stride = 2 if (block["down"] is not None
                           and w1.shape[2] != w1.shape[3]) else 1
            y = _conv(out, w1, stride, 1)
            y, s1 = _bn(y, block["conv1"]["bn"], sblock["conv1"], train,
                        mesh=mesh)
            y = _conv(torch.relu(y), block["conv2"]["w"], 1, 1)
            y, s2 = _bn(y, block["conv2"]["bn"], sblock["conv2"], train,
                        mesh=mesh)
            if block["down"] is not None:
                s = _conv(out, block["down"]["w"], stride, 0)
                s, sd = _bn(s, block["down"]["bn"], sblock["down"], train,
                            mesh=mesh)
            else:
                s, sd = out, None
            out = torch.relu(y + s)
            nblocks.append({"conv1": s1, "conv2": s2, "down": sd})
        new_stats["layers"].append(nblocks)

    feat = out.mean((2, 3))  # (N, 512)
    if features_only:
        new_stats["classifier"] = stats["classifier"]
        norm = feat.norm(dim=1, keepdim=True).clamp(min=1e-12)
        return feat / norm, new_stats
    c = params["classifier"]
    mp_group = None if mesh is None else mesh.mp_group
    h = copy_to_mp(feat, mp_group) @ c["fc1_w"] + c["fc1_b"]
    h, new_stats["classifier"] = _bn(h, c["bn"], stats["classifier"], train,
                                     dims=(0,), mesh=mesh)
    logits = reduce_from_mp(torch.relu(h) @ c["fc2_w"], mp_group) \
        + c["fc2_b"]
    return logits, new_stats


def make_train_step(lr: float = 0.1, momentum: float = 0.9,
                    weight_decay: float = 5e-4, mesh=None):
    """SGD(momentum, weight_decay) + cross-entropy, as deep/train.py.
    Returns (init, train_step): ``init(params)`` -> the optimizer over the
    params' tensors (optax's ``chain(add_decayed_weights(wd), sgd(lr,
    momentum))`` is ``torch.optim.SGD(momentum, weight_decay=wd,
    dampening=0)``); ``train_step(params, opt, stats, images, labels)`` ->
    (new_stats, loss, acc), the params updated in place.

    With a training ``mesh`` (``parallel/mesh.py`` ``make_train_mesh``)
    the step runs on ``mesh.device`` over this rank's dp shard of images
    and labels (rows ``dp_rank * B_loc ...``, every rank the same B_loc)
    and this rank's params and stats (``trees.shard_train_tree``): BN
    statistics over the dp ranks, the head sharded over mp, the
    cross-entropy this rank's sum over the global batch, every gradient
    summed over the dp group before the update (so the replicated params
    stay equal on every rank). The returned loss and accuracy are the
    global batch's, on every rank."""
    if mesh is not None and 256 % mesh.mp:
        raise ValueError(f"mp={mesh.mp} does not divide the classifier's "
                         "256 features")

    def init(params):
        return torch.optim.SGD(tree_leaves(params), lr=lr, momentum=momentum,
                               dampening=0.0, weight_decay=weight_decay)

    def sharded_step(params, opt, stats, images, labels):
        dev = mesh.device
        images = torch.as_tensor(images).to(dev, torch.float32)
        labels = torch.as_tensor(labels).to(dev, torch.int64)
        check_equal_shards(mesh.dp_group, images.shape[0], dev)
        n = images.shape[0] * mesh.dp
        with full_f32():
            opt.zero_grad(set_to_none=True)
            logits, new_stats = reid_train_apply(params, stats, images,
                                                 train=True, mesh=mesh)
            logp = torch.log_softmax(logits, dim=1)
            loss = -logp.gather(1, labels[:, None]).sum() / n
            loss.backward()
            sum_grads(tree_leaves(params), mesh.dp_group)
            opt.step()
        correct = (logits.detach().argmax(1) == labels).float().sum() / n
        loss, acc = all_reduce_sum(torch.stack([loss.detach(), correct]),
                                   mesh.dp_group)
        return new_stats, loss, acc

    def train_step(params, opt, stats, images, labels):
        dev = tree_leaves(params)[0].device
        images = torch.as_tensor(images).to(dev, torch.float32)
        labels = torch.as_tensor(labels).to(dev, torch.int64)
        with full_f32():
            opt.zero_grad(set_to_none=True)
            logits, new_stats = reid_train_apply(params, stats, images,
                                                 train=True)
            logp = torch.log_softmax(logits, dim=1)
            loss = -logp.gather(1, labels[:, None]).mean()
            loss.backward()
            opt.step()
        acc = (logits.detach().argmax(1) == labels).float().mean()
        return new_stats, loss.detach(), acc

    return init, (train_step if mesh is None else sharded_step)
