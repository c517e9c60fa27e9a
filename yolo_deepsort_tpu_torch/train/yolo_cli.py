"""YOLO detection training CLI (port of yolo_deepsort_tpu/train/yolo_cli.py).

The reference lineage trains darknet detectors with hyperparameters taken
from the cfg's [net] section (learning_rate, burn_in, steps/scales,
momentum, decay) over ListDataset batches (normalized ``cls cx cy w h``
labels, multiscale, flip augment) with the YOLOLayer loss. This CLI runs
that loop with torch autograd, on the CUDA card unless ``--device cpu``:

  python -m yolo_deepsort_tpu_torch.train.yolo_cli \\
      --cfg config/yolov3-tiny.cfg --data train.txt [--pretrained w.weights]
      [--epochs 10] [--batch-size 8] [--ckpt checkpoint/yolo.npz]

Training runs on raw (unfolded) params in the JAX package's layout (HWIO
conv weights; BN gamma/beta trained, running stats beside them), so its
params and stats carry across with ``trees.to_torch`` / ``to_numpy``.
``--export-weights out.weights`` writes a stock darknet file back
(``save_darknet_weights``), seen-counter included, which the port's
inference ``Darknet`` loads. Convs and matmuls run in float32 without
TF32 (``trees.full_f32``), forward and backward.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.darknet import _activate, _resolve, conv_layer_shapes
from ..parallel.collectives import (
    all_reduce_sum,
    check_equal_shards,
    sum_grads,
)
from ..utils.checkpoint import tree_leaves
from .sync_bn import batch_stats
from .trees import full_f32, to_numpy, to_torch

BN_EPS = 1e-5


class DetectionOptimizer:
    """optax's ``chain(add_decayed_weights(decay), sgd(schedule,
    momentum))`` as ``torch.optim.SGD(momentum, weight_decay=decay,
    dampening=0)``: the decay on every leaf (BN's gamma and beta
    included), then the momentum trace of the decayed gradient, scaled by
    the learning rate of the update's count. ``count`` is optax's: the
    number of updates made so far, 0 for the first."""

    def __init__(self, params, lr: float, momentum: float, decay: float,
                 burn_in: int = 0, steps=(), scales=()):
        self.leaves = tree_leaves(params)
        self.sgd = torch.optim.SGD(self.leaves, lr=lr, momentum=momentum,
                                   dampening=0.0, weight_decay=decay)
        self.lr, self.burn_in = lr, burn_in
        self.steps, self.scales = list(steps), list(scales)
        self.count = 0

    def lr_at(self, count: int) -> float:
        """darknet burn-in, lr * (max(count, 1) / burn_in)^4 while count <
        burn_in, then the step decays (optax's schedule, evaluated in
        float32 as it is)."""
        f = np.float32(1.0)
        if self.burn_in > 0 and count < self.burn_in:
            r = np.float32(max(count, 1)) / np.float32(self.burn_in)
            f = (r * r) * (r * r)  # jax's integer_pow of 4
        for s, sc in zip(self.steps, self.scales):
            if count >= s:
                f = f * np.float32(sc)
        return float(np.float32(self.lr) * f)

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> None:
        for group in self.sgd.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.sgd.step()
        self.count += 1

    def state(self) -> Dict:
        """{"count", "momentum": one buffer per leaf, None before the first
        update}: what a checkpoint keeps."""
        return {"count": np.int64(self.count),
                "momentum": [self.sgd.state.get(p, {}).get("momentum_buffer")
                             for p in self.leaves]}

    def load_state(self, state: Dict) -> None:
        self.count = int(state["count"])
        for p, buf in zip(self.leaves, state["momentum"]):
            if buf is not None:
                self.sgd.state[p]["momentum_buffer"] = torch.as_tensor(
                    np.asarray(buf, np.float32)).to(p.device).clone()


def build_optimizer(net_info: Dict, params, lr_override: Optional[float] = None
                    ) -> DetectionOptimizer:
    """The [net] section's SGD: learning_rate, momentum, decay, burn_in,
    steps and scales."""
    lr = lr_override or float(net_info.get("learning_rate", 1e-3))
    steps = [int(s) for s in str(net_info.get("steps", "")).split(",") if s]
    scales = [float(s) for s in str(net_info.get("scales", "")).split(",")
              if s]
    return DetectionOptimizer(params, lr,
                              float(net_info.get("momentum", 0.9)),
                              float(net_info.get("decay", 5e-4)),
                              int(net_info.get("burn_in", 0)), steps, scales)


def raw_params_to_train(raw, module_defs):
    """Raw darknet params (OIHW + separate BN) -> (params, stats) numpy
    trees, the JAX package's layout: HWIO conv weights with gamma and beta
    (or a conv bias), the BN running statistics apart (not trained).
    ``trees.to_torch`` makes them tensors."""
    params, stats = {}, {}
    for idx, oc, ic, k, has_bn in conv_layer_shapes(module_defs):
        layer = raw[idx]
        w = np.ascontiguousarray(
            np.asarray(layer["conv_weight"], np.float32).transpose(2, 3, 1, 0))
        if has_bn:
            params[idx] = {"w": w,
                           "gamma": np.asarray(layer["bn_weight"], np.float32),
                           "beta": np.asarray(layer["bn_bias"], np.float32)}
            stats[idx] = {"mean": np.asarray(layer["bn_mean"], np.float32),
                          "var": np.asarray(layer["bn_var"], np.float32)}
        else:
            params[idx] = {"w": w,
                           "b": np.asarray(layer["conv_bias"], np.float32)}
    return params, stats


def train_params_to_raw(params, stats, module_defs):
    """The inverse of ``raw_params_to_train`` (tensors or numpy): raw
    darknet params for ``save_darknet_weights``."""
    params, stats = to_numpy(params), to_numpy(stats)
    raw = {}
    for idx, oc, ic, k, has_bn in conv_layer_shapes(module_defs):
        p = params[idx]
        w = np.ascontiguousarray(np.asarray(p["w"]).transpose(3, 2, 0, 1))
        if has_bn:
            raw[idx] = {"conv_weight": w, "bn_weight": np.asarray(p["gamma"]),
                        "bn_bias": np.asarray(p["beta"]),
                        "bn_mean": np.asarray(stats[idx]["mean"]),
                        "bn_var": np.asarray(stats[idx]["var"])}
        else:
            raw[idx] = {"conv_weight": w, "conv_bias": np.asarray(p["b"])}
    return raw


def make_forward_train(plan, bn_update: float = 0.01, mesh=None):
    """Train-mode forward over raw/unfolded params: forward_train(params,
    stats, x (N, S, S, 3) NHWC) -> (raw yolo maps NHWC, updated BN stats).
    BN takes the batch statistics with the biased variance (eps 1e-5) and
    updates the running ones with the same biased variance:
    (1 - bn_update) * running + bn_update * batch, detached --
    ``nn.BatchNorm2d``'s running update takes the unbiased variance, so it
    is not used. ``bn_update=1.0`` makes the returned stats the exact batch
    statistics (BN-consistent random weights are made that way). With a
    training ``mesh`` the batch statistics are the dp ranks' together
    (``sync_bn.batch_stats``)."""
    defs = plan.defs()

    def forward_train(params, stats, x):
        cache: Dict[int, torch.Tensor] = {}
        prev = x.float().permute(0, 3, 1, 2)  # NCHW view of NHWC
        new_stats: Dict[int, Dict[str, torch.Tensor]] = {}
        raw_maps: List[torch.Tensor] = []
        for i, mdef in enumerate(defs):
            t = mdef["type"]
            if t == "convolutional":
                p = params[i]
                k = int(mdef["size"])
                stride = int(mdef.get("stride", 1))
                pad = (k - 1) // 2 if int(mdef.get("pad", 0)) else 0
                out = F.conv2d(prev, p["w"].permute(3, 2, 0, 1),
                               stride=stride, padding=pad)
                if "gamma" in p:
                    mean, var = batch_stats(out, (0, 2, 3), mesh)
                    new_stats[i] = {
                        "mean": (1 - bn_update) * stats[i]["mean"]
                        + bn_update * mean.detach(),
                        "var": (1 - bn_update) * stats[i]["var"]
                        + bn_update * var.detach()}
                    inv = torch.rsqrt(var + BN_EPS)
                    out = ((out - mean[:, None, None]) * inv[:, None, None]
                           * p["gamma"][:, None, None]
                           + p["beta"][:, None, None])
                else:
                    out = out + p["b"][:, None, None]
                out = _activate(out, mdef.get("activation", "linear"))
            elif t == "maxpool":
                k, stride = int(mdef["size"]), int(mdef["stride"])
                if k == 2 and stride == 1:
                    out = F.max_pool2d(F.pad(prev, (0, 1, 0, 1)), 2, 1)
                else:
                    out = F.max_pool2d(prev, k, stride, (k - 1) // 2)
            elif t == "upsample":
                out = F.interpolate(prev, scale_factor=int(mdef["stride"]),
                                    mode="nearest")
            elif t == "route":
                layers = [_resolve(int(l), i)
                          for l in str(mdef["layers"]).split(",")]
                parts = [cache[l] for l in layers]
                out = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
                groups = int(mdef.get("groups", 1))
                if groups > 1:
                    gid = int(mdef.get("group_id", 0))
                    gc = out.shape[1] // groups
                    out = out[:, gid * gc:(gid + 1) * gc]
            elif t == "shortcut":
                out = cache[i - 1] + cache[_resolve(int(mdef["from"]), i)]
            elif t == "yolo":
                raw_maps.append(prev.permute(0, 2, 3, 1))  # NHWC
                out = prev
            else:
                raise ValueError(f"unknown module type {t!r}")
            if i in plan.keep:
                cache[i] = out
            prev = out
        return raw_maps, new_stats

    return forward_train


def make_detection_train_step(plan, bn_update: float = 0.01,
                              box_loss: str = "mse", mesh=None):
    """train_step(params, opt, stats, images, targets, tmask) -> (stats,
    loss, metrics): one update of the trainable tensors of ``params`` in
    place (``opt``: ``build_optimizer``'s, or any torch optimizer over the
    same tensors), the BN stats updated over the unchanged ones. Inputs are
    tensors (or numpy arrays) on any device; the step runs on the params'
    device, in float32 without TF32.

    With a training ``mesh`` (``parallel/mesh.py``, dp only) the step runs
    on ``mesh.device``. ``images`` is this rank's dp shard (rows
    ``dp_rank * B_loc ...``, every rank the same B_loc); ``targets`` and
    ``tmask`` are the WHOLE batch's, on every rank: the rank keeps the rows
    of its images, shifted to its own indices, in their order (so the later
    of two targets in one cell still wins). BN statistics and every masked
    mean's count are the dp ranks' together, every gradient is summed over
    the dp group before the update, and the loss and metrics returned are
    the global batch's, on every rank."""
    from .yolo_loss import yolo_loss

    if mesh is not None and mesh.mp != 1:
        raise ValueError(f"the detector shards over dp only, not mp={mesh.mp}")
    forward_train = make_forward_train(plan, bn_update=bn_update, mesh=mesh)

    def sharded_step(params, opt, stats, images, targets, tmask):
        dev = mesh.device
        images = torch.as_tensor(images).to(dev, torch.float32)
        targets = torch.as_tensor(targets).to(dev, torch.float32)
        tmask = torch.as_tensor(tmask).to(dev, torch.bool)
        n = images.shape[0]
        check_equal_shards(mesh.dp_group, n, dev)
        first = mesh.dp_rank * n
        mine = tmask & (targets[:, 0] >= first) & (targets[:, 0] < first + n)
        targets = torch.cat([targets[:, :1] - first, targets[:, 1:]], 1)
        with full_f32():
            opt.zero_grad()
            raw_maps, new_stats = forward_train(params, stats, images)
            loss, metrics = yolo_loss(plan, raw_maps, targets, mine,
                                      box_loss=box_loss, mesh=mesh)
            loss.backward()
            sum_grads(tree_leaves(params), mesh.dp_group)
            opt.step()
        names = list(metrics)
        total = all_reduce_sum(torch.stack(
            [loss.detach()] + [metrics[k].detach() for k in names]),
            mesh.dp_group)
        return ({**stats, **new_stats}, total[0],
                dict(zip(names, total[1:])))

    def train_step(params, opt, stats, images, targets, tmask):
        dev = tree_leaves(params)[0].device
        images = torch.as_tensor(images).to(dev, torch.float32)
        targets = torch.as_tensor(targets).to(dev, torch.float32)
        tmask = torch.as_tensor(tmask).to(dev, torch.bool)
        with full_f32():
            opt.zero_grad()
            raw_maps, new_stats = forward_train(params, stats, images)
            loss, metrics = yolo_loss(plan, raw_maps, targets, tmask,
                                      box_loss=box_loss)
            loss.backward()
            opt.step()
        stats = {**stats, **new_stats}
        return (stats, loss.detach(),
                {k: v.detach() for k, v in metrics.items()})

    return train_step if mesh is None else sharded_step


def main(argv=None) -> None:
    from ..cfg import parse_model_config
    from ..data.datasets import ListDataset
    from ..device import resolve_device
    from ..models.darknet import build_network
    from ..utils.checkpoint import load_pytree, restore_like, save_pytree
    from ..weights import (load_darknet_weights, random_raw_params,
                           save_darknet_weights)

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", required=True)
    p.add_argument("--data", required=True,
                   help="list file of training images")
    p.add_argument("--pretrained", default=None,
                   help=".weights init (e.g. darknet53.conv.74)")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--max-targets", type=int, default=64)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--ckpt", default="checkpoint/yolo.npz")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--export-weights", default=None)
    p.add_argument("--multiscale", action="store_true")
    p.add_argument("--mosaic", action="store_true",
                   help="YOLOv4-style 4-image mosaic augmentation")
    p.add_argument("--box-loss", default="mse", choices=["mse", "ciou"],
                   help="box regression: per-coordinate MSE (reference "
                        "lineage) or the yolov4-paper CIoU")
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the CUDA card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    module_defs = parse_model_config(args.cfg)
    net_info = module_defs[0] if module_defs[0]["type"] == "net" else {}
    plan = build_network(module_defs, img_size=args.img_size)

    raw = random_raw_params(plan.defs())
    if args.pretrained:
        _, loaded = load_darknet_weights(args.pretrained, plan.defs())
        raw.update(loaded)
    params, stats = raw_params_to_train(raw, plan.defs())
    seen = 0
    ck = None
    if args.resume and os.path.exists(args.ckpt):
        ck = load_pytree(args.ckpt)
        params = restore_like(params, ck["params"])
        stats = restore_like(stats, ck["stats"])
        seen = int(ck["seen"])
        print(f"resumed at seen={seen}")
    params = to_torch(params, device, trainable=True)
    stats = to_torch(stats, device)
    opt = build_optimizer(net_info, params, args.lr)
    if ck is not None:
        opt.load_state(ck["opt_state"])

    step = make_detection_train_step(plan, box_loss=args.box_loss)
    ds = ListDataset(args.data, img_size=plan.img_size,
                     multiscale=args.multiscale, max_targets=args.max_targets,
                     mosaic=args.mosaic)
    os.makedirs(os.path.dirname(args.ckpt) or ".", exist_ok=True)

    for epoch in range(args.epochs):
        t0 = time.time()
        for bi, (imgs, targets, tmask, size) in enumerate(
                ds.batches(args.batch_size)):
            stats, loss, metrics = step(params, opt, stats,
                                        torch.from_numpy(imgs),
                                        torch.from_numpy(targets),
                                        torch.from_numpy(tmask))
            seen += args.batch_size
            if (bi + 1) % args.log_interval == 0:
                m = {k: round(float(v), 3) for k, v in metrics.items()}
                print(f"epoch {epoch} [{bi + 1}] loss {float(loss):.3f} {m} "
                      f"({time.time() - t0:.0f}s)")
        save_pytree(args.ckpt, {"params": params, "stats": stats,
                                "opt_state": opt.state(),
                                "seen": np.int64(seen)})
        print(f"epoch {epoch} done, checkpoint -> {args.ckpt}")

    if args.export_weights:
        raw_out = train_params_to_raw(params, stats, plan.defs())
        header = np.array([0, 2, 0, seen, 0], np.int32)
        save_darknet_weights(args.export_weights, header, raw_out,
                             plan.defs())
        print(f"darknet weights -> {args.export_weights}")


if __name__ == "__main__":
    main()
