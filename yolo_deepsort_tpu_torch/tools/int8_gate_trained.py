"""int8 detector gate on TRAINED weights (port of
``tools/int8_gate_trained.py``).

On random weights the calibrated threshold sits in the dense quantile of
noise scores, where even bf16 against f32 churns the detections that
straddle it, so the detector gate's absolute bars cannot be met there. This
gate trains the detector first:

  1. synthesize labelled scenes (filled rectangles with dark borders over
     background noise);
  2. train the stock cfg (``train/yolo_cli.py``
     ``make_detection_train_step``) with the reference's optimizer,
     optax's ``chain(clip_by_global_norm(5.0), adam(lr))`` written out
     here (``ClippedAdam``), until detections separate from background;
     a loss that is not finite at a progress step aborts the run;
  3. compare post-NMS detections of the f32 forward and of the W8A8
     backbone at a FIXED threshold (default 0.5) with the detector gate's
     tolerance-band matching, beside the bf16-vs-f32 yardstick;
  4. gate on the absolute bars: symmetric matched fraction >= 0.95, mean
     IoU of matches >= 0.88, mean |conf delta| < 0.05.

The int8 routes are the detector gate's (``tools/int8_detect_gate.py``):
kernel 7's int8 route on the card with the plain twin run beside it and
the decoded tensors compared before NMS.

    python3 -m yolo_deepsort_tpu_torch.tools.int8_gate_trained
        [--model yolov3-tiny] [--img-size 320] [--steps 300]
        [--device cuda|cpu]

Prints one JSON line (the reference's keys, plus ``route``, ``device``,
``train_secs``, the route checks and ``launches``; after a divergence the
first non-finite step and the loss of every step before it); exits 0 iff
the gate passes. ``--device`` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np
import torch

from ..device import device_name, resolve_device
from ..kernels.launches import read_launches, zero_launches
from .int8_detect_gate import int8_routes, iou_matrix


def synth_scene(rng, size, max_obj=6):
    """One scene: filled rectangles + borders on noise. Returns
    (img uint8 HWC, labels (n,5) [cls, cx, cy, w, h] normalized)."""
    img = rng.integers(0, 64, (size, size, 3)).astype(np.uint8)
    n = int(rng.integers(1, max_obj + 1))
    labels = []
    for _ in range(n):
        w = int(rng.integers(size // 8, size // 3))
        h = int(rng.integers(size // 8, size // 3))
        x0 = int(rng.integers(0, size - w))
        y0 = int(rng.integers(0, size - h))
        color = rng.integers(160, 256, 3)
        img[y0:y0 + h, x0:x0 + w] = color
        b = max(1, min(w, h) // 8)  # dark border makes edges learnable
        img[y0:y0 + b, x0:x0 + w] = 16
        img[y0 + h - b:y0 + h, x0:x0 + w] = 16
        img[y0:y0 + h, x0:x0 + b] = 16
        img[y0:y0 + h, x0 + w - b:x0 + w] = 16
        labels.append([0, (x0 + w / 2) / size, (y0 + h / 2) / size,
                       w / size, h / size])
    return img, np.asarray(labels, np.float32)


def batch_targets(labels_list, max_t=48):
    """Pack per-image label lists into the train step's (T,6)+(T,) mask
    format: rows [img_idx, cls, cx, cy, w, h]."""
    rows = np.zeros((max_t, 6), np.float32)
    mask = np.zeros((max_t,), bool)
    j = 0
    for i, lab in enumerate(labels_list):
        for row in lab:
            if j >= max_t:
                break
            rows[j, 0] = i
            rows[j, 1:] = row
            mask[j] = True
            j += 1
    return rows, mask


def postnms(decoded, conf, nms_fn):
    boxes7, mask = nms_fn(decoded, conf)
    out = []
    b = np.asarray(boxes7, np.float32)
    m = np.asarray(mask, bool)
    for i in range(b.shape[0]):
        out.append(b[i][m[i]])
    return out


def match_sets(a_list, b_list, band=0.02, iou_thr=0.5):
    """int8_detect_gate's tolerance-band symmetric matching, list-of-
    frames form. Rows are (x1,y1,x2,y2,score,cls_conf,cls)."""
    n_a = n_b = hit_a = hit_b = 0
    ious, dconfs = [], []
    for A, B in zip(a_list, b_list):
        n_a += len(A)
        n_b += len(B)
        if len(A) and len(B):
            M = iou_matrix(A[:, :4], B[:, :4])
            for i in range(len(A)):
                j = int(np.argmax(M[i]))
                if M[i, j] >= iou_thr:
                    hit_a += 1
                    ious.append(float(M[i, j]))
                    dconfs.append(abs(float(A[i, 4]) - float(B[j, 4])))
            for j in range(len(B)):
                i = int(np.argmax(M[:, j]))
                if M[i, j] >= iou_thr:
                    hit_b += 1
    return {
        "n_ref": n_a, "n_alt": n_b,
        "matched_ref": round(hit_a / max(n_a, 1), 4),
        "matched_alt": round(hit_b / max(n_b, 1), 4),
        "mean_iou": round(float(np.mean(ious)) if ious else 0.0, 4),
        "conf_mae": round(float(np.mean(dconfs)) if dconfs else 0.0, 4),
    }


class ClippedAdam:
    """optax's ``chain(clip_by_global_norm(max_norm), adam(lr))`` over a
    list of tensors, with optax's formulas: the gradients divided by their
    global norm and multiplied by ``max_norm`` when the norm is not below
    it (``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6
    instead); Adam's moments ``(1 - b) g + b m``, each bias-corrected by
    ``1 - b ** count`` and ``eps`` added outside the square root; the
    update ``-lr * m_hat / (sqrt(v_hat) + eps)`` added to the param
    (optax's defaults b1, b2, eps). No host sync: the clip is a
    ``torch.where`` on the device."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, leaves, lr: float, max_norm: float):
        self.leaves = list(leaves)
        self.lr, self.max_norm = lr, max_norm
        self.mu = [torch.zeros_like(p) for p in self.leaves]
        self.nu = [torch.zeros_like(p) for p in self.leaves]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.leaves:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.leaves]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = norm < self.max_norm
        grads = [torch.where(keep, g, g / norm * self.max_norm)
                 for g in grads]
        self.count += 1
        c1 = float(np.float32(1) - np.float32(self.b1) ** self.count)
        c2 = float(np.float32(1) - np.float32(self.b2) ** self.count)
        for p, g, m, v in zip(self.leaves, grads, self.mu, self.nu):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * (g * g))
            upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            p.add_(upd * -self.lr)


def train_detector(plan, raw, scenes, rng, steps: int, batch: int,
                   lr: float, device, progress=None):
    """Train from raw params on the fixed ``scenes``; batches drawn from
    ``rng`` as the reference draws them, cuDNN deterministic. The loss is
    read every 50th step (progress and the NaN abort, as the reference
    checks). -> (params, stats, losses: a device tensor of every step's
    loss up to the last step run, diverged: whether a read loss was not
    finite)."""
    from ..train.trees import deterministic_convs, to_torch
    from ..train.yolo_cli import make_detection_train_step, raw_params_to_train
    from ..utils.checkpoint import tree_leaves

    params, stats = raw_params_to_train(raw, plan.defs())
    params = to_torch(params, device, trainable=True)
    stats = to_torch(stats, device)
    opt = ClippedAdam(tree_leaves(params), lr, max_norm=5.0)
    step = make_detection_train_step(plan)
    n_train = len(scenes)
    imgs_all = np.stack([s[0] for s in scenes]).astype(np.float32) / 255.0
    losses = []
    for it in range(steps):
        idx = rng.choice(n_train, batch, replace=False)
        targets, tmask = batch_targets([scenes[i][1] for i in idx])
        with deterministic_convs():
            stats, loss, _ = step(params, opt, stats, imgs_all[idx],
                                  targets, tmask)
        losses.append(loss)
        if it % 50 == 0:
            value = float(loss)
            if progress is not None:
                progress(f"train step {it}: loss {value:.3f}")
            if not np.isfinite(value):
                return params, stats, torch.stack(losses), True
    return params, stats, torch.stack(losses), False


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="yolov3-tiny",
                   choices=["yolov3-tiny", "yolov3"])
    p.add_argument("--img-size", type=int, default=320)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--eval-frames", type=int, default=16)
    p.add_argument("--conf", type=float, default=0.5)
    p.add_argument("--nms", type=float, default=0.4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from ..cfg.architectures import ARCHITECTURES
    from ..models.darknet import build_network
    from ..models.quantize_darknet import quantize_darknet_from_frames
    from ..ops.nms import batched_nms
    from ..train.trees import full_f32
    from ..train.yolo_cli import train_params_to_raw
    from ..weights import darknet_from_raw, random_raw_params

    t_start = time.time()

    def progress(msg):
        print(f"[{time.time() - t_start:6.1f}s] {msg}", file=sys.stderr,
              flush=True)

    zero_launches()
    size = args.img_size
    plan = build_network(ARCHITECTURES[args.model](img_size=size))
    rng = np.random.default_rng(args.seed)
    raw = random_raw_params(plan.defs(), seed=args.seed)
    # fixed training set (overfit is FINE: the goal is a detector whose
    # scores separate from background, not generalization)
    scenes = [synth_scene(rng, size) for _ in range(4 * args.batch)]
    t_train = time.time()
    params, stats, losses, diverged = train_detector(
        plan, raw, scenes, rng, args.steps, args.batch, args.lr, dev,
        progress)
    losses = losses.cpu().numpy()
    train_secs = time.time() - t_train
    if diverged:
        bad = int(np.argmin(np.isfinite(losses)))
        return {"metric": "int8 detector gate on trained weights",
                "ok": False,
                "error": f"training diverged (loss NaN by step "
                         f"{len(losses) - 1})",
                "train_loss": [float(losses[0]), float(losses[-1])],
                "route": dev.type, "model": args.model,
                "img_size": size, "lr": args.lr,
                "first_nonfinite_step": bad,
                "loss_trace": [round(float(v), 3) for v in losses[:bad]],
                "train_secs": round(train_secs, 2)}
    loss0, loss_last = float(losses[0]), float(losses[-1])
    progress(f"trained: loss {loss0:.2f} -> {loss_last:.3f}")

    det = darknet_from_raw(
        plan, train_params_to_raw(params, stats, plan.defs())).to(dev)
    # held-out eval scenes (same distribution, fresh draws); square, so the
    # calibration letterbox is an identity resize and /255
    eval_u8 = torch.from_numpy(np.stack(
        [synth_scene(rng, size)[0] for _ in range(args.eval_frames)])).to(dev)
    xs = eval_u8.float() / 255.0
    with full_f32():
        pkg = quantize_darknet_from_frames(det, eval_u8, size, max_frames=4)
    progress(f"calibrated int8 package: {len(pkg)} layers")
    route = dev.type
    if not pkg:
        return {"ok": False, "reason": "no eligible convs", "route": route}

    def nms_fn(decoded, conf):
        b7, mask = batched_nms(decoded.float(), conf_thres=conf,
                               nms_thres=args.nms, max_dets=32)
        return b7.cpu().numpy(), mask.cpu().numpy()

    det_bf16 = copy.deepcopy(det).to(dev, torch.bfloat16,
                                     memory_format=torch.channels_last)
    with torch.no_grad():
        with full_f32():
            dec_f32 = det(xs)
        dec_bf16 = det_bf16(xs)
    dec_int8, checks = int8_routes(det_bf16, xs, pkg)
    d_f32 = postnms(dec_f32, args.conf, nms_fn)
    d_bf16 = postnms(dec_bf16, args.conf, nms_fn)
    d_int8 = postnms(dec_int8, args.conf, nms_fn)
    progress("three forwards + NMS done")

    # score separation: how bimodal is the trained distribution?
    all_scores = np.concatenate([f[:, 4] for f in d_f32]) if any(
        len(f) for f in d_f32) else np.zeros(1)
    margin = float(np.quantile(all_scores, 0.05)) - args.conf if len(
        all_scores) else 0.0

    yardstick = match_sets(d_f32, d_bf16)
    verdict = match_sets(d_f32, d_int8)
    ok = (verdict["matched_ref"] >= 0.95 and verdict["matched_alt"] >= 0.95
          and verdict["mean_iou"] >= 0.88 and verdict["conf_mae"] < 0.05)
    return {
        "metric": "int8 detector gate on trained weights",
        "ok": bool(ok),
        "model": args.model, "img_size": size,
        "train_loss": [round(loss0, 2), round(loss_last, 3)],
        "dets_per_frame": round(
            float(np.mean([len(f) for f in d_f32])), 1),
        "score_margin_above_thr": round(margin, 4),
        "int8_layers": len(pkg),
        "int8_route": route,
        "int8_vs_f32": verdict,
        "bf16_vs_f32_yardstick": yardstick,
        "bars": {"matched": 0.95, "mean_iou": 0.88, "conf_mae": 0.05},
        "route": route,
        "device": device_name(dev),
        "steps": args.steps,
        "train_secs": round(train_secs, 2),
        "convs": len(det_bf16.convs),
        **checks,
        "launches": read_launches(),
    }


def main(argv=None) -> int:
    rec = run(argv)
    print(json.dumps(rec))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
