"""int8 accuracy gate for the ReID embed (port of ``tools/int8_gate.py``).

The gate is framework-internal, as the reference's: train the 512-d ReID
net on SYNTHETIC identities (textured person-like crops under pose,
brightness, noise and occluder jitter), fold it, then compare what serving
consumes -- rank-1 retrieval and the features' cosine to the f32 ones --
across the embed routes:

  f32       ``ReIDNet`` in float32 (library convs, TF32 off): the reference
  bf16      the bf16 ``ReIDNet`` (every conv through kernel 7 on the card)
  int8      the per-layer W8A8 forward (``models/quantize.py``
            ``reid_apply_int8``; plain torch ops, the accuracy control)
  int8_res  the int8-resident embed (``reid_apply_int8_resident``): its 15
            stage-2..4 convs through kernel 8 on the card, 15 launches per
            call
  walker    ``reid_apply_f32_via_graph``: the int8 path's graph walker in
            f32, which must agree with the f32 net (``walker_max_diff``)

The reference's record is its XLA twin's (``use_pallas=False``); the port's
takes kernel 8 on the card and reports its plain version beside it
(``rank1_int8_res_plain``, ``cos_int8_res_plain_vs_f32`` and the largest
feature difference, ``int8_res_kernel_vs_plain_max_abs``): kernel 8's int8
codes equal its plain version's, so the two must agree exactly. On the CPU
both are the plain version.

Gate rule (the reference's): int8 may serve only if rank-1 drops less than
one point against bf16 and the mean int8-vs-f32 feature cosine is >= 0.99,
for the per-layer and the resident route, with the walker within 1e-4 and
the classifier trained past 90 % accuracy.

Training: ``train/reid_train.py`` ``init_train_params`` and
``make_train_step`` (SGD, momentum 0.9, decay 5e-4, in float32), folded
with ``models/reid.py`` ``fold_train_params``.

    python3 -m yolo_deepsort_tpu_torch.tools.int8_gate [--ids 32]
        [--steps 300] [--views 8] [--device cuda|cpu]

Prints one JSON line (the reference's keys, plus ``route``, ``device`` and
``launches``: every port kernel's launches in the run); exits 0 iff the
gate passes. ``--device`` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import device_name, resolve_device
from ..kernels.launches import read_launches, zero_launches

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def render_identity(rng, palette, n_views):
    """n_views 128x64 crops of one synthetic identity: 3-band body with
    per-identity colors + stable texture, under per-view jitter (shift,
    brightness, contrast, noise, occluder)."""
    head, shirt, pants = palette
    tex = rng.normal(0, 1, (128, 64, 1)).astype(np.float32)
    views = np.empty((n_views, 128, 64, 3), np.float32)
    for v in range(n_views):
        img = np.empty((128, 64, 3), np.float32)
        dy = int(rng.integers(-6, 7))
        b0, b1 = 24 + dy, 64 + dy  # head/shirt and shirt/pants boundaries
        img[:b0] = head
        img[b0:b1] = shirt
        img[b1:] = pants
        img += 0.12 * tex  # identity-stable texture
        img *= rng.uniform(0.7, 1.3)  # brightness
        img += rng.uniform(-0.1, 0.1, 3)  # color cast
        img += rng.normal(0, 0.05, img.shape)  # sensor noise
        if rng.uniform() < 0.3:  # partial occluder
            ox = int(rng.integers(0, 40))
            oy = int(rng.integers(0, 100))
            img[oy:oy + 24, ox:ox + 20] = rng.uniform(0, 1, 3)
        views[v] = np.clip(img, 0.0, 1.0)
    return (views - IMAGENET_MEAN) / IMAGENET_STD


def make_dataset(n_ids, n_views, seed):
    rng = np.random.default_rng(seed)
    palettes = rng.uniform(0.05, 0.95, (n_ids, 3, 3)).astype(np.float32)
    x = np.stack([render_identity(rng, palettes[i], n_views)
                  for i in range(n_ids)])  # (ids, views, 128, 64, 3)
    y = np.repeat(np.arange(n_ids, dtype=np.int32), n_views)
    return x.reshape(-1, 128, 64, 3), y, palettes, rng


def rank1(qf, gf, qy, gy):
    """rank-1 retrieval accuracy: nearest gallery feature by cosine."""
    sim = np.asarray(qf, np.float64) @ np.asarray(gf, np.float64).T
    return float((gy[np.argmax(sim, 1)] == qy).mean())


def train_embedder(x_train, y_train, rng, n_ids: int, steps: int,
                   batch: int, lr: float, seed: int, device):
    """Train the ReID classifier on the synthetic identities; batches drawn
    from ``rng`` as the reference draws them, cuDNN deterministic (so a
    gate's record is the same in every run on the card). -> (folded
    inference params, the loss of every step, the accuracy of every step),
    read back once at the end (progress lines read every 20th step)."""
    from ..models.reid import fold_train_params
    from ..train.reid_train import init_train_params, make_train_step
    from ..train.trees import deterministic_convs, to_numpy, to_torch

    params, stats = init_train_params(num_classes=n_ids, seed=seed)
    params = to_torch(params, device, trainable=True)
    stats = to_torch(stats, device)
    init, step = make_train_step(lr=lr)
    opt = init(params)
    n = len(x_train)
    losses, accs = [], []
    for it in range(steps):
        idx = rng.choice(n, size=min(batch, n), replace=False)
        with deterministic_convs():
            stats, loss, acc = step(params, opt, stats, x_train[idx],
                                    y_train[idx])
        losses.append(loss)
        accs.append(acc)
        if it % 20 == 0 or it == steps - 1:
            print(f"[int8_gate] step {it} loss {float(loss):.3f} "
                  f"acc {float(acc):.3f}", file=sys.stderr, flush=True)
    losses = torch.stack(losses).cpu().numpy()
    accs = torch.stack(accs).cpu().numpy()
    folded = fold_train_params(to_numpy(params), to_numpy(stats))
    return folded, losses, accs


@torch.no_grad()
def embed_routes(folded, calib_x, sets, device):
    """Features of every route (module docstring) for each input batch of
    ``sets`` {name: (N, 128, 64, 3) float32 numpy}: {route: {name: (N, 512)
    numpy}}. The int8 packages are calibrated on ``calib_x``.
    ``int8_res`` is kernel 8's route, ``int8_res_plain`` its plain
    version."""
    from ..models.quantize import (
        quantize_reid_params,
        quantize_reid_params_resident,
        reid_apply_f32_via_graph,
        reid_apply_int8,
        reid_apply_int8_resident,
    )
    from ..train.trees import full_f32
    from ..weights import reid_from_params, reid_int8_package_to_torch

    net = reid_from_params(folded).to(device)
    net_bf16 = reid_from_params(folded).to(
        device, torch.bfloat16, memory_format=torch.channels_last)
    calib = torch.from_numpy(np.ascontiguousarray(calib_x)).to(device)
    with full_f32():
        qparams = reid_int8_package_to_torch(
            quantize_reid_params(folded, calib), device)
        qres = reid_int8_package_to_torch(
            quantize_reid_params_resident(folded, calib), device)
    routes = {
        "f32": net,
        "bf16": net_bf16,
        "int8": lambda x: reid_apply_int8(qparams, x),
        "int8_res": lambda x: reid_apply_int8_resident(
            qres, x, use_pallas=True),
        "int8_res_plain": lambda x: reid_apply_int8_resident(
            qres, x, use_pallas=False),
        "walker": lambda x: reid_apply_f32_via_graph(folded, x),
    }
    out = {r: {} for r in routes}
    with full_f32():
        for name, x in sets.items():
            xd = torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for r, fn in routes.items():
                out[r][name] = fn(xd).float().cpu().numpy()
    return out


def mean_cos(a, b) -> float:
    return float(np.mean(np.sum(a * b, axis=1)))


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ids", type=int, default=32)
    p.add_argument("--views", type=int, default=8, help="train views/id")
    p.add_argument("--eval-views", type=int, default=6)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.time()
    zero_launches()
    x_train, y_train, palettes, rng = make_dataset(
        args.ids, args.views, args.seed)
    folded, _, accs = train_embedder(x_train, y_train, rng, args.ids,
                                     args.steps, args.batch, args.lr,
                                     args.seed, dev)
    train_acc = float(accs[-1])

    # held-out eval sets: fresh renders of the SAME identities
    def fresh(seed_off):
        r = np.random.default_rng(args.seed + seed_off)
        x = np.stack([render_identity(r, palettes[i], args.eval_views)
                      for i in range(args.ids)])
        return (x.reshape(-1, 128, 64, 3),
                np.repeat(np.arange(args.ids), args.eval_views))

    gx, gy = fresh(1000)
    qx, qy = fresh(2000)
    feats = embed_routes(folded, x_train[:64], {"q": qx, "g": gx}, dev)
    walker_max_diff = float(np.abs(feats["walker"]["q"]
                                   - feats["f32"]["q"]).max())
    r1 = {r: rank1(feats[r]["q"], feats[r]["g"], qy, gy)
          for r in ("f32", "bf16", "int8", "int8_res", "int8_res_plain")}
    cos = {r: mean_cos(feats[r]["q"], feats["f32"]["q"])
           for r in ("bf16", "int8", "int8_res", "int8_res_plain")}
    kernel_vs_plain = max(
        float(np.abs(feats["int8_res"][s] - feats["int8_res_plain"][s]).max())
        for s in ("q", "g"))

    ok = (walker_max_diff < 1e-4
          and train_acc > 0.9
          and r1["int8"] >= r1["bf16"] - 0.01
          and cos["int8"] >= 0.99
          and r1["int8_res"] >= r1["bf16"] - 0.01
          and cos["int8_res"] >= 0.99)
    return {
        "metric": "int8 embed accuracy gate",
        "ok": bool(ok),
        "train_acc": round(train_acc, 4),
        "rank1_f32": round(r1["f32"], 4),
        "rank1_bf16": round(r1["bf16"], 4),
        "rank1_int8": round(r1["int8"], 4),
        "rank1_int8_res": round(r1["int8_res"], 4),
        "cos_bf16_vs_f32": round(cos["bf16"], 5),
        "cos_int8_vs_f32": round(cos["int8"], 5),
        "cos_int8_res_vs_f32": round(cos["int8_res"], 5),
        "walker_max_diff": walker_max_diff,
        "ids": args.ids,
        "steps": args.steps,
        "secs": round(time.time() - t0, 1),
        "route": dev.type,
        "device": device_name(dev),
        "rank1_int8_res_plain": round(r1["int8_res_plain"], 4),
        "cos_int8_res_plain_vs_f32": round(cos["int8_res_plain"], 5),
        "int8_res_kernel_vs_plain_max_abs": kernel_vs_plain,
        "launches": read_launches(),
    }


def main(argv=None) -> int:
    rec = run(argv)
    print(json.dumps(rec))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
