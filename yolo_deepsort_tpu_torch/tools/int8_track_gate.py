"""Track-level int8 gate for the DETECTOR backbone (port of
``tools/int8_track_gate.py``).

The detect gate (``int8_detect_gate.py``) compares what NMS emits, and on
the random-weight honest load its detections at the calibrated threshold
flip under any change of arithmetic. This gate compares what the serving
step EMITS -- tracks -- since DeepSORT's confirmation, coasting and gallery
matching exist to absorb marginal detection churn.

Procedure, as the reference's: static seeded frames per stream
(``--seed``), BN-consistent weights with the MOT box prior
(``honest_load.bn_consistent_raw``), the W8A8 package calibrated on two of
the frames, one scalar threshold (the mean over streams of the f32
forward's ``--target-dets``-th objectness), then ``--steps`` steps of three
``make_batched_step``s over the same frames:

  f32    the float32 detector and ReID net (the oracle)
  bf16   their bf16 twins (the serving arithmetic; its churn against f32
         is the yardstick)
  int8   the bf16 twins with the packaged layers through kernel 7's int8
         modes (``use_pallas_conv=True, backbone_int8_pkg=``), the
         change under gate

and, beside them, the int8 plain twin (``use_pallas_conv="plain-twin"``,
the same arithmetic in plain torch), in place of the reference's
``--xla-twin``. From ``--warmup`` on, each step's emitted tracks are
matched per stream by greedy IoU and the id correspondence is followed
frame by frame (``PairScore``).

Gate rule (the reference's, relative to the bf16 yardstick): churn(int8 vs
bf16) <= max(1.5 x churn(bf16 vs f32), 0.01), mean IoU of the matched
tracks >= 0.90, id remap rate <= 0.02, and at least one bf16 track. The
record's ``int8_kernel_vs_plain`` holds the kernel route to its twin: on
the card kernel 7's int8 modes equal their plain versions, so churn 0,
remaps 0 and ``decoded_max_abs`` 0 are expected (on the CPU both routes are
plain versions).

    python3 -m yolo_deepsort_tpu_torch.tools.int8_track_gate
        [--model yolov3] [--steps 60] [--device cuda|cpu]

Prints one JSON line (the reference's keys, plus ``device``, the twin's
summary, the launches per path and ``launches``); exits 0 iff the gate
passes. ``--device`` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from ..device import device_name, resolve_device
from ..kernels.launches import read_launches, zero_launches
from .int8_detect_gate import greedy_match

# relative gate (module docstring): the int8 churn against bf16 may be at
# most CHURN_FACTOR times the churn bf16 itself brings against f32, and at
# least CHURN_FLOOR; the other bars
CHURN_FACTOR = 1.5
CHURN_FLOOR = 0.01
MIN_MEAN_IOU = 0.90
MAX_REMAP_RATE = 0.02
PATHS = ("f32", "bf16", "int8", "int8_plain")


class PairScore:
    """Frame-by-frame track agreement between two serving paths."""

    def __init__(self):
        self.n_a = self.n_b = self.miss_a = self.miss_b = 0
        self.ious = []
        self.remaps = 0
        self.pair_frames = 0
        self.id_map = {}

    def score_frame(self, s, ta, tb):
        """Stream ``s``'s emitted tracks of one step on both paths, (n, 5)
        [x1, y1, x2, y2, id] rows each."""
        # greedy_match wants (n,7) rows; pad box4 + id into that shape
        ra = np.concatenate([ta[:, :4]] + [ta[:, 4:5]] * 3, axis=1)
        rb = np.concatenate([tb[:, :4]] + [tb[:, 4:5]] * 3, axis=1)
        pairs, ii = greedy_match(ra, rb)
        self.n_a += len(ta)
        self.n_b += len(tb)
        self.miss_a += len(ta) - len(pairs)
        self.miss_b += len(tb) - len(pairs)
        self.ious.extend(ii)
        self.pair_frames += len(pairs)
        for (i, j) in pairs:
            key = (s, int(ta[i, 4]))
            tgt = int(tb[j, 4])
            prev = self.id_map.get(key)
            if prev is not None and prev != tgt:
                self.remaps += 1
            self.id_map[key] = tgt

    def summary(self):
        total = max(self.n_a + self.n_b, 1)
        return {
            "tracks_a": self.n_a,
            "tracks_b": self.n_b,
            # symmetric churn: unmatched fraction over both paths'
            # emitted tracks
            "churn": round((self.miss_a + self.miss_b) / total, 4),
            "matched_frac_a": round(1.0 - self.miss_a / max(self.n_a, 1), 4),
            "matched_frac_b": round(1.0 - self.miss_b / max(self.n_b, 1), 4),
            "mean_iou": round(float(np.mean(self.ious)), 4)
            if self.ious else 0.0,
            "id_remap_rate": round(
                self.remaps / max(self.pair_frames, 1), 4),
        }


def score_runs(rows_a: List, rows_b: List) -> Dict:
    """``PairScore`` summary of two runs' emitted tracks, each a list over
    steps of a list over streams of (n, 5) rows, plus ``remaps``, the count
    behind ``id_remap_rate``."""
    score = PairScore()
    for step_a, step_b in zip(rows_a, rows_b, strict=True):
        for s, (ta, tb) in enumerate(zip(step_a, step_b, strict=True)):
            score.score_frame(s, np.asarray(ta, np.float32),
                              np.asarray(tb, np.float32))
    return {**score.summary(), "remaps": score.remaps}


class GateLoad(NamedTuple):
    detector: torch.nn.Module  # float32 Darknet on the device
    frames: torch.Tensor       # (S, H, W, 3) uint8 on the device
    pkg: Dict                  # models/quantize_darknet package
    reid_params: Dict          # folded ReID params (numpy), seed 1
    thr: float                 # the reference's scalar threshold


@torch.no_grad()
def gate_load(model: str, img_size: int, streams: int, hw, seed: int,
              pct: float, k3_only: bool, target: int, max_dets: int,
              device) -> GateLoad:
    """The reference gate's load on ``device`` (its ``main``, ``:121-158``):
    seeded frames, the honest load's weights, the int8 package calibrated on
    two frames and the scalar threshold."""
    from ..cfg.architectures import ARCHITECTURES
    from ..models.darknet import build_network
    from ..models.quantize_darknet import quantize_darknet_from_frames
    from ..models.reid import random_reid_params
    from ..ops.letterbox import letterbox_batch
    from ..train.trees import full_f32
    from ..weights import darknet_from_raw
    from .honest_load import bn_consistent_raw

    dev = resolve_device(device)
    plan = build_network(ARCHITECTURES[model](img_size=img_size))
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(
        0, 256, (streams, *hw, 3), dtype=np.uint8)).to(dev)
    detector = darknet_from_raw(
        plan, bn_consistent_raw(plan, frames, seed=seed)).to(dev)
    with full_f32():
        pkg = quantize_darknet_from_frames(detector, frames, img_size,
                                           max_frames=2, pct=pct,
                                           k3_only=k3_only)
        decoded = detector(letterbox_batch(frames, img_size))
    kth = max(1, min(target, max_dets))
    thr = float(torch.topk(decoded[..., 4], kth, dim=-1).values[:, kth - 1]
                .mean())
    return GateLoad(detector, frames, pkg, random_reid_params(seed=1), thr)


def make_paths(detector, reid_params, pkg, det_cfg, trk_cfg, hw):
    """The gate's four ``make_batched_step``s, keyed as ``PATHS``: f32, bf16,
    the int8 route through kernel 7 and its plain twin. -> ({path: (step,
    whether it runs in float32)}, the bf16 detector, the bf16 ReID net)."""
    from ..parallel.streams import make_batched_step
    from ..weights import reid_from_params

    dev = next(detector.parameters()).device
    cl = torch.channels_last
    reid = reid_from_params(reid_params).to(dev)
    det16 = copy.deepcopy(detector).to(dev, torch.bfloat16, memory_format=cl)
    reid16 = copy.deepcopy(reid).to(dev, torch.bfloat16, memory_format=cl)
    args16 = (det16, reid16, det_cfg, trk_cfg, hw)
    return {
        "f32": (make_batched_step(detector, reid, det_cfg, trk_cfg, hw), True),
        "bf16": (make_batched_step(*args16), False),
        "int8": (make_batched_step(*args16, use_pallas_conv=True,
                                   backbone_int8_pkg=pkg), False),
        "int8_plain": (make_batched_step(*args16,
                                         use_pallas_conv="plain-twin",
                                         backbone_int8_pkg=pkg), False),
    }, det16, reid16


def track_rows(step, f32: bool, trk_cfg, frames: torch.Tensor, steps: int,
               warmup: int) -> List:
    """``steps`` steps of ``step`` from fresh states over the same frames;
    -> the emitted tracks of every step from ``warmup`` on, a list over
    streams of (n, 5) float32 [x1, y1, x2, y2, id] rows each."""
    from ..api import _emitted_rows
    from ..parallel.streams import init_stream_states
    from ..train.trees import full_f32

    states = init_stream_states(trk_cfg, frames.shape[0], frames.device)
    rows = []
    for i in range(steps):
        with full_f32() if f32 else contextlib.nullcontext():
            states, (out, emit) = step(states, frames)
        if i >= warmup:
            rows.append([r.astype(np.float32)
                         for r in _emitted_rows(out, emit)])
    return rows


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="yolov3",
                   choices=["yolov3", "yolov3-tiny", "yolov4"])
    p.add_argument("--img-size", type=int, default=416)
    p.add_argument("--streams", type=int, default=2)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--warmup", type=int, default=10,
                   help="frames before scoring starts (track confirmation)")
    p.add_argument("--frame-h", type=int, default=1080)
    p.add_argument("--frame-w", type=int, default=1920)
    p.add_argument("--target-dets", type=int, default=32)
    p.add_argument("--max-dets", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pct", type=float, default=100.0)
    p.add_argument("--k3-only", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from ..config import DetectorConfig, TrackerConfig
    from ..ops.letterbox_kernel import letterbox_batch_fused
    from .int8_detect_gate import int8_decode

    t_start = time.time()

    def progress(msg):
        print(f"[{time.time() - t_start:6.1f}s] {msg}", file=sys.stderr,
              flush=True)

    zero_launches()
    hw = (args.frame_h, args.frame_w)
    load = gate_load(args.model, args.img_size, args.streams, hw, args.seed,
                     args.pct, args.k3_only, args.target_dets, args.max_dets,
                     dev)
    progress(f"weights ready; int8 package: {len(load.pkg)} layers; "
             f"calibrated conf_thres {load.thr:.4f}")
    if not load.pkg:
        return {"gate": "tracker-int8-backbone", "ok": False,
                "route": dev.type, "reason": "no eligible convs"}

    det_cfg = DetectorConfig(img_size=args.img_size, conf_thres=load.thr,
                             nms_thres=0.4, max_dets=args.max_dets)
    trk_cfg = TrackerConfig(max_dets=args.max_dets, max_tracks=128)
    paths, det16, reid16 = make_paths(load.detector, load.reid_params,
                                      load.pkg, det_cfg, trk_cfg, hw)
    rows, per_path = {}, {}
    for name in PATHS:
        before = read_launches()
        rows[name] = track_rows(*paths[name], trk_cfg, load.frames,
                                args.steps, args.warmup)
        per_path[name] = {k: n - before[k]
                          for k, n in read_launches().items()}
        progress(f"{name} path: {args.steps} steps")

    # the two int8 routes before NMS, on the step's own letterbox
    xs = letterbox_batch_fused(load.frames, args.img_size,
                               out_dtype=torch.bfloat16)
    with torch.no_grad():
        kernel_route, _ = int8_decode(det16, xs, load.pkg, False)
        twin, _ = int8_decode(det16, xs, load.pkg, True)
    twin_max_abs = float((kernel_route.float() - twin.float()).abs().max())

    ys = score_runs(rows["f32"], rows["bf16"])
    cd = score_runs(rows["bf16"], rows["int8"])
    kp = score_runs(rows["int8"], rows["int8_plain"])
    churn_budget = max(ys["churn"] * CHURN_FACTOR, CHURN_FLOOR)
    ok = (cd["churn"] <= churn_budget
          and cd["mean_iou"] >= MIN_MEAN_IOU
          and cd["id_remap_rate"] <= MAX_REMAP_RATE
          and cd["tracks_a"] > 0)
    return {
        "gate": "tracker-int8-backbone",
        "ok": bool(ok),
        "model": args.model,
        "route": dev.type,
        "pct": args.pct,
        "k3_only": bool(args.k3_only),
        "int8_layers": len(load.pkg),
        "scored_frames": args.steps - args.warmup,
        "yardstick_bf16_vs_f32": ys,
        "candidate_int8_vs_bf16": cd,
        "churn_budget": round(churn_budget, 4),
        "elapsed_s": round(time.time() - t_start, 1),
        "device": device_name(dev),
        "conf_thres": load.thr,
        "steps": args.steps,
        "convs": len(det16.convs),
        "reid_convs": sum(isinstance(m, torch.nn.Conv2d)
                          for m in reid16.modules()),
        "int8_kernel_vs_plain": {**kp, "decoded_max_abs": twin_max_abs},
        "launches_per_path": per_path,
        "launches": read_launches(),
    }


def main(argv=None) -> int:
    rec = run(argv)
    print(json.dumps(rec))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
