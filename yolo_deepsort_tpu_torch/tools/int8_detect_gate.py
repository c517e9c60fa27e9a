"""int8 accuracy gate for the DETECTOR backbone (port of
``tools/int8_detect_gate.py``).

Framework-internal, as the reference's: the honest load's BN-consistent
random weights with the MOT box prior (``tools/honest_load.py``),
per-frame calibrated thresholds, then a comparison of WHAT NMS EMITS -- the
only detector output the tracker consumes -- between the float32 forward
and the W8A8 backbone (``models/quantize_darknet.py``).

Routes of the int8 forward (a bf16 ``Darknet`` with a ``conv_impl``):

  kernel      ``ops/conv_kernel.py`` ``make_backbone_conv_impl(int8_pkg=)``:
              the packaged layers through kernel 7's int8 mode, the other
              eligible convs through its bf16 mode; the gated route
  plain twin  ``make_plain_int8_conv_impl``: the packaged layers through
              ``conv_plain_int8``, the same arithmetic in plain torch

In the reference the TPU route also sends the unpackaged eligible layers
through the bf16 Pallas conv while its twin leaves them on XLA. In the port
every conv of a bf16 ``Darknet`` runs kernel 7 on the card already
(``models/layers.conv_layer_bf16``), so both routes run every unpackaged
conv through kernel 7 and differ in the packaged layers only. The record
checks that: ``k7_launches_kernel_route`` must be the net's conv count and
``k7_launches_plain_twin`` that count less the packaged layers.

Thresholds calibrated on random weights sit in the dense noise of the
objectness scores, so detections at them flip in and out under changes far
below anything int8 does; NMS rows alone cannot tell a fault from that
crowding. So the gate also runs the plain twin beside the kernel route
and reports the largest difference of the decoded tensors before NMS
(``decoded_kernel_vs_plain_max_abs``; kernel 7's int8 mode equals its
plain version, so 0 is expected on the card; on the CPU both routes are
plain versions).

Gate rule (the reference's tolerance-band matching: each path's detections
at the calibrated threshold are matched against the other path's at a
threshold lowered by BAND = 0.02): >= 95 % of the f32 detections match an
int8 detection at class-agnostic IoU >= 0.5 and vice versa, mean IoU of the
matches >= 0.88, mean |conf delta| < 0.05. The input letterbox is the plain
``ops/letterbox.letterbox_batch`` in float32, the reference's XLA one, so
the calibrated scales can be held to the JAX package's.

    python3 -m yolo_deepsort_tpu_torch.tools.int8_detect_gate
        [--model yolov3] [--frames 4] [--device cuda|cpu]

Prints one JSON line (the reference's keys, plus ``device``, the checks
above and ``launches``); exits 0 iff the gate passes. ``--device``
defaults to the card and raises without one.
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

BAND = 0.02  # tolerance band (module docstring)


def iou_matrix(a, b):
    """(N,4) x (M,4) xyxy -> (N,M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def greedy_match(ref, got, iou_thres=0.5, class_aware=False):
    """Greedy IoU matching (class-agnostic by default -- see module doc).
    ref/got: (N,7)/(M,7) boxes7 rows [x1,y1,x2,y2,score,cls_conf,cls].
    Returns (pairs, ious) where pairs is a list of (i, j) matched
    indices."""
    m = iou_matrix(ref[:, :4], got[:, :4])
    if class_aware:
        m = np.where(ref[:, 6][:, None] == got[:, 6][None, :], m, 0.0)
    pairs, ious = [], []
    m = m.copy()
    while m.size and m.max() >= iou_thres:
        i, j = np.unravel_index(np.argmax(m), m.shape)
        pairs.append((int(i), int(j)))
        ious.append(float(m[i, j]))
        m[i, :] = 0.0
        m[:, j] = 0.0
    return pairs, ious


@torch.no_grad()
def int8_decode(detector_bf16, xs, pkg, plain_twin: bool):
    """The int8 forward on kernel 7's route, or on the plain twin: ->
    (decoded (N, boxes, 5+C) float32, kernel 7 launches it took)."""
    from ..models.quantize_darknet import make_plain_int8_conv_impl
    from ..ops import conv_kernel

    impl = (make_plain_int8_conv_impl(pkg) if plain_twin
            else conv_kernel.make_backbone_conv_impl(int8_pkg=pkg))
    before = conv_kernel.launches
    out = detector_bf16(xs, conv_impl=impl)
    return out, conv_kernel.launches - before


def int8_routes(detector_bf16, xs, pkg):
    """The gated int8 forward, kernel 7's route, and the record's route
    checks against the twin run beside it. -> (decoded,
    {"k7_launches_kernel_route", "k7_launches_plain_twin",
    "decoded_kernel_vs_plain_max_abs"})."""
    decoded, k7 = int8_decode(detector_bf16, xs, pkg, False)
    twin, k7_twin = int8_decode(detector_bf16, xs, pkg, True)
    return decoded, {"k7_launches_kernel_route": k7,
                     "k7_launches_plain_twin": k7_twin,
                     "decoded_kernel_vs_plain_max_abs": float(
                         (decoded - twin).abs().max())}


def match_frames(b7_f32, m_f32, b7_i8, m_i8, conf_vec):
    """The tolerance-band matching over every frame (both sets at the
    loosened threshold, strict members at ``conf_vec``) -> the record's
    matching fields."""
    n_ref = n_got = 0
    miss_ref = miss_got = 0
    all_ious, conf_err, cls_agree = [], [], []
    for i in range(len(conf_vec)):
        ref = b7_f32[i][m_f32[i]]   # f32 at thr - BAND
        got = b7_i8[i][m_i8[i]]     # int8 at thr - BAND
        pairs, ious = greedy_match(ref, got)
        thr = float(conf_vec[i])
        ref_strict = {j for j in range(len(ref)) if ref[j, 4] >= thr}
        got_strict = {j for j in range(len(got)) if got[j, 4] >= thr}
        n_ref += len(ref_strict)
        n_got += len(got_strict)
        mi = {a for a, _ in pairs}
        mj = {b for _, b in pairs}
        miss_ref += sum(1 for j in ref_strict if j not in mi)
        miss_got += sum(1 for j in got_strict if j not in mj)
        # fidelity stats over matched pairs with at least one strict member
        for (a, b), iou in zip(pairs, ious):
            if a in ref_strict or b in got_strict:
                all_ious.append(iou)
                conf_err.append(abs(float(ref[a, 4]) - float(got[b, 4])))
                cls_agree.append(float(ref[a, 6] == got[b, 6]))
    return {
        "dets_f32": n_ref,
        "dets_int8": n_got,
        "match_ref": 1.0 - miss_ref / max(n_ref, 1),
        "match_got": 1.0 - miss_got / max(n_got, 1),
        "mean_iou": float(np.mean(all_ious)) if all_ious else 0.0,
        "conf_mae": float(np.mean(conf_err)) if conf_err else 1.0,
        "cls_agreement": (round(float(np.mean(cls_agree)), 4)
                          if cls_agree else None),
    }


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="yolov3",
                   choices=["yolov3", "yolov3-tiny", "yolov4"])
    p.add_argument("--img-size", type=int, default=416)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--frame-h", type=int, default=1080)
    p.add_argument("--frame-w", type=int, default=1920)
    p.add_argument("--target-dets", type=int, default=32)
    p.add_argument("--max-dets", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pct", type=float, default=100.0,
                   help="activation-calibration percentile of |x| mapped "
                        "to code 127 (100 = absmax)")
    p.add_argument("--k3-only", action="store_true",
                   help="quantize only the 3x3 convs")
    p.add_argument("--calib-frames", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from ..cfg.architectures import ARCHITECTURES
    from ..models.darknet import build_network
    from ..models.quantize_darknet import quantize_darknet_from_frames
    from ..ops.letterbox import letterbox_batch
    from ..ops.nms import batched_nms
    from ..train.trees import full_f32
    from ..weights import darknet_from_raw
    from .honest_load import bn_consistent_raw

    t_start = time.time()

    def progress(msg):
        print(f"[{time.time() - t_start:6.1f}s] {msg}", file=sys.stderr,
              flush=True)

    zero_launches()
    plan = build_network(ARCHITECTURES[args.model](img_size=args.img_size))
    rng = np.random.default_rng(args.seed)
    frames = torch.from_numpy(rng.integers(
        0, 256, (args.frames, args.frame_h, args.frame_w, 3),
        dtype=np.uint8)).to(dev)
    # BN-consistent weights + MOT box prior (the honest load's recipe)
    detector = darknet_from_raw(
        plan, bn_consistent_raw(plan, frames, seed=args.seed)).to(dev)
    progress("weights ready (BN-consistent + MOT box prior)")
    with full_f32():
        pkg = quantize_darknet_from_frames(
            detector, frames, args.img_size, max_frames=args.calib_frames,
            pct=args.pct, k3_only=args.k3_only)
    progress(f"calibrated int8 package: {len(pkg)} layers")
    route = dev.type
    if not pkg:
        return {"gate": "detector-int8", "ok": False, "route": route,
                "reason": "no eligible convs"}

    xs = letterbox_batch(frames, args.img_size)
    kth = max(1, min(args.target_dets, args.max_dets))
    with torch.no_grad(), full_f32():
        decoded_f32 = detector(xs)
    conf_vec = torch.topk(decoded_f32[..., 4], kth, dim=-1).values[:, kth - 1]
    progress("f32 forward done")

    det_bf16 = copy.deepcopy(detector).to(
        dev, torch.bfloat16, memory_format=torch.channels_last)
    decoded_i8, checks = int8_routes(det_bf16, xs, pkg)
    progress(f"int8 forward done ({route})")

    # both paths at the LOOSENED threshold; the strict sets are the rows
    # at/above the calibrated threshold within them
    lo_vec = conf_vec - BAND

    def run_nms(decoded):
        b7, mask = batched_nms(decoded.float(), lo_vec, 0.4, 512,
                               args.max_dets)
        return b7.cpu().numpy().astype(np.float32), mask.cpu().numpy()

    m = match_frames(*run_nms(decoded_f32), *run_nms(decoded_i8),
                     conf_vec.cpu().numpy())
    ok = (m["match_ref"] >= 0.95 and m["match_got"] >= 0.95
          and m["mean_iou"] >= 0.88 and m["conf_mae"] < 0.05
          and m["dets_f32"] > 0)
    return {
        "gate": "detector-int8",
        "ok": bool(ok),
        "model": args.model,
        "route": route,
        "pct": args.pct,
        "k3_only": bool(args.k3_only),
        "int8_layers": len(pkg),
        "dets_f32": m["dets_f32"],
        "dets_int8": m["dets_int8"],
        "matched_frac_f32": round(m["match_ref"], 4),
        "matched_frac_int8": round(m["match_got"], 4),
        "mean_iou": round(m["mean_iou"], 4),
        "conf_mae": round(m["conf_mae"], 4),
        "cls_agreement": m["cls_agreement"],
        "elapsed_s": round(time.time() - t_start, 1),
        "device": device_name(dev),
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
