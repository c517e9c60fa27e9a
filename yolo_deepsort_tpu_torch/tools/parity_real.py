"""One-command real-weights parity runbook (port of ``tools/parity_real.py``).

No official weights or datasets can be fetched here, so the real-weight
checks have never run. The moment the files exist, run:

    python3 -m yolo_deepsort_tpu_torch.tools.parity_real
        --weights weights/yolov3.weights --reid-ckpt weights/ckpt.t7
        --mot-root data/MOT16/train
        [--coco-list data/coco/5k.txt] [--cfg config/yolov3.cfg]
        [--device cuda|cpu]

It runs, in order, on the port:
  1. the per-layer weight-compat diff against the numpy oracle
     (``tools/verify_weights.py`` ``verify``, float32);
  2. the ReID checkpoint load (either ckpt layout) and L2-normalised
     features of ``feat_dim_of``'s width;
  3. a COCO mAP@0.5 spot-check over a darknet-style image list through
     ``ImageDetector`` and ``utils/metrics.py``   [skipped without
     --coco-list];
  4. MOTA / ID switches / IDF1 per MOT16 sequence (``sequence_eval``:
     public detections through ``DeepSort.update``, or with --detector the
     whole pipeline, the detector built from --cfg and --weights, through
     ``VideoTracker.track_frame``);
then writes the report (``--out``, default ``PARITY_REAL_torch.md``,
relative to the repo root) and prints one JSON line ``{"ok", "failures",
"out"}``; exits 0 iff no check failed.

``--standins`` smoke-tests the whole flow offline: it synthesizes a
well-conditioned random yolov3-tiny ``.weights``, a ``ckpt.t7`` in the
reference Net's layout, a 2-object 12-frame MOT sequence and a 3-image
list in a temp dir of its own (removed after the run), then runs the same
steps (the accuracy numbers are meaningless; the plumbing is proven).
Images are read and written with PIL, imported where they are; the
stand-ins are ``.png``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..data.datasets import load_rgb

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STANDIN_HW = (160, 240)  # the stand-in sequence's frame (H, W)


def write_rgb(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(img, np.uint8)).save(path)


def reference_net_state_dict(num_classes: int = 751, seed: int = 0) -> dict:
    """A state dict in the reference Net's layout (deep_sort/deep/model.py:
    stem ``conv.0/1``, ``layer1..4`` of two BasicBlocks each with a
    ``downsample`` where the width or stride changes, ``classifier.0/1/4``),
    the keys, shapes and dtypes ``torch.save`` writes into ``ckpt.t7``'s
    ``net_dict``; seeded values in PyTorch's default init ranges (uniform
    of +-1/sqrt(fan_in), BatchNorm at identity)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def dense(name, shape, bias=True):
        bound = float(np.prod(shape[1:])) ** -0.5
        sd[f"{name}.weight"] = torch.from_numpy(
            rng.uniform(-bound, bound, shape).astype(np.float32))
        if bias:
            sd[f"{name}.bias"] = torch.from_numpy(
                rng.uniform(-bound, bound, shape[0]).astype(np.float32))

    def bn(name, c):
        sd[f"{name}.weight"] = torch.ones(c)
        sd[f"{name}.bias"] = torch.zeros(c)
        sd[f"{name}.running_mean"] = torch.zeros(c)
        sd[f"{name}.running_var"] = torch.ones(c)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    dense("conv.0", (64, 3, 3, 3))
    bn("conv.1", 64)
    for li, (ci, co, down) in enumerate(((64, 64, False), (64, 128, True),
                                         (128, 256, True), (256, 512, True)),
                                        start=1):
        for bi in range(2):
            p, c_in = f"layer{li}.{bi}", ci if bi == 0 else co
            dense(f"{p}.conv1", (co, c_in, 3, 3), bias=False)
            bn(f"{p}.bn1", co)
            dense(f"{p}.conv2", (co, co, 3, 3), bias=False)
            bn(f"{p}.bn2", co)
            if bi == 0 and (down or ci != co):
                dense(f"{p}.downsample.0", (co, c_in, 1, 1), bias=False)
                bn(f"{p}.downsample.1", co)
    dense("classifier.0", (256, 512))
    bn("classifier.1", 256)
    dense("classifier.4", (num_classes, 256))
    return sd


def make_mot16_dir(root: str, n_frames: int = 14, seed: int = 0) -> int:
    """A MOTChallenge sequence dir (``img1/`` PNG frames, ``gt/gt.txt``,
    ``det/det.txt``): two coloured objects on constant trajectories; the
    detections are the gt boxes with jitter and MOTChallenge-style raw
    confidence scores."""
    h, w = STANDIN_HW
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "img1")
    os.makedirs(img_dir)
    os.makedirs(os.path.join(root, "gt"))
    os.makedirs(os.path.join(root, "det"))
    objs = [  # (x0, y0, vx, vy, w, h, color)
        (20, 40, 6, 1, 30, 60, (200, 40, 40)),
        (170, 30, -6, 2, 28, 56, (40, 60, 200)),
    ]
    gt_rows, det_rows = [], []
    for t in range(n_frames):
        frame = np.full((h, w, 3), 25, np.uint8)
        for tid, (x0, y0, vx, vy, bw, bh, color) in enumerate(objs, start=1):
            x = x0 + vx * t
            y = y0 + vy * t
            frame[max(y, 0):y + bh, max(x, 0):x + bw] = color
            # gt: frame,id,x,y,w,h,conf,class,visibility
            gt_rows.append(f"{t + 1},{tid},{x},{y},{bw},{bh},1,1,1.0")
            jx, jy = rng.normal(0, 1.0, 2)
            det_rows.append(
                f"{t + 1},-1,{x + jx:.2f},{y + jy:.2f},{bw},{bh},"
                f"{rng.uniform(10, 40):.2f},-1,-1")
        write_rgb(os.path.join(img_dir, f"{t + 1:06d}.png"), frame)
    with open(os.path.join(root, "gt", "gt.txt"), "w") as f:
        f.write("\n".join(gt_rows))
    with open(os.path.join(root, "det", "det.txt"), "w") as f:
        f.write("\n".join(det_rows))
    return n_frames


def make_standins(tmp: str) -> dict:
    """Synthesize stand-in weights, ckpt, sequence and image list under
    ``tmp`` (emptied first), so the whole flow runs with no real file."""
    from specs.weights_np import random_darknet_weights

    from ..cfg import parse_model_config

    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    cfg = os.path.join(REPO, "config", "yolov3-tiny.cfg")
    wpath = os.path.join(tmp, "yolov3-tiny.weights")
    defs = [d for d in parse_model_config(cfg) if d["type"] != "net"]
    with open(wpath, "wb") as f:
        # well-conditioned: activations stay finite through the net, so the
        # per-layer diff is a real layout check, not inf against inf
        f.write(random_darknet_weights(defs, seed=0, well_conditioned=True))
    ckpt = os.path.join(tmp, "ckpt.t7")
    torch.save({"net_dict": reference_net_state_dict(751), "acc": 0.0,
                "epoch": 0}, ckpt)
    make_mot16_dir(os.path.join(tmp, "MOT16-99"), n_frames=12, seed=3)
    coco_list = os.path.join(tmp, "coco_list.txt")
    img_dir = os.path.join(tmp, "images")
    lbl_dir = os.path.join(tmp, "labels")
    os.makedirs(img_dir)
    os.makedirs(lbl_dir)
    rng = np.random.default_rng(0)
    with open(coco_list, "w") as f:
        for i in range(3):
            ip = os.path.join(img_dir, f"im{i}.png")
            write_rgb(ip, rng.integers(0, 255, (240, 320, 3), np.uint8))
            with open(os.path.join(lbl_dir, f"im{i}.txt"), "w") as lf:
                lf.write("0 0.5 0.5 0.2 0.3\n")
            f.write(ip + "\n")
    return dict(weights=wpath, cfg=cfg, reid_ckpt=ckpt, mot_root=tmp,
                coco_list=coco_list)


def sequence_eval(seq_dir: str, detector: str | None, weights: str | None,
                  reid_ckpt: str | None, img_size: int, max_dets: int = 64,
                  device=None):
    """MOT metrics of one MOTChallenge sequence dir (the port's copy of
    ``benchmarks/mot_eval.py`` ``sequence_eval``): public detections
    through ``DeepSort.update``, or with ``detector`` (an architecture name
    or cfg path) every frame through ``VideoTracker.track_frame``. ->
    ``MotMetrics`` with ``idf1`` set."""
    from ..api import Darknet, DeepSort, VideoTracker
    from ..utils.mot import (
        evaluate_mot,
        idf1_score,
        load_mot_file,
        mot_sequence_frames,
    )

    img_dir = os.path.join(seq_dir, "img1")
    frames = sorted(f for f in os.listdir(img_dir)
                    if f.endswith((".jpg", ".png")))
    gt = load_mot_file(os.path.join(seq_dir, "gt", "gt.txt"),
                       min_visibility=0.25)
    gt_frames = mot_sequence_frames(gt, len(frames))
    hyp_frames = []
    if detector:
        model = Darknet(detector, img_size=img_size, device=device)
        if weights:
            model.load_darknet_weights(weights)
        vt = VideoTracker(model, reid_model_path=reid_ckpt)
        for fname in frames:
            img = load_rgb(os.path.join(img_dir, fname))
            hyp_frames.append(vt.track_frame(img).astype(np.float64))
    else:
        dets = load_mot_file(os.path.join(seq_dir, "det", "det.txt"),
                             person_only=False)
        ds = DeepSort(model_path=reid_ckpt, max_dets=max_dets, device=device)
        for i, fname in enumerate(frames):
            img = load_rgb(os.path.join(img_dir, fname))
            rows = dets.get(i + 1)
            if rows is None:
                out = ds.update(np.zeros((0, 4)), [], img)
            else:
                xyxy = rows[:, 1:5]
                xywh = np.stack([(xyxy[:, 0] + xyxy[:, 2]) / 2,
                                 (xyxy[:, 1] + xyxy[:, 3]) / 2,
                                 xyxy[:, 2] - xyxy[:, 0],
                                 xyxy[:, 3] - xyxy[:, 1]], axis=1)
                # MOTChallenge det confidences are unbounded scores; squash
                conf = 1.0 / (1.0 + np.exp(-rows[:, 5] / 10.0))
                out = ds.update(xywh, conf.tolist(), img)
            hyp_frames.append(out.astype(np.float64))
    m = evaluate_mot(gt_frames, hyp_frames)
    m.idf1 = idf1_score(gt_frames, hyp_frames)
    return m


def coco_map_spotcheck(args, lines, device) -> float:
    """Detect over the list images and score mAP@0.5 with the port's
    ``utils/metrics.py`` (the reference's ``ap_per_class`` machinery)."""
    from ..api import Darknet, ImageDetector
    from ..utils.metrics import ap_per_class, get_batch_statistics

    model = Darknet(args.cfg, img_size=args.img_size, device=device)
    model.load_darknet_weights(args.weights)
    det = ImageDetector(model, conf_thres=0.5, nms_thres=0.4)
    with open(args.coco_list) as f:
        paths = [ln.strip() for ln in f if ln.strip()][: args.coco_limit]
    stats, labels_all = [], []
    for p in paths:
        img = load_rgb(p)
        h, w = img.shape[:2]
        out = det.detect(img)  # (N, 7) x1 y1 x2 y2 obj cls_conf cls
        lp = p.replace("images", "labels").rsplit(".", 1)[0] + ".txt"
        rows = []
        if os.path.exists(lp):
            with open(lp) as lf:
                for ln in lf:
                    c, cx, cy, bw, bh = (float(v) for v in ln.split())
                    rows.append([c, (cx - bw / 2) * w, (cy - bh / 2) * h,
                                 (cx + bw / 2) * w, (cy + bh / 2) * h])
        target = np.asarray(rows, np.float32).reshape(-1, 5)
        labels_all.extend(target[:, 0].tolist())
        preds = np.asarray(out, np.float32).reshape(-1, 7)
        # score column for the mAP machinery = obj conf
        stats.extend(get_batch_statistics(
            [np.concatenate([preds[:, :5], preds[:, 5:7]], 1)],
            np.concatenate([np.zeros((len(target), 1), np.float32), target],
                           1),
            iou_threshold=0.5))
    m = 0.0
    if stats:
        tp, conf, cls = [np.concatenate(x, 0) for x in zip(*stats)]
        _, _, ap, _, _ = ap_per_class(tp, conf, cls, np.asarray(labels_all))
        m = float(ap.mean()) if len(ap) else 0.0
    lines.append(f"| COCO mAP@0.5 ({len(paths)} imgs) | {m:.4f} | "
                 "YOLOv3 paper 57.9 AP50 (608) / 55.3 (416) |")
    return m


def run_checks(args, device) -> tuple:
    """The four steps -> (report lines, failures)."""
    from ..models.reid import feat_dim_of, load_reid_checkpoint
    from ..weights import reid_from_params
    from .verify_weights import THRESHOLD, verify, worst_line, worst_of

    lines = ["# PARITY_REAL -- real-weight validation run (PyTorch port)",
             "",
             f"Generated by yolo_deepsort_tpu_torch/tools/parity_real.py on "
             f"{time.strftime('%Y-%m-%d %H:%M')} ({device})"
             + (" **(STAND-IN inputs -- plumbing smoke only; accuracy "
                "numbers are meaningless)**" if args.standins else ""),
             "", "| check | result | reference |", "|---|---|---|"]
    failures = []

    # 1. per-layer weight compat
    if args.weights:
        rows = verify(args.cfg, args.weights, device=device,
                      log=lambda msg: print(msg, file=sys.stderr))["f32"]
        ok = worst_of(rows)[0] <= THRESHOLD
        if not ok:
            failures.append("per-layer diff")
        lines.append(f"| per-layer oracle diff ({os.path.basename(args.weights)}"
                     f") | {'OK' if ok else 'DIVERGES'}: {worst_line(rows)} "
                     "| App. E layout contract |")
    else:
        lines.append("| per-layer oracle diff | SKIPPED (no --weights) | |")

    # 2. ReID checkpoint
    if args.reid_ckpt:
        try:
            params = load_reid_checkpoint(args.reid_ckpt)
            x = np.random.default_rng(0).uniform(0, 1, (4, 128, 64, 3))
            net = reid_from_params(params).to(device)
            with torch.no_grad():
                f = net(torch.from_numpy(x.astype(np.float32)).to(device))
            f = f.cpu().numpy()
            norms = np.linalg.norm(f, axis=1)
            ok = f.shape[1] == feat_dim_of(params) and np.allclose(
                norms, 1.0, atol=1e-3)
            if not ok:
                failures.append("reid ckpt")
            lines.append(f"| ckpt.t7 load + L2-norm features | "
                         f"{'OK' if ok else 'FAIL'} (dim {f.shape[1]}) | "
                         "App. E.3 |")
        except Exception as e:  # noqa: BLE001 -- report, don't crash the run
            failures.append("reid ckpt")
            lines.append(f"| ckpt.t7 load | ERROR: {e} | App. E.3 |")
    else:
        lines.append("| ckpt.t7 load | SKIPPED (no --reid-ckpt) | |")

    # 3. COCO mAP spot-check
    if args.coco_list and args.weights:
        try:
            coco_map_spotcheck(args, lines, device)
        except Exception as e:  # noqa: BLE001
            failures.append("coco map")
            lines.append(f"| COCO mAP@0.5 | ERROR: {e} | |")
    else:
        lines.append("| COCO mAP@0.5 | SKIPPED (no --coco-list) | |")

    # 4. MOT sequences
    if args.mot_root:
        seqs = sorted(d for d in os.listdir(args.mot_root)
                      if os.path.isdir(os.path.join(args.mot_root, d, "img1")))
        for seq in seqs:
            detector = args.cfg if args.detector and args.weights else None
            try:
                m = sequence_eval(os.path.join(args.mot_root, seq), detector,
                                  args.weights, args.reid_ckpt, args.img_size,
                                  device=device)
                lines.append(
                    f"| {seq} MOTA / IDsw / IDF1 | {round(m.mota, 4)} / "
                    f"{m.id_switches} / {round(m.idf1, 4)} | DeepSORT "
                    "paper MOT16: MOTA 61.4, 781 IDsw |")
            except Exception as e:  # noqa: BLE001
                failures.append(f"mot {seq}")
                lines.append(f"| {seq} | ERROR: {str(e)[:120]} | |")
    else:
        lines.append("| MOT sequences | SKIPPED (no --mot-root) | |")
    return lines, failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--weights")
    p.add_argument("--cfg", default="config/yolov3.cfg")
    p.add_argument("--img-size", type=int, default=416)
    p.add_argument("--reid-ckpt")
    p.add_argument("--mot-root")
    p.add_argument("--coco-list")
    p.add_argument("--coco-limit", type=int, default=200)
    p.add_argument("--detector", action="store_true",
                   help="MOT eval with the full detect+track pipeline "
                        "instead of public detections")
    p.add_argument("--standins", action="store_true",
                   help="smoke mode: synthesize fake weights/ckpt/sequence")
    p.add_argument("--out", default="PARITY_REAL_torch.md")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    from ..device import resolve_device

    device = resolve_device(args.device)
    if not os.path.isabs(args.cfg):
        args.cfg = os.path.join(REPO, args.cfg)
    tmp = None
    t0 = time.time()
    try:
        if args.standins:
            tmp = tempfile.mkdtemp(prefix="ydt_torch_parity_standins_")
            st = make_standins(tmp)
            args.weights, args.cfg = st["weights"], st["cfg"]
            args.reid_ckpt, args.mot_root = st["reid_ckpt"], st["mot_root"]
            args.coco_list = st["coco_list"]
        lines, failures = run_checks(args, device)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    lines += ["", f"Wall time: {time.time() - t0:.0f}s. "
              f"Failures: {failures if failures else 'none'}."]
    with open(os.path.join(REPO, args.out), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(json.dumps({"ok": not failures, "failures": failures,
                      "out": args.out}))
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
