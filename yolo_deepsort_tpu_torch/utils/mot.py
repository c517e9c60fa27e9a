"""CLEAR-MOT evaluation (MOTA / MOTP / ID switches), IDF1 and MOTChallenge
file IO (copy of yolo_deepsort_tpu/utils/mot.py; numpy and scipy only).

The BASELINE gate metric is "MOTA/ID-switch parity on MOT sequences".
Implements the CLEAR-MOT protocol (Bernardin & Stiefelhagen 2008): per
frame, keep surviving correspondences above the IoU threshold, optimally
match the rest, count misses / false positives / id switches. The port
keeps its own copy so that it imports nothing of the JAX package;
``tests/test_torch_port_mot.py`` holds the two copies equal on the same
inputs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment


@dataclasses.dataclass
class MotMetrics:
    mota: float
    motp: float
    id_switches: int
    misses: int
    false_positives: int
    matches: int
    num_gt: int
    num_frames: int
    idf1: float = float("nan")  # identity F1; filled by callers that also
    # run idf1_score (trajectory-level, not computable frame-incrementally)

    def __str__(self) -> str:
        idf1 = "" if self.idf1 != self.idf1 else (
            f" | IDF1 {self.idf1 * 100:.1f}%"
        )
        return (
            f"MOTA {self.mota * 100:.1f}% | MOTP {self.motp * 100:.1f}% | "
            f"IDsw {self.id_switches} | FN {self.misses} | "
            f"FP {self.false_positives} | GT {self.num_gt}{idf1}"
        )


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (N, 4) / (M, 4) xyxy boxes."""
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-12)


def evaluate_mot(
    gt_frames: Sequence[np.ndarray],
    hyp_frames: Sequence[np.ndarray],
    iou_threshold: float = 0.5,
) -> MotMetrics:
    """CLEAR-MOT over aligned frame sequences.

    gt_frames[t]: (G, 5) rows [gt_id, x1, y1, x2, y2]
    hyp_frames[t]: (H, 5) rows [x1, y1, x2, y2, track_id] (tracker output
      convention of this framework / the reference).
    """
    assert len(gt_frames) == len(hyp_frames)
    last_match: Dict[int, int] = {}  # gt_id -> hyp_id (for IDSW counting)
    corr: Dict[int, int] = {}  # surviving correspondences gt_id -> hyp_id

    id_switches = misses = false_positives = matches = num_gt = 0
    iou_sum = 0.0

    for gt, hyp in zip(gt_frames, hyp_frames):
        gt = np.asarray(gt, np.float64).reshape(-1, 5)
        hyp = np.asarray(hyp, np.float64).reshape(-1, 5)
        gt_ids = gt[:, 0].astype(int)
        gt_boxes = gt[:, 1:5]
        hyp_ids = hyp[:, 4].astype(int)
        hyp_boxes = hyp[:, 0:4]
        num_gt += len(gt_ids)

        iou = _iou(gt_boxes, hyp_boxes) if len(gt_ids) and len(hyp_ids) else (
            np.zeros((len(gt_ids), len(hyp_ids)))
        )
        frame_corr: Dict[int, int] = {}
        used_g = set()
        used_h = set()

        # 1) keep surviving correspondences still above the threshold
        hyp_pos = {h: j for j, h in enumerate(hyp_ids)}
        for gi, g in enumerate(gt_ids):
            h = corr.get(g)
            if h is None or h not in hyp_pos:
                continue
            hj = hyp_pos[h]
            if iou[gi, hj] >= iou_threshold:
                frame_corr[g] = h
                used_g.add(gi)
                used_h.add(hj)
                iou_sum += iou[gi, hj]

        # 2) optimal matching on the remainder
        free_g = [i for i in range(len(gt_ids)) if i not in used_g]
        free_h = [j for j in range(len(hyp_ids)) if j not in used_h]
        if free_g and free_h:
            sub = iou[np.ix_(free_g, free_h)]
            cost = 1.0 - sub
            rows, cols = linear_sum_assignment(cost)
            for r, c in zip(rows, cols):
                if sub[r, c] >= iou_threshold:
                    gi, hj = free_g[r], free_h[c]
                    g, h = gt_ids[gi], hyp_ids[hj]
                    frame_corr[g] = h
                    used_g.add(gi)
                    used_h.add(hj)
                    iou_sum += sub[r, c]

        # 3) count events
        for g, h in frame_corr.items():
            if g in last_match and last_match[g] != h:
                id_switches += 1
            last_match[g] = h
        matches += len(frame_corr)
        misses += len(gt_ids) - len(frame_corr)
        false_positives += len(hyp_ids) - len(frame_corr)
        corr = frame_corr

    mota = 1.0 - (misses + false_positives + id_switches) / max(num_gt, 1)
    motp = iou_sum / max(matches, 1)
    return MotMetrics(
        mota=mota,
        motp=motp,
        id_switches=id_switches,
        misses=misses,
        false_positives=false_positives,
        matches=matches,
        num_gt=num_gt,
        num_frames=len(gt_frames),
    )


# ------------------------------------------------- MOTChallenge file format

def load_mot_file(
    path: str | os.PathLike,
    min_visibility: float = 0.0,
    person_only: bool = True,
) -> Dict[int, np.ndarray]:
    """Parse a MOTChallenge gt.txt/det.txt:
    frame,id,bb_left,bb_top,bb_width,bb_height,conf,class,visibility.
    Returns frame -> (K, 6) rows [id, x1, y1, x2, y2, conf]."""
    data = np.loadtxt(path, delimiter=",", ndmin=2)
    frames: Dict[int, List[np.ndarray]] = {}
    for row in data:
        frame, tid = int(row[0]), int(row[1])
        x, y, w, h = row[2:6]
        conf = row[6] if len(row) > 6 else 1.0
        if len(row) > 7 and person_only and int(row[7]) not in (1, -1):
            continue  # MOT16 gt class 1 = pedestrian
        if len(row) > 8 and 0 <= row[8] < min_visibility:
            continue  # det.txt rows carry -1 placeholders, not visibility
        if conf == 0:
            continue  # MOT16 gt conf 0 = ignore region
        frames.setdefault(frame, []).append(
            np.array([tid, x, y, x + w, y + h, conf])
        )
    return {f: np.stack(rows) for f, rows in frames.items()}


def mot_sequence_frames(
    gt: Dict[int, np.ndarray], n_frames: int
) -> List[np.ndarray]:
    """Dense per-frame [id, x1, y1, x2, y2] arrays for evaluate_mot."""
    out = []
    for f in range(1, n_frames + 1):
        rows = gt.get(f)
        out.append(rows[:, :5] if rows is not None else np.zeros((0, 5)))
    return out


def idf1_score(
    gt_frames: Sequence[np.ndarray],
    hyp_frames: Sequence[np.ndarray],
    iou_threshold: float = 0.5,
) -> float:
    """IDF1 (Ristani et al. 2016): identity-preservation F1.

    Counts, for every (gt_id, hyp_id) pair, the frames in which they
    spatially coincide (IoU >= threshold), solves ONE global bipartite
    matching between gt and hypothesis trajectories maximizing total
    coinciding frames (IDTP), and scores
    IDF1 = 2*IDTP / (2*IDTP + IDFP + IDFN). Complements CLEAR-MOT: MOTA
    counts per-frame events, IDF1 measures how long identities persist.
    """
    assert len(gt_frames) == len(hyp_frames)
    pair_frames: Dict[tuple, int] = {}
    gt_total: Dict[int, int] = {}
    hyp_total: Dict[int, int] = {}
    for gt, hyp in zip(gt_frames, hyp_frames):
        gt = np.asarray(gt, np.float64).reshape(-1, 5)
        hyp = np.asarray(hyp, np.float64).reshape(-1, 5)
        for g in gt[:, 0].astype(int):
            gt_total[g] = gt_total.get(g, 0) + 1
        for h in hyp[:, 4].astype(int):
            hyp_total[h] = hyp_total.get(h, 0) + 1
        if not len(gt) or not len(hyp):
            continue
        iou = _iou(gt[:, 1:5], hyp[:, 0:4])
        gi, hi = np.nonzero(iou >= iou_threshold)
        for a, b in zip(gi, hi):
            key = (int(gt[a, 0]), int(hyp[b, 4]))
            pair_frames[key] = pair_frames.get(key, 0) + 1

    gt_ids = sorted(gt_total)
    hyp_ids = sorted(hyp_total)
    n_gt_frames = sum(gt_total.values())
    n_hyp_frames = sum(hyp_total.values())
    if not gt_ids or not hyp_ids:
        return 0.0 if (n_gt_frames or n_hyp_frames) else 1.0
    overlap = np.zeros((len(gt_ids), len(hyp_ids)))
    for (g, h), n in pair_frames.items():
        overlap[gt_ids.index(g), hyp_ids.index(h)] = n
    rows, cols = linear_sum_assignment(-overlap)
    idtp = overlap[rows, cols].sum()
    idfn = n_gt_frames - idtp
    idfp = n_hyp_frames - idtp
    return float(2 * idtp / max(2 * idtp + idfp + idfn, 1e-12))
