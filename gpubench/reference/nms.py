"""Plain YOLO post-processing: class-aware greedy NMS with weighted box
merging (eriklindernoren PyTorch-YOLOv3 ``utils.non_max_suppression``),
at the serving step's capacities, and the letterbox-to-frame rescale.
float64 numpy, one image at a time."""

from __future__ import annotations

import numpy as np


def nms_image(pred: np.ndarray, conf_thres: float, nms_thres: float,
              max_boxes: int, max_dets: int) -> np.ndarray:
    """pred (B, 5 + C) decoded rows of one image (centre boxes in input
    pixels, objectness, class scores) -> (n, 7) rows (x1, y1, x2, y2,
    objectness, class score, class), n <= max_dets, best first.

    Rows with objectness >= conf_thres, ranked by objectness x best class
    score (a float32 product; ties: lower row first), the best
    ``max_boxes`` of them; each step takes the best row left and merges
    every row left of its class whose IoU with it exceeds nms_thres
    (itself included) into one box, the objectness-weighted mean of their
    corners."""
    pred = np.asarray(pred, np.float64)
    keep = pred[:, 4] >= conf_thres
    rows = pred[keep]
    if not len(rows):
        return np.zeros((0, 7))
    cls_conf = rows[:, 5:].max(1)
    cls = rows[:, 5:].argmax(1).astype(np.float64)
    # the score as float32 products order it, ties to the lower row
    score = rows[:, 4].astype(np.float32) * cls_conf.astype(np.float32)
    order = np.argsort(-score, kind="stable")[:max_boxes]
    rows, cls_conf, cls = rows[order], cls_conf[order], cls[order]
    xyxy = np.stack([rows[:, 0] - rows[:, 2] / 2, rows[:, 1] - rows[:, 3] / 2,
                     rows[:, 0] + rows[:, 2] / 2, rows[:, 1] + rows[:, 3] / 2],
                    1)
    dets = np.concatenate([xyxy, rows[:, 4:5], cls_conf[:, None],
                           cls[:, None]], 1)
    out = []
    while len(dets) and len(out) < max_dets:
        top = dets[0]
        ix1 = np.maximum(top[0], dets[:, 0])
        iy1 = np.maximum(top[1], dets[:, 1])
        ix2 = np.minimum(top[2], dets[:, 2])
        iy2 = np.minimum(top[3], dets[:, 3])
        inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
        area = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
        iou = inter / (area[0] + area - inter + 1e-16)
        merge = (iou > nms_thres) & (dets[:, 6] == top[6])
        merge[0] = True
        w = dets[merge, 4:5]
        row = top.copy()
        row[:4] = (w * dets[merge, :4]).sum(0) / w.sum()
        out.append(row)
        dets = dets[~merge]
    return np.stack(out) if out else np.zeros((0, 7))


def to_frame(boxes_xyxy: np.ndarray, size: int, frame_hw) -> np.ndarray:
    """Letterboxed xyxy -> frame xyxy, clipped to [0, W-1] x [0, H-1]
    (PyTorch-YOLOv3 ``rescale_boxes``: the pad offset is ``pad // 2``)."""
    h, w = frame_hw
    b = np.array(boxes_xyxy, np.float64).reshape(-1, 4)
    pad_x = max(h - w, 0) * (size / max(h, w))
    pad_y = max(w - h, 0) * (size / max(h, w))
    uh, uw = size - pad_y, size - pad_x
    b[:, [0, 2]] = (b[:, [0, 2]] - pad_x // 2) / uw * w
    b[:, [1, 3]] = (b[:, [1, 3]] - pad_y // 2) / uh * h
    b[:, [0, 2]] = b[:, [0, 2]].clip(0, w - 1)
    b[:, [1, 3]] = b[:, [1, 3]].clip(0, h - 1)
    return b
