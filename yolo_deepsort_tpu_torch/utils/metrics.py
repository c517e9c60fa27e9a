"""Detection evaluation: AP / mAP machinery (copy of
yolo_deepsort_tpu/utils/metrics.py; numpy only).

Host-side numpy -- evaluation is offline. The port keeps its own copy so
that it imports nothing of the JAX package;
``tests/test_torch_port_mot.py`` holds the two copies equal on the same
inputs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def compute_ap(recall: Sequence[float], precision: Sequence[float]) -> float:
    """Average precision from recall/precision curves (VOC-style integration,
    utils.py:~120)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def ap_per_class(
    tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray, target_cls: np.ndarray
):
    """Per-class precision, recall, AP, f1 (utils.py:~60-115)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    unique_classes = np.unique(target_cls)
    ap, p, r = [], [], []
    for c in unique_classes:
        i = pred_cls == c
        n_gt = (target_cls == c).sum()
        n_p = i.sum()
        if n_p == 0 and n_gt == 0:
            continue
        if n_p == 0 or n_gt == 0:
            ap.append(0.0)
            r.append(0.0)
            p.append(0.0)
            continue
        fpc = (1 - tp[i]).cumsum()
        tpc = tp[i].cumsum()
        recall_curve = tpc / (n_gt + 1e-16)
        r.append(recall_curve[-1])
        precision_curve = tpc / (tpc + fpc)
        p.append(precision_curve[-1])
        ap.append(compute_ap(recall_curve, precision_curve))

    p, r, ap = np.array(p), np.array(r), np.array(ap)
    f1 = 2 * p * r / (p + r + 1e-16)
    return p, r, ap, f1, unique_classes.astype(int)


def _iou_matrix(a: np.ndarray, b: np.ndarray, eps=1e-16) -> np.ndarray:
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (aa[:, None] + ab[None, :] - inter + eps)


def get_batch_statistics(
    outputs: List[np.ndarray | None],
    targets: np.ndarray,
    iou_threshold: float,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per-sample (tp, conf, pred_cls) stats (utils.py:~160-200).

    outputs[i]: (K, 7) rows (x1,y1,x2,y2,obj,cls_conf,cls) or None.
    targets: (N, 6) [sample_idx, class, x1, y1, x2, y2] (pixel corners).
    """
    batch_metrics = []
    for sample_i, output in enumerate(outputs):
        if output is None or len(output) == 0:
            continue
        pred_boxes = output[:, :4]
        pred_scores = output[:, 4]
        pred_labels = output[:, 6]

        true_positives = np.zeros(pred_boxes.shape[0])
        annotations = targets[targets[:, 0] == sample_i][:, 1:]
        target_labels = annotations[:, 0] if len(annotations) else []
        if len(annotations):
            detected_boxes = []
            target_boxes = annotations[:, 1:]
            for pred_i, (pred_box, pred_label) in enumerate(
                zip(pred_boxes, pred_labels)
            ):
                if len(detected_boxes) == len(annotations):
                    break
                if pred_label not in target_labels:
                    continue
                ious = _iou_matrix(pred_box[None], target_boxes)[0]
                box_index = int(np.argmax(ious))
                if ious[box_index] >= iou_threshold and box_index not in detected_boxes:
                    true_positives[pred_i] = 1
                    detected_boxes.append(box_index)
        batch_metrics.append((true_positives, pred_scores, pred_labels))
    return batch_metrics


def evaluate_map(
    outputs: List[np.ndarray | None],
    targets: np.ndarray,
    iou_threshold: float = 0.5,
):
    """Convenience: full mAP from outputs/targets. Returns (precision,
    recall, AP, f1, classes) arrays."""
    stats = get_batch_statistics(outputs, targets, iou_threshold)
    if not stats:
        z = np.zeros(0)
        return z, z, z, z, np.zeros(0, int)
    tp, conf, pred_cls = (np.concatenate(x, 0) for x in zip(*stats))
    return ap_per_class(tp, conf, pred_cls, targets[:, 1])
