"""Class-aware batched NMS with weighted-box merging (port of
yolo_deepsort_tpu/ops/nms.py).

1. Objectness filter, then the ``max_boxes`` best candidates by score =
   obj * max_cls, ties to the lower index (a stable descending sort, the
   order ``jax.lax.top_k`` gives; ``torch.topk`` promises none on CUDA).
2. A fixed ``max_dets``-step loop of batched tensor ops: each step takes the
   best alive candidate of every image, suppresses its same-class overlaps
   and emits their objectness-weighted mean box with the top candidate's
   conf/class columns. Images with nothing alive emit a masked zero row.
   The loop never reads a value back to the host.

Valid rows form a contiguous score-descending prefix (row i is written on
step i); the bucketed serving step relies on that.

``roi_nms_mask`` is the DeepSort-side Malisiewicz NMS of the facades.

On the card both run as CUDA kernels (``ops/nms_kernel.py``,
``csrc/nms.cu``); the ``_plain`` functions below are their plain versions,
which only CPU tensors take.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.profiling import span
from . import nms_kernel
from .boxes import iou_xyxy, xywh_to_xyxy


def batched_nms_with_stats(
    pred: torch.Tensor,  # (N, B, 5+C) decoded, boxes cxcywh in pixels
    conf_thres=0.5,  # float, or (N,) per-image thresholds
    nms_thres: float = 0.4,
    max_boxes: int = 512,
    max_dets: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dets (N, max_dets, 7) [x1, y1, x2, y2, obj, cls_conf, cls],
    mask (N, max_dets) bool, sat (N, 2) int32 [dropped by the top-k,
    still alive when the output filled]). CPU tensors take the plain
    version; a CUDA tensor launches the kernel or raises."""
    with span("ydt.nms"):
        return _nms(pred, conf_thres, nms_thres, max_boxes, max_dets)


def _nms(pred, conf_thres, nms_thres, max_boxes, max_dets):
    if pred.device.type == "cpu":
        return batched_nms_with_stats_plain(pred, conf_thres, nms_thres,
                                            max_boxes, max_dets)
    return nms_kernel.nms_cuda(pred, conf_thres, nms_thres, max_boxes,
                               max_dets)


def batched_nms_with_stats_plain(
    pred: torch.Tensor, conf_thres=0.5, nms_thres: float = 0.4,
    max_boxes: int = 512, max_dets: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of ``batched_nms_with_stats``: a ``max_dets``-step
    loop of batched tensor ops."""
    n, nb, _ = pred.shape
    dev = pred.device
    pred = pred.float()
    if isinstance(conf_thres, (float, int)):
        # a fill, not a host-to-device copy (which would sync the stream)
        thr = torch.full((n,), float(conf_thres), device=dev)
    else:
        thr = torch.as_tensor(conf_thres, dtype=torch.float32, device=dev)
        thr = thr.expand(n) if thr.dim() == 0 else thr
    obj = pred[..., 4]
    cls_scores = pred[..., 5:]
    cls_conf = cls_scores.max(-1).values
    cls_pred = cls_scores.argmax(-1).float()  # first max on ties
    valid = obj >= thr[:, None]
    score = torch.where(valid, obj * cls_conf, torch.full_like(obj, -1.0))

    k = min(max_boxes, nb)
    n_valid = valid.sum(-1, dtype=torch.int32)
    dropped_topk = (n_valid - k).clamp(min=0)
    top_score, top_idx = torch.sort(score, dim=-1, descending=True,
                                    stable=True)
    top_score, top_idx = top_score[:, :k], top_idx[:, :k]
    rows = torch.gather(pred, 1, top_idx[..., None].expand(-1, -1,
                                                          pred.shape[-1]))
    boxes = xywh_to_xyxy(rows[..., :4])  # (N, K, 4)
    obj_k = rows[..., 4]
    cls_conf_k = torch.gather(cls_conf, 1, top_idx)
    cls_pred_k = torch.gather(cls_pred, 1, top_idx)
    alive = top_score > 0.0

    iou = iou_xyxy(boxes, boxes)  # (N, K, K)
    same_class = cls_pred_k[:, :, None] == cls_pred_k[:, None, :]
    suppress = (iou > nms_thres) & same_class

    out = torch.zeros((n, max_dets, 7), dtype=torch.float32, device=dev)
    out_mask = torch.zeros((n, max_dets), dtype=torch.bool, device=dev)
    img = torch.arange(n, device=dev)
    for i in range(max_dets):
        any_alive = alive.any(-1)  # (N,)
        top = alive.to(torch.uint8).argmax(-1)  # first alive = best alive
        invalid = suppress[img, top] & alive  # includes `top` itself
        weights = torch.where(invalid, obj_k, torch.zeros_like(obj_k))
        wsum = weights.sum(-1, keepdim=True)
        merged = (weights[..., None] * boxes).sum(1) / wsum.clamp(min=1e-20)
        row = torch.cat([merged, obj_k[img, top, None],
                         cls_conf_k[img, top, None],
                         cls_pred_k[img, top, None]], -1)
        out[:, i] = torch.where(any_alive[:, None], row, out[:, i])
        out_mask[:, i] = any_alive
        alive = alive & ~invalid
    leftover = alive.sum(-1, dtype=torch.int32)
    sat = torch.stack([dropped_topk, leftover], -1).to(torch.int32)
    return out, out_mask, sat


def batched_nms(pred: torch.Tensor, conf_thres=0.5, nms_thres: float = 0.4,
                max_boxes: int = 512, max_dets: int = 64
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``batched_nms_with_stats`` without the saturation counters:
    (dets (N, max_dets, 7), mask (N, max_dets))."""
    with span("ydt.nms"):
        dets, mask, _ = _nms(pred, conf_thres, nms_thres, max_boxes,
                             max_dets)
    return dets, mask


def roi_nms_mask(boxes_tlwh: torch.Tensor, scores: torch.Tensor,
                 mask: torch.Tensor, max_overlap: float) -> torch.Tensor:
    """Malisiewicz ROI NMS keep-mask over (D,) boxes (deep_sort's
    preprocessing.non_max_suppression): boxes in stable descending-score
    order, overlap = intersection / the candidate's area with +1 extents; a
    kept box removes the later boxes it overlaps by more than
    ``max_overlap``. CPU tensors take the plain version; a CUDA tensor
    launches the kernel or raises."""
    if boxes_tlwh.device.type == "cpu":
        return roi_nms_mask_plain(boxes_tlwh, scores, mask, max_overlap)
    return nms_kernel.roi_nms_cuda(boxes_tlwh, scores, mask, max_overlap)


def roi_nms_mask_plain(boxes_tlwh: torch.Tensor, scores: torch.Tensor,
                       mask: torch.Tensor, max_overlap: float
                       ) -> torch.Tensor:
    """The plain version of ``roi_nms_mask``: a fixed D-step loop of tensor
    ops, no host sync."""
    boxes_tlwh = boxes_tlwh.float()
    scores = scores.float()
    mask = mask.bool()
    x1, y1 = boxes_tlwh[:, 0], boxes_tlwh[:, 1]
    x2 = boxes_tlwh[:, 2] + boxes_tlwh[:, 0]
    y2 = boxes_tlwh[:, 3] + boxes_tlwh[:, 1]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    d = boxes_tlwh.shape[0]
    order = torch.argsort(torch.where(mask, -scores,
                                      torch.full_like(scores, float("inf"))),
                          stable=True)
    w = (torch.minimum(x2[:, None], x2[None, :])
         - torch.maximum(x1[:, None], x1[None, :]) + 1).clamp(min=0.0)
    h = (torch.minimum(y2[:, None], y2[None, :])
         - torch.maximum(y1[:, None], y1[None, :]) + 1).clamp(min=0.0)
    overlap = (w * h) / area[None, :]  # [i, j]: against candidate j's area
    pos = torch.argsort(order, stable=True)  # each box's place in the order
    keep = mask
    for k in range(d):
        i = order[k:k + 1]  # a device index: no read back
        kept = keep.gather(0, i) & mask.gather(0, i)
        kill = (overlap.index_select(0, i)[0] > max_overlap) & mask & (pos > k)
        keep = torch.where(kept, keep & ~kill, keep)
    return keep
