"""The batched NMS and the ROI NMS as CUDA kernels (``csrc/nms.cu``).

Replaces no Pallas kernel: the reference's NMS is XLA work inside its jitted
stages (``yolo_deepsort_tpu/ops/nms.py`` ``_nms_single``, a ``top_k`` and a
``while_loop``; ``roi_nms_mask``, a ``fori_loop``). Their plain versions,
``ops/nms.py`` ``batched_nms_with_stats_plain`` and ``roi_nms_mask_plain``,
loop on the host, about ten launches a greedy step; each function here is
one C entry. ``nms_cuda`` runs two kernels in it: a pass over the rows that
writes one sort key a row, then one block an image that selects, sorts and
runs the greedy loop. Bound on the H100 by bytes: the first pass reads the
predictions once.

``ops/nms.py``'s public functions take the plain versions for CPU tensors
only; a CUDA tensor launches these or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build

launches = 0  # ydt_nms calls (each runs both its kernels); only nms_cuda adds
roi_launches = 0  # ydt_roi_nms calls; only roi_nms_cuda adds

MAX_BOXES = 1024  # candidates one block holds (csrc/nms.cu kMaxK)
MAX_ROI_BOXES = 1024  # boxes of one ROI NMS block (kMaxRoi)
ROWS_PER_TILE = 64  # rows of one block of the key pass (kRowsPerTile)
MAX_IMAGES = 65535  # the key pass's grid height
# merged boxes against the plain version: weighted sums of up to max_boxes
# terms summed in another order (about k f32 ulps of the box scale at
# worst), within MERGE_TOL x the largest |finite merged coordinate| (>= 1)
MERGE_TOL = 1e-5


def nms_cuda(pred: torch.Tensor, conf_thres=0.5, nms_thres: float = 0.4,
             max_boxes: int = 512, max_dets: int = 64
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``batched_nms_with_stats`` on the card: (dets (N, max_dets, 7), mask
    (N, max_dets) bool, sat (N, 2) int32). No host sync, no allocation whose
    size depends on the data, the current stream."""
    build.require_cuda("nms", pred, contiguous=False)
    if pred.dim() != 3 or pred.shape[-1] < 6:
        raise ValueError("nms: expected (N, B, 5 + C) predictions with C >= "
                         f"1, got {tuple(pred.shape)}")
    pred = pred.float().contiguous()
    n, nb, ncols = pred.shape
    k = min(max_boxes, nb)
    if not 1 <= k <= MAX_BOXES:
        raise ValueError(f"nms: min(max_boxes, B) = {k} candidates; one "
                         f"block holds 1 to {MAX_BOXES}")
    if not 1 <= n <= MAX_IMAGES or max_dets < 0:
        raise ValueError(f"nms: {n} images, max_dets {max_dets}")
    dev = pred.device
    thr_ptr, thr_scalar = None, 0.0
    if isinstance(conf_thres, (float, int)):
        thr_scalar = float(conf_thres)
    else:
        thr = torch.as_tensor(conf_thres, dtype=torch.float32, device=dev)
        thr = (thr.expand(n) if thr.dim() == 0 else thr).contiguous()
        if thr.shape != (n,):
            raise ValueError(f"nms: thresholds of shape {tuple(thr.shape)} "
                             f"for {n} images")
        thr_ptr = thr.data_ptr()
    ntiles = -(-nb // ROWS_PER_TILE)
    keys = torch.empty((n, nb), dtype=torch.int64, device=dev)
    tile_valid = torch.empty((n, ntiles), dtype=torch.int32, device=dev)
    dets = torch.empty((n, max_dets, 7), dtype=torch.float32, device=dev)
    mask = torch.empty((n, max_dets), dtype=torch.bool, device=dev)
    sat = torch.empty((n, 2), dtype=torch.int32, device=dev)
    err = build.load().ydt_nms(
        pred.data_ptr(), thr_ptr, thr_scalar, keys.data_ptr(),
        tile_valid.data_ptr(), dets.data_ptr(), mask.data_ptr(),
        sat.data_ptr(), n, nb, ncols, k, max_dets, float(nms_thres),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("nms", err)
    global launches
    launches += 1
    return dets, mask, sat


def roi_nms_cuda(boxes_tlwh: torch.Tensor, scores: torch.Tensor,
                 mask: torch.Tensor, max_overlap: float) -> torch.Tensor:
    """``roi_nms_mask`` on the card: the (D,) bool keep mask, one block."""
    build.require_cuda("roi_nms", boxes_tlwh, scores, mask, contiguous=False)
    boxes = boxes_tlwh.float().contiguous()
    scores = scores.float().contiguous()
    mask = mask.bool().contiguous()
    d = boxes.shape[0]
    if boxes.shape != (d, 4) or scores.shape != (d,) or mask.shape != (d,):
        raise ValueError(f"roi_nms: boxes {tuple(boxes.shape)}, scores "
                         f"{tuple(scores.shape)}, mask {tuple(mask.shape)}")
    if not 1 <= d <= MAX_ROI_BOXES:
        raise ValueError(f"roi_nms: {d} boxes; one block holds 1 to "
                         f"{MAX_ROI_BOXES}")
    keep = torch.empty((d,), dtype=torch.bool, device=boxes.device)
    err = build.load().ydt_roi_nms(
        boxes.data_ptr(), scores.data_ptr(), mask.data_ptr(), keep.data_ptr(),
        d, float(max_overlap),
        torch.cuda.current_stream(boxes.device).cuda_stream)
    build.check_launch("roi_nms", err)
    global roi_launches
    roi_launches += 1
    return keep


def mismatch(got, want) -> Tuple[str, float]:
    """("", max |merged box error|) when the kernel's (dets, mask, sat) hold
    to the plain version's: the mask (keep set and order), the counters and
    the obj / cls_conf / cls columns exactly equal, NaN merges where the
    plain version has them, the rest within MERGE_TOL; else (what differs,
    the error or NaN)."""
    gd, gm, gs = (t.cpu() for t in got)
    wd, wm, ws = (t.cpu() for t in want)
    if not torch.equal(gm, wm):
        return "masks (keep set or order) differ", float("nan")
    if not torch.equal(gs, ws):
        return f"sat {gs.tolist()} != {ws.tolist()}", float("nan")
    if not torch.equal(gd[..., 4:], wd[..., 4:]):
        return "obj / cls_conf / cls columns differ", float("nan")
    a, b = gd[..., :4], wd[..., :4]
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return "NaN merged boxes differ", float("nan")
    fin = torch.isfinite(b)
    if not bool(fin.any()):
        return "", 0.0
    err = float((a - b)[fin].abs().max())
    scale = max(1.0, float(b[fin].abs().max()))
    if not err <= MERGE_TOL * scale:
        return f"merged boxes off by {err} (scale {scale})", err
    return "", err
