"""Kernels 2 and 6: windowed ReID crops (CUDA ``csrc/crops.cu``).

Kernel 2 replaces the TPU kernel ``yolo_deepsort_tpu/ops/pallas_crops.py``
``_pallas_crops_planar``, kernel 6 its ``_pallas_crops_interleaved`` (both
via ``pallas_crop_and_normalize_batch``). Both are bound on the H100 by the
f32 crop bytes they write (96 KB per box). Kernel 2 reads the window
through L1/L2, four taps per output value; kernel 6 stages each box's
window rows -- contiguous runs of interleaved RGB bytes -- in shared memory
with 16-byte asynchronous copies and resamples from there (see the notes in
the .cu file). As in the reference, ``YDT_CROPS_LAYOUT=interleaved``, read
at the call, selects kernel 6; the default is kernel 2.

``crops_plain`` is the plain PyTorch version of BOTH: the two TPU kernels
round at the same points -- bf16 weights (/255 folded into Wy) and pixels,
f32 sums, the Y-resampled rows rounded to bf16, then the X-resample and the
ImageNet affine -- and so do the two CUDA kernels, which are held to it and
to each other. ``crop_and_normalize_fused`` takes it for CPU tensors only; a
CUDA tensor launches a kernel or raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..kernels import build
from .crops import (
    CROP_H,
    CROP_W,
    REID_MEAN,
    REID_STD,
    _interp_matrix,
    crop_window_bounds,
)

launches = 0  # kernel 2's launches; only its launch below adds to it
launches_interleaved = 0  # kernel 6's, likewise

# ImageNet affine as the TPU kernel rounds it: x * f32(1/std) - f32(mean/std)
# with both constants formed in double
_INV_STD = np.asarray([1.0 / float(s) for s in REID_STD], np.float32)
_MEAN_OVER_STD = np.asarray(
    [float(m) * (1.0 / float(s)) for m, s in zip(REID_MEAN, REID_STD)],
    np.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def crops_plain(frames: torch.Tensor, boxes_xyxy: torch.Tensor, win_h: int,
                win_w: int) -> torch.Tensor:
    """(B, H, W, 3) uint8, (B, D, 4) clipped xyxy -> (B, D, 128, 64, 3) f32."""
    b, h, w, _ = frames.shape
    d = boxes_xyxy.shape[1]
    win_h, win_w = min(int(win_h), h), min(int(win_w), w)
    x1, y1, x2, y2 = crop_window_bounds(boxes_xyxy.reshape(b * d, 4), h, w)
    oy = y1.clamp(0, h - win_h)
    ox = x1.clamp(0, w - win_w)
    wy = _bf16(_interp_matrix(y1, y2, win_h, CROP_H, torch.float32,
                              offsets=oy) / 255.0)
    wx = _bf16(_interp_matrix(x1, x2, win_w, CROP_W, torch.float32,
                              offsets=ox))
    dev = frames.device
    frame_of = torch.arange(b, device=dev).repeat_interleave(d)
    rows = (oy[:, None] + torch.arange(win_h, device=dev)).long()
    cols = (ox[:, None] + torch.arange(win_w, device=dev)).long()
    win = frames[frame_of[:, None, None], rows[:, :, None], cols[:, None, :]]
    rows = _bf16(torch.einsum("dyh,dhwc->dywc", wy, win.float()))
    crop = torch.einsum("dywc,dxw->dyxc", rows, wx)
    inv = torch.as_tensor(_INV_STD, device=frames.device)
    mos = torch.as_tensor(_MEAN_OVER_STD, device=frames.device)
    out = crop * inv - mos
    return out.reshape(b, d, CROP_H, CROP_W, 3)


def crop_and_normalize_fused(frames: torch.Tensor, boxes_xyxy: torch.Tensor,
                             win_h: int, win_w: int) -> torch.Tensor:
    """Windowed crops of a frame batch: a CUDA kernel for CUDA tensors
    (kernel 6 under ``YDT_CROPS_LAYOUT=interleaved``, else kernel 2),
    ``crops_plain`` for CPU tensors."""
    if frames.device.type == "cpu":
        return crops_plain(frames, boxes_xyxy, win_h, win_w)
    interleaved = os.environ.get("YDT_CROPS_LAYOUT", "planar") == "interleaved"
    return crops_cuda(frames, boxes_xyxy, win_h, win_w,
                      interleaved=interleaved)


def crops_cuda(frames: torch.Tensor, boxes_xyxy: torch.Tensor, win_h: int,
               win_w: int, interleaved: bool = False) -> torch.Tensor:
    """Launch kernel 2 or, with ``interleaved``, kernel 6."""
    build.require_cuda("crops", frames, boxes_xyxy)
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError("crops: expected (B, H, W, 3) uint8 frames, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    b, h, w, _ = frames.shape
    if (boxes_xyxy.dtype != torch.float32 or boxes_xyxy.dim() != 3
            or boxes_xyxy.shape[0] != b or boxes_xyxy.shape[2] != 4):
        raise ValueError("crops: expected (B, D, 4) float32 boxes, got "
                         f"{tuple(boxes_xyxy.shape)} {boxes_xyxy.dtype}")
    d = boxes_xyxy.shape[1]
    win_h, win_w = min(int(win_h), h), min(int(win_w), w)
    out = torch.empty((b, d, CROP_H, CROP_W, 3), dtype=torch.float32,
                      device=frames.device)
    lib = build.load()
    fn = lib.ydt_crops_interleaved if interleaved else lib.ydt_crops
    err = fn(
        frames.data_ptr(), boxes_xyxy.data_ptr(), out.data_ptr(), b, d, h, w,
        win_h, win_w, torch.cuda.current_stream(frames.device).cuda_stream)
    build.check_launch("crops", err)
    global launches, launches_interleaved
    if interleaved:
        launches_interleaved += 1
    else:
        launches += 1
    return out
