"""The crop kernels (CUDA ``csrc/crops.cu`` on the staged main loop of
``csrc/crops_stage.cuh``): kernels 2 and 6, windowed ReID crops, and the
dense crops of the K=1 step.

Kernel 2 replaces the TPU kernel ``yolo_deepsort_tpu/ops/pallas_crops.py``
``_pallas_crops_planar``, kernel 6 its ``_pallas_crops_interleaved`` (both
via ``pallas_crop_and_normalize_batch``); the dense entry replaces the XLA
crops of ``yolo_deepsort_tpu/ops/crops.py`` and the K=1 step's window guard.
All three are bound on the H100 by the f32 crop bytes they write (96 KB per
box): one block per (box, strip of output rows) stages the source rows its
taps name through a ring of shared-memory stages and writes its strip with
16-byte stores (see the notes in the .cuh file). As in the reference,
``YDT_CROPS_LAYOUT=interleaved``, read at the call, selects kernel 6; the
default is kernel 2.

``crops_plain`` is the plain PyTorch version of kernels 2 and 6: the two TPU
kernels round at the same points -- bf16 weights (/255 folded into Wy) and
pixels, f32 sums, the Y-resampled rows rounded to bf16, then the X-resample
and the ImageNet affine -- and so do the two CUDA kernels, which are held to
it and to each other. The dense entry rounds in the XLA order instead (X
first, ``(x / 255 - mean) / std``); its plain version is the batched
``ops/crops.py`` ``crop_and_normalize_batch`` at bf16. The wrappers take
the plain versions for CPU tensors only; a CUDA tensor launches a kernel or
raises.
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
    crop_and_normalize_batch,
    crop_window_bounds,
    true_divisor,
)

launches = 0  # kernel 2's launches; only its launch below adds to it
launches_interleaved = 0  # kernel 6's, likewise
launches_dense = 0  # the dense entry's, likewise

# output rows per block of each entry, as csrc/crops_stage.cuh builds them
# (its CROPS_STRIP_* defaults; a tool reads them here to count blocks)
STRIP_ROWS = {"planar": 64, "interleaved": 64, "dense": 32}


def strip_defines(rows: int) -> dict:
    """The defines of a build whose three entries all take strips of
    ``rows`` output rows (``build.load_variants("crops", ...)``)."""
    return {f"CROPS_STRIP_{entry.upper()}": int(rows) for entry in STRIP_ROWS}


# ImageNet affine as the TPU kernel rounds it: x * f32(1/std) - f32(mean/std)
# with both constants formed in double
_INV_STD = np.asarray([1.0 / float(s) for s in REID_STD], np.float32)
_MEAN_OVER_STD = np.asarray(
    [float(m) * (1.0 / float(s)) for m, s in zip(REID_MEAN, REID_STD)],
    np.float32)


def crops_pallas_order_supported(h: int, w: int) -> bool:
    """The reference's gate on its windowed crop kernel (copied from
    ``yolo_deepsort_tpu/ops/pallas_crops.py`` ``pallas_crops_supported``):
    only frames with H % 8 == 0 and W % 128 == 0 take kernels 2 and 6, and
    so round in the Pallas order; on any other frame the reference makes
    its windowed crops in the dense (XLA) order."""
    return h % 8 == 0 and w % 128 == 0


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
                              offsets=oy) / true_divisor(255.0, frames.device))
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


def _check_inputs(name, frames, boxes_xyxy):
    build.require_cuda(name, frames, boxes_xyxy)
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"{name}: expected (B, H, W, 3) uint8 frames, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    if (boxes_xyxy.dtype != torch.float32 or boxes_xyxy.dim() != 3
            or boxes_xyxy.shape[0] != frames.shape[0]
            or boxes_xyxy.shape[2] != 4):
        raise ValueError(f"{name}: expected (B, D, 4) float32 boxes, got "
                         f"{tuple(boxes_xyxy.shape)} {boxes_xyxy.dtype}")


def crops_cuda(frames: torch.Tensor, boxes_xyxy: torch.Tensor, win_h: int,
               win_w: int, interleaved: bool = False,
               lib=None) -> torch.Tensor:
    """Launch kernel 2 or, with ``interleaved``, kernel 6 (from ``lib``, a
    ``build.load_variants`` build; None: the package's library)."""
    _check_inputs("crops", frames, boxes_xyxy)
    b, h, w, _ = frames.shape
    d = boxes_xyxy.shape[1]
    win_h, win_w = min(int(win_h), h), min(int(win_w), w)
    out = torch.empty((b, d, CROP_H, CROP_W, 3), dtype=torch.float32,
                      device=frames.device)
    lib = build.load() if lib is None else lib
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


def crop_and_normalize_dense(frames: torch.Tensor,
                             boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """The bf16 crops of a frame batch in the dense (XLA) order over the
    whole frame: (B, H, W, 3) uint8, (B, D, 4) clipped xyxy -> (B, D, 128,
    64, 3) f32. The dense entry for CUDA tensors,
    ``crop_and_normalize_batch`` at bf16 for CPU tensors."""
    if frames.device.type == "cpu":
        return crop_and_normalize_batch(frames, boxes_xyxy, torch.bfloat16)
    return crops_dense_cuda(frames, boxes_xyxy)


def crops_dense_cuda(frames: torch.Tensor, boxes_xyxy: torch.Tensor,
                     lib=None) -> torch.Tensor:
    """Launch the dense entry (``lib`` as in ``crops_cuda``)."""
    _check_inputs("crops_dense", frames, boxes_xyxy)
    b, h, w, _ = frames.shape
    d = boxes_xyxy.shape[1]
    out = torch.empty((b, d, CROP_H, CROP_W, 3), dtype=torch.float32,
                      device=frames.device)
    lib = build.load() if lib is None else lib
    err = lib.ydt_crops_dense(
        frames.data_ptr(), boxes_xyxy.data_ptr(), out.data_ptr(), b, d, h, w,
        torch.cuda.current_stream(frames.device).cuda_stream)
    build.check_launch("crops_dense", err)
    global launches_dense
    launches_dense += 1
    return out
