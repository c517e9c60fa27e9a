"""Letterbox preprocessing and box rescaling (port of
yolo_deepsort_tpu/ops/letterbox.py).

``letterbox_batch`` is the plain PyTorch version of the letterbox kernel
(``letterbox_kernel.py``): /255 -> pad to square with zeros -> bilinear
resize with half-pixel centres and no antialias. ``letterbox_nearest_batch``
is the reference's ``interp="nearest"`` (the upstream ``F.interpolate``
default, ``src = floor(dst * side / size)`` on the padded square), which
the reference, too, leaves to plain ops. Frame geometry is static, so the
sampling taps and weights are computed in numpy once per call."""

from __future__ import annotations

import numpy as np
import torch


def _pad_amounts(h: int, w: int):
    """(top, bottom, left, right) zero padding that makes the frame square."""
    d = abs(h - w)
    p1, p2 = d // 2, d - d // 2
    if h <= w:
        return (p1, p2, 0, 0)
    return (0, 0, p1, p2)


def bilinear_taps(side: int, size: int):
    """Padded-square source taps (i0, i1) and the weight ``t`` of i1 for each
    of ``size`` output positions (half-pixel centres, clamped)."""
    coords = (np.arange(size) + 0.5) * (side / size) - 0.5
    i0 = np.clip(np.floor(coords), 0, side - 1).astype(np.int64)
    i1 = np.minimum(i0 + 1, side - 1)
    t = np.clip(coords - i0, 0.0, 1.0).astype(np.float32)
    return i0, i1, t


def letterbox_batch(frames: torch.Tensor, size: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, size, size, 3) in [0, 1], bilinear.

    Computed in float32, then cast to ``out_dtype``."""
    b, h, w, _ = frames.shape
    top, bottom, left, right = _pad_amounts(h, w)
    side = max(h, w)
    img = torch.nn.functional.pad(
        frames.float(), (0, 0, left, right, top, bottom))  # (B, side, side, 3)
    i0, i1, t = bilinear_taps(side, size)
    dev = frames.device
    i0 = torch.as_tensor(i0, device=dev)
    i1 = torch.as_tensor(i1, device=dev)
    tt = torch.as_tensor(t, device=dev)
    wy = tt[None, :, None, None]
    wx = tt[None, None, :, None]
    r0, r1 = img[:, i0], img[:, i1]
    top_row = r0[:, :, i0] * (1 - wx) + r0[:, :, i1] * wx
    bot_row = r1[:, :, i0] * (1 - wx) + r1[:, :, i1] * wx
    return ((top_row * (1 - wy) + bot_row * wy) / 255.0).to(out_dtype)


def letterbox_nearest_batch(frames: torch.Tensor, size: int,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, size, size, 3) in [0, 1], nearest: the
    padded square's pixel ``floor(dst * side / size)`` for each output
    pixel, times the float32 reciprocal of 255 (what XLA compiles the
    reference's jitted ``/ 255.0`` to, so the two agree bit for bit), then
    cast to ``out_dtype``."""
    b, h, w, _ = frames.shape
    top, bottom, left, right = _pad_amounts(h, w)
    side = max(h, w)
    img = torch.nn.functional.pad(frames, (0, 0, left, right, top, bottom))
    src = np.minimum((np.arange(size) * (side / size)).astype(np.int64),
                     side - 1)
    src = torch.as_tensor(src, device=frames.device)
    return (img[:, src][:, :, src].float() * (1 / 255)).to(out_dtype)


def rescale_boxes(boxes_xyxy: torch.Tensor, current_dim: int, orig_h: int,
                  orig_w: int) -> torch.Tensor:
    """Letterboxed network space -> original frame pixels, including the
    reference's ``pad // 2`` floor."""
    m = max(orig_h, orig_w)
    pad_x = max(orig_h - orig_w, 0) * (current_dim / m)
    pad_y = max(orig_w - orig_h, 0) * (current_dim / m)
    unpad_w = current_dim - pad_x
    unpad_h = current_dim - pad_y
    off_x = pad_x // 2
    off_y = pad_y // 2
    x1 = (boxes_xyxy[..., 0] - off_x) / unpad_w * orig_w
    y1 = (boxes_xyxy[..., 1] - off_y) / unpad_h * orig_h
    x2 = (boxes_xyxy[..., 2] - off_x) / unpad_w * orig_w
    y2 = (boxes_xyxy[..., 3] - off_y) / unpad_h * orig_h
    return torch.stack([x1, y1, x2, y2], -1)
