"""Batched crop-resize-normalize for the ReID embed (port of
yolo_deepsort_tpu/ops/crops.py).

Bilinear resampling as two contractions per box, ``crop = Wy @ frame @
Wx^T`` per channel, with interpolation matrices whose rows hold the
half-pixel-centre, clamped, normalized triangle weights. The windowed form
contracts a (win_h, win_w) source window anchored at the box corner instead
of the full frame; it is bit-identical to the dense form whenever the box's
integer crop fits the window, because its weights are computed in absolute
frame coordinates (``offsets``).
"""

from __future__ import annotations

import numpy as np
import torch

REID_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
REID_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
CROP_H, CROP_W = 128, 64


def _interp_matrix(starts, ends, limit: int, out_size: int, dtype,
                   offsets=None):
    """(D, out_size, limit) triangle-kernel weights; column j of matrix d
    weighs source pixel ``offsets[d] + j`` (0 + j without offsets)."""
    dev = starts.device
    startf = starts.float()
    span = (ends - starts).float()
    r = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) / out_size
    coords = startf[:, None] + r[None, :] * span[:, None] - 0.5
    coords = torch.minimum(
        torch.maximum(coords, startf[:, None]),
        torch.maximum(ends.float()[:, None] - 1.0, startf[:, None]))
    k = torch.arange(limit, dtype=torch.float32, device=dev)
    if offsets is not None:
        k = offsets.float()[:, None, None] + k[None, None, :]
    else:
        k = k[None, None, :]
    w = (1.0 - (coords[:, :, None] - k).abs()).clamp(0.0, 1.0)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-6)
    return w.to(dtype)


def crop_window_bounds(boxes_xyxy, frame_h: int, frame_w: int):
    """Integer crop corners (x1, y1, x2, y2), x2/y2 exclusive, >= 1 px."""
    b = boxes_xyxy.to(torch.int32)  # truncation toward zero, as astype
    x1 = b[..., 0].clamp(0, frame_w - 1)
    y1 = b[..., 1].clamp(0, frame_h - 1)
    x2 = torch.minimum(torch.maximum(b[..., 2], x1 + 1),
                       torch.full_like(x1, frame_w))
    y2 = torch.minimum(torch.maximum(b[..., 3], y1 + 1),
                       torch.full_like(y1, frame_h))
    return x1, y1, x2, y2


def device_constant(values, device) -> torch.Tensor:
    """A small float32 vector on ``device``, made by fills: a tensor built
    from host data would be a host-to-device copy, which synchronizes the
    stream."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                   device=device) for v in values])


def true_divisor(value: float, device) -> torch.Tensor:
    """A 0-dim float32 divisor on ``device``. PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which rounds apart from the
    CPU's and the JAX package's division in most values; a divisor tensor
    on the device keeps the division IEEE (a fill: no host copy)."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _normalize(crops):
    mean = device_constant(REID_MEAN, crops.device)
    std = device_constant(REID_STD, crops.device)
    return (crops / true_divisor(255.0, crops.device) - mean) / std


def crop_and_normalize(frame_rgb, boxes_xyxy, compute_dtype=torch.float32):
    """(H, W, 3) frame, (D, 4) clipped boxes -> (D, 128, 64, 3) float32."""
    h, w = frame_rgb.shape[0], frame_rgb.shape[1]
    x1, y1, x2, y2 = crop_window_bounds(boxes_xyxy, h, w)
    wy = _interp_matrix(y1, y2, h, CROP_H, compute_dtype)
    wx = _interp_matrix(x1, x2, w, CROP_W, compute_dtype)
    img = frame_rgb.to(compute_dtype)
    # X then Y, f32 sums, the intermediate rounded to compute_dtype
    tmp = torch.einsum("dxw,hwc->dhxc", wx.float(), img.float())
    tmp = tmp.to(compute_dtype).float()
    return _normalize(torch.einsum("dyh,dhxc->dyxc", wy.float(), tmp))


def crop_and_normalize_batch(frames, boxes_xyxy,
                             compute_dtype=torch.float32):
    """crop_and_normalize of a frame batch as one set of ops: (B, H, W, 3)
    frames, (B, D, 4) clipped boxes -> (B, D, 128, 64, 3) float32. At bf16
    every sum has two non-zero terms whose products are exact, so it equals
    the per-frame form bit for bit; it is the plain version of the dense
    crop kernel (``crops_kernel.crop_and_normalize_dense``). Memory: its X
    pass holds a (B, D, H, 64, 3) f32 intermediate, B times the per-frame
    form's -- 265 MB at 8 frames of 1080p with 40 boxes each."""
    b, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    d = boxes_xyxy.shape[1]
    x1, y1, x2, y2 = crop_window_bounds(boxes_xyxy.reshape(b * d, 4), h, w)
    wy = _interp_matrix(y1, y2, h, CROP_H, compute_dtype)
    wx = _interp_matrix(x1, x2, w, CROP_W, compute_dtype)
    img = frames.to(compute_dtype)
    # X then Y, f32 sums, the intermediate rounded to compute_dtype
    tmp = torch.einsum("bdxw,bhwc->bdhxc",
                       wx.float().reshape(b, d, CROP_W, w), img.float())
    tmp = tmp.to(compute_dtype).float()
    crops = torch.einsum("bdyh,bdhxc->bdyxc",
                         wy.float().reshape(b, d, CROP_H, h), tmp)
    return _normalize(crops)


def crop_and_normalize_windowed(frame_rgb, boxes_xyxy, win_h: int, win_w: int,
                                compute_dtype=torch.float32):
    """crop_and_normalize through a fixed (win_h, win_w) source window per
    box; exact when every box's integer crop fits the window."""
    h, w = frame_rgb.shape[0], frame_rgb.shape[1]
    win_h, win_w = min(int(win_h), h), min(int(win_w), w)
    x1, y1, x2, y2 = crop_window_bounds(boxes_xyxy, h, w)
    ox = x1.clamp(0, w - win_w)
    oy = y1.clamp(0, h - win_h)
    windows = gather_windows(frame_rgb, oy, ox, win_h, win_w)
    wy = _interp_matrix(y1, y2, win_h, CROP_H, compute_dtype, offsets=oy)
    wx = _interp_matrix(x1, x2, win_w, CROP_W, compute_dtype, offsets=ox)
    winc = windows.to(compute_dtype)
    tmp = torch.einsum("dxw,dhwc->dhxc", wx.float(), winc.float())
    tmp = tmp.to(compute_dtype).float()
    crops = torch.einsum("dyh,dhxc->dyxc", wy.float(), tmp)
    return _normalize(crops)


def gather_windows(frame_rgb, oy, ox, win_h: int, win_w: int):
    """(D, win_h, win_w, 3) windows of one (H, W, 3) frame at (oy, ox)."""
    dev = frame_rgb.device
    rows = oy[:, None] + torch.arange(win_h, device=dev)[None, :]
    cols = ox[:, None] + torch.arange(win_w, device=dev)[None, :]
    return frame_rgb[rows[:, :, None].long(), cols[:, None, :].long()]
