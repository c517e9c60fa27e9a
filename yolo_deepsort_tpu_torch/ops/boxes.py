"""Box-format conversions and IoU (port of yolo_deepsort_tpu/ops/boxes.py).

  xyxy : x1, y1, x2, y2      xywh : cx, cy, w, h
  tlwh : x, y, w, h          xyah : cx, cy, a=w/h, h
"""

from __future__ import annotations

import torch


def xywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_xywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def xywh_to_tlwh(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, w, h], -1)


def tlwh_to_xyah(b: torch.Tensor) -> torch.Tensor:
    """Guarded aspect: all-zero padded rows map to a=0, not NaN."""
    x, y, w, h = b.unbind(-1)
    pos = h > 0
    a = torch.where(pos, w / torch.where(pos, h, torch.ones_like(h)),
                    torch.zeros_like(h))
    return torch.stack([x + w / 2, y + h / 2, a, h], -1)


def xyah_to_tlwh(b: torch.Tensor) -> torch.Tensor:
    cx, cy, a, h = b.unbind(-1)
    w = a * h
    return torch.stack([cx - w / 2, cy - h / 2, w, h], -1)


def tlwh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    x, y, w, h = b.unbind(-1)
    return torch.stack([x, y, x + w, y + h], -1)


def iou_xyxy(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-16):
    """Pairwise IoU of (..., M, 4) and (..., N, 4) corner boxes -> (..., M, N)
    with ``eps`` in the denominator."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + eps)


def iou_tlwh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of tlwh boxes (no eps; zero-area pairs give 0)."""
    ax = tlwh_to_xyxy(a)[..., :, None, :]
    bx = tlwh_to_xyxy(b)[..., None, :, :]
    ix1 = torch.maximum(ax[..., 0], bx[..., 0])
    iy1 = torch.maximum(ax[..., 1], bx[..., 1])
    ix2 = torch.minimum(ax[..., 2], bx[..., 2])
    iy2 = torch.minimum(ax[..., 3], bx[..., 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    area_a = a[..., :, None, 2] * a[..., :, None, 3]
    area_b = b[..., None, :, 2] * b[..., None, :, 3]
    denom = area_a + area_b - inter
    pos = denom > 0
    return torch.where(pos, inter / torch.where(pos, denom,
                                                torch.ones_like(denom)),
                       torch.zeros_like(denom))
