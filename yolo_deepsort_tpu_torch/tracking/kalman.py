"""Batched Kalman filter on the DeepSORT state (port of
yolo_deepsort_tpu/tracking/kalman.py).

Every function takes any number of leading batch dims: mean (..., 8),
cov (..., 8, 8), measurements xyah (..., 4). Constant-velocity model with
dt = 1; F P F^T is applied blockwise. float32 throughout.

The 4x4 Cholesky, the triangular solves and the small products are
unrolled into elementwise ops in the fused tracker kernel's order
(``csrc/tracker.cu``): the same operation order on every device, and no
``torch.linalg`` result check that reads the device back (on the card that
check would synchronize the stream every frame)."""

from __future__ import annotations

import torch

CHI2INV95_4DOF = 9.4877  # chi-square 0.95 gate, 4 degrees of freedom

_STD_W_POS = 1.0 / 20
_STD_W_VEL = 1.0 / 160
# height floor for the std scaling: keeps padded all-zero slots Cholesky-safe
_H_FLOOR = 1e-2


def _diag_embed(std: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(std * std)


def initiate(measurement: torch.Tensor):
    """(..., 4) xyah -> (mean (..., 8), cov (..., 8, 8))."""
    mean = torch.cat([measurement, torch.zeros_like(measurement)], -1)
    h = measurement[..., 3].clamp(min=_H_FLOOR)
    std = torch.stack([
        2 * _STD_W_POS * h, 2 * _STD_W_POS * h, torch.full_like(h, 1e-2),
        2 * _STD_W_POS * h, 10 * _STD_W_VEL * h, 10 * _STD_W_VEL * h,
        torch.full_like(h, 1e-5), 10 * _STD_W_VEL * h], -1)
    return mean, _diag_embed(std)


def _motion_std(h: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        _STD_W_POS * h, _STD_W_POS * h, torch.full_like(h, 1e-2),
        _STD_W_POS * h, _STD_W_VEL * h, _STD_W_VEL * h,
        torch.full_like(h, 1e-5), _STD_W_VEL * h], -1)


def predict(mean: torch.Tensor, cov: torch.Tensor):
    """One step: mean' = [pos + vel, vel]; P' = F P F^T + Q."""
    h = mean[..., 3].clamp(min=_H_FLOOR)
    q = _diag_embed(_motion_std(h))
    new_mean = torch.cat([mean[..., :4] + mean[..., 4:], mean[..., 4:]], -1)
    a, b = cov[..., :4, :4], cov[..., :4, 4:]
    c = cov[..., 4:, 4:]
    top_left = a + b + b.transpose(-1, -2) + c
    top_right = b + c
    new_cov = torch.cat([
        torch.cat([top_left, top_right], -1),
        torch.cat([top_right.transpose(-1, -2), c], -1)], -2)
    return new_mean, new_cov + q


def project(mean: torch.Tensor, cov: torch.Tensor):
    """State -> measurement space: (mean4, S = H P H^T + R)."""
    h = mean[..., 3].clamp(min=_H_FLOOR)
    std = torch.stack([_STD_W_POS * h, _STD_W_POS * h,
                       torch.full_like(h, 1e-1), _STD_W_POS * h], -1)
    return mean[..., :4], cov[..., :4, :4] + _diag_embed(std)


def _chol4(s: torch.Tensor):
    """Lower Cholesky factor of (..., 4, 4) SPD matrices, unrolled, from
    their lower triangle: (l00, l10, l20, l30, l11, l21, l31, l22, l32, l33),
    each (...). Elementwise ops in the tracker kernel's order (``chol4``);
    nothing is read back to the host, where ``torch.linalg`` checks its
    results."""
    def g(x):
        return torch.sqrt(x.clamp(min=1e-20))

    e = [[s[..., i, j] for j in range(4)] for i in range(4)]
    l00 = g(e[0][0])
    l10, l20, l30 = e[1][0] / l00, e[2][0] / l00, e[3][0] / l00
    l11 = g(e[1][1] - l10 * l10)
    l21 = (e[2][1] - l20 * l10) / l11
    l31 = (e[3][1] - l30 * l10) / l11
    l22 = g(e[2][2] - l20 * l20 - l21 * l21)
    l32 = (e[3][2] - l30 * l20 - l31 * l21) / l22
    l33 = g(e[3][3] - l30 * l30 - l31 * l31 - l32 * l32)
    return l00, l10, l20, l30, l11, l21, l31, l22, l32, l33


def _forward4(L, b0, b1, b2, b3):
    """Solve L y = b (L from ``_chol4``, broadcast against b)."""
    l00, l10, l20, l30, l11, l21, l31, l22, l32, l33 = L
    y0 = b0 / l00
    y1 = (b1 - l10 * y0) / l11
    y2 = (b2 - l20 * y0 - l21 * y1) / l22
    y3 = (b3 - l30 * y0 - l31 * y1 - l32 * y2) / l33
    return y0, y1, y2, y3


def _dot(terms):
    """Sum of products, left to right (a fixed rounding order)."""
    acc = terms[0][0] * terms[0][1]
    for a, b in terms[1:]:
        acc = acc + a * b
    return acc


def update(mean: torch.Tensor, cov: torch.Tensor, measurement: torch.Tensor):
    """Kalman correction: gain = P H^T S^-1 through the Cholesky factor of
    S, in the tracker kernel's operation order."""
    proj_mean, s = project(mean, cov)
    lower = [[s[..., max(i, j), min(i, j)] for j in range(4)]
             for i in range(4)]  # S from its lower triangle, symmetric
    L = [x[..., None] for x in _chol4(s)]  # broadcast over the 8 gain rows
    y = _forward4(L, *(cov[..., :, k] for k in range(4)))
    l00, l10, l20, l30, l11, l21, l31, l22, l32, l33 = L
    x3 = y[3] / l33
    x2 = (y[2] - l32 * x3) / l22
    x1 = (y[1] - l21 * x2 - l31 * x3) / l11
    x0 = (y[0] - l10 * x1 - l20 * x2 - l30 * x3) / l00
    gain = [x0, x1, x2, x3]  # 4 x (..., 8): gain[k][..., i] = K[i, k]
    innovation = measurement - proj_mean
    new_mean = mean + _dot([(gain[k], innovation[..., k, None])
                            for k in range(4)])
    # m[k] = (K S)[:, k], then P - (K S) K^T
    m = [_dot([(gain[q], lower[q][k][..., None]) for q in range(4)])
         for k in range(4)]
    new_cov = cov - _dot([(m[k][..., :, None], gain[k][..., None, :])
                          for k in range(4)])
    return new_mean, new_cov


def gating_distance_matrix(mean: torch.Tensor, cov: torch.Tensor,
                           measurements: torch.Tensor) -> torch.Tensor:
    """Squared Mahalanobis distances: mean (..., T, 8), cov (..., T, 8, 8),
    measurements (..., D, 4) -> (..., T, D)."""
    proj_mean, s = project(mean, cov)
    L = [x[..., None] for x in _chol4(s)]  # (..., T, 1): broadcast over D
    d = measurements[..., None, :, :] - proj_mean[..., :, None, :]
    y = _forward4(L, *(d[..., k] for k in range(4)))
    return _dot([(v, v) for v in y])


def gating_distance(mean: torch.Tensor, cov: torch.Tensor,
                    measurements: torch.Tensor,
                    only_position: bool = False) -> torch.Tensor:
    """Squared Mahalanobis distance of (..., N, 4) xyah measurements to one
    state, mean (..., 8) and cov (..., 8, 8) -> (..., N).

    ``only_position`` takes (cx, cy) alone, the 2-dof gate: the leading 2x2
    block of S's Cholesky factor is the factor of S[:2, :2], so the first
    two terms of the forward solve are that gate's."""
    proj_mean, s = project(mean, cov)
    L = [x[..., None] for x in _chol4(s)]  # (..., 1): broadcast over N
    d = measurements - proj_mean[..., None, :]
    y = _forward4(L, *(d[..., k] for k in range(4)))
    return _dot([(v, v) for v in (y[:2] if only_position else y)])
