"""Kernels 4 and 5: the JV assignment solver (CUDA ``csrc/assignment.cu``,
with the stage runner of ``csrc/jv_stage.cuh``).

Replaces two TPU kernels of ``yolo_deepsort_tpu/ops/assignment_pallas.py``:

* K4 ``_jv_kernel`` (via ``solve_cascade_assignment_pallas``): one
  matching-cascade sweep -> ``solve_cascade_assignment_fused``;
* K5 ``_two_stage_kernel`` (via ``solve_two_stage_pallas``): DeepSORT's
  two-stage match in one launch -> ``solve_two_stage_assignment_fused``,
  which the tracker step (``tracking/tracker.py``) calls once per frame for
  all streams.

Bound on the H100 by latency: every augmentation is a chain of block-wide
min-reductions, so each stream's solve runs in one block with its JV
vectors in shared memory (see the note at the top of the .cu file).

As in the reference, the cheap vectorized prep -- eligibility, the ``_BIG``
real block, the private dummies at ``max_distance + 2e-5``, the
``_LEVEL_INACTIVE`` levels, the stable level-major argsort and the
active-row counts -- is framework ops (``prep``), batched over streams on
the device; it reads nothing back to the host.

Both solvers take a cost of shape (S, R, C) or (R, C). They take the plain
version (``ops/assignment.py``, one stream at a time) for CPU tensors only;
a CUDA tensor launches the kernel or raises. ``max_distance`` is a float or
a per-stream (S,) tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build
from .assignment import (
    _BIG,
    _LEVEL_INACTIVE,
    solve_cascade_assignment,
    solve_two_stage_assignment,
)

cascade_launches = 0  # K4 launches; only its launch below adds to it
two_stage_launches = 0  # K5 launches; only its launch below adds to it


def _thresholds(max_distance, s: int, device) -> torch.Tensor:
    """(S,) float32 thresholds; a float becomes a fill, not a host copy."""
    if isinstance(max_distance, torch.Tensor):
        t = max_distance.to(device=device, dtype=torch.float32)
        return t.expand(s) if t.dim() == 0 else t.reshape(s)
    return torch.full((s,), float(max_distance), dtype=torch.float32,
                      device=device)


def prep(cost, row_levels, row_mask, col_mask, max_distance):
    """Framework side before the kernel, batched: (S, R, C) costs ->
    (aug (S, R, C + R) f32, order (S, R) i32, levels (S, R) i32,
    n_active (S,) i32), as the reference's ``_prep`` without its padding."""
    cost = cost.float()
    s, r, c = cost.shape
    dev = cost.device
    row_mask, col_mask = row_mask.bool(), col_mask.bool()
    maxd = _thresholds(max_distance, s, dev)[:, None, None]
    eligible = (row_mask[:, :, None] & col_mask[:, None, :]
                & (cost <= maxd))
    real = torch.where(eligible, cost, torch.full_like(cost, _BIG))
    eye = torch.eye(r, dtype=torch.bool, device=dev)[None]
    dummy = torch.where(eye, maxd + 2e-5,
                        torch.full((s, r, r), _BIG, device=dev))
    aug = torch.cat([real, dummy], 2).contiguous()
    levels = torch.where(row_mask, row_levels.to(torch.int32),
                         torch.full_like(row_mask, _LEVEL_INACTIVE,
                                         dtype=torch.int32))
    order = torch.argsort(levels, dim=-1, stable=True).to(torch.int32)
    n_active = row_mask.sum(-1, dtype=torch.int32)
    return aug, order.contiguous(), levels.contiguous(), n_active


def _batched(cost, *rows):
    """Add a stream axis to an unbatched (R, C) problem."""
    if cost.dim() == 3:
        return True, cost, rows
    return False, cost[None], tuple(v[None] for v in rows)


def _matches(assign, rows, c):
    """Augmented-column assignment -> real column per row, or -1."""
    hit = (assign >= 0) & (assign < c) & rows.bool()
    return torch.where(hit, assign, torch.full_like(assign, -1)).to(
        torch.int32)


def solve_cascade_assignment_fused(cost, row_levels, row_mask, col_mask,
                                   max_distance) -> torch.Tensor:
    """Matching cascade per stream: (S, R, C) -> (S, R) int32 matched
    column per row, or -1 (unbatched in, unbatched out)."""
    batched, cost, (row_levels, row_mask) = _batched(cost, row_levels,
                                                     row_mask)
    col_mask = col_mask if batched else col_mask[None]
    if cost.device.type == "cpu":
        maxd = _thresholds(max_distance, cost.shape[0], "cpu")
        out = torch.stack([
            solve_cascade_assignment(cost[i], row_levels[i], row_mask[i],
                                     col_mask[i], float(maxd[i]))
            for i in range(cost.shape[0])])
    else:
        out = cascade_cuda(cost, row_levels, row_mask, col_mask,
                           max_distance)
    return out if batched else out[0]


def solve_masked_assignment_fused(cost, row_mask, col_mask, max_distance
                                  ) -> torch.Tensor:
    """Single-level min-cost matching (every row at cascade level 0)."""
    return solve_cascade_assignment_fused(
        cost, torch.zeros(cost.shape[:-1], dtype=torch.int32,
                          device=cost.device), row_mask, col_mask,
        max_distance)


def solve_two_stage_assignment_fused(cost_a, levels_a, rows_a, cols, maxd_a,
                                     cost_b, rows_b_super, maxd_b
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSORT's two-stage match per stream (see ``ops/assignment.py
    solve_two_stage_assignment``): (S, R, C) costs -> (match_a, match_b),
    each (S, R) int32 (unbatched in, unbatched out)."""
    batched, cost_a, (levels_a, rows_a, cost_b, rows_b_super) = _batched(
        cost_a, levels_a, rows_a, cost_b, rows_b_super)
    cols = cols if batched else cols[None]
    if cost_a.device.type == "cpu":
        s = cost_a.shape[0]
        ma, mb = _thresholds(maxd_a, s, "cpu"), _thresholds(maxd_b, s, "cpu")
        pairs = [solve_two_stage_assignment(
            cost_a[i], levels_a[i], rows_a[i], cols[i], float(ma[i]),
            cost_b[i], rows_b_super[i], float(mb[i])) for i in range(s)]
        match_a = torch.stack([a for a, _ in pairs])
        match_b = torch.stack([b for _, b in pairs])
    else:
        match_a, match_b = two_stage_cuda(cost_a, levels_a, rows_a, cols,
                                          maxd_a, cost_b, rows_b_super,
                                          maxd_b)
    if batched:
        return match_a, match_b
    return match_a[0], match_b[0]


def _check_problem(name, cost, *vectors):
    s, r, c = cost.shape
    for v, n in zip(vectors, (r, r, c, r)):
        if tuple(v.shape) != (s, n):
            raise ValueError(f"{name}: a mask or level vector of shape "
                             f"{tuple(v.shape)} does not fit costs "
                             f"{tuple(cost.shape)}")


def cascade_kernel(aug, order, levels, n_active) -> torch.Tensor:
    """Launch K4 on the buffers of ``prep``: -> (S, R) int32 augmented
    column per row (-1 unmatched)."""
    global cascade_launches
    build.require_cuda("jv_cascade", aug, order, levels, n_active)
    s, r, nc = aug.shape
    out = torch.empty((s, r), dtype=torch.int32, device=aug.device)
    lib = build.load()
    err = lib.ydt_jv_cascade(
        aug.data_ptr(), order.data_ptr(), levels.data_ptr(),
        n_active.data_ptr(), out.data_ptr(), s, r, nc,
        torch.cuda.current_stream(aug.device).cuda_stream)
    build.check_launch("jv_cascade", err)
    cascade_launches += 1
    return out


def cascade_cuda(cost, row_levels, row_mask, col_mask, max_distance):
    build.require_cuda("jv_cascade", cost, row_levels, row_mask, col_mask,
                       contiguous=False)
    _check_problem("jv_cascade", cost, row_levels, row_mask, col_mask)
    aug, order, levels, n_active = prep(cost, row_levels, row_mask, col_mask,
                                        max_distance)
    return _matches(cascade_kernel(aug, order, levels, n_active), row_mask,
                    cost.shape[2])


def two_stage_kernel(aug_a, order_a, levels_a, aug_b, order_b, n2,
                     c_real: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on the buffers of ``two_stage_prep``: -> two (S, R) int32
    augmented-column assignments (-1 unmatched)."""
    global two_stage_launches
    bufs = (aug_a, order_a, levels_a, aug_b, order_b, n2)
    build.require_cuda("jv_two_stage", *bufs)
    s, r, nc = aug_a.shape
    if aug_b.shape != aug_a.shape or n2.shape != (s, 2):
        raise ValueError("jv_two_stage: stage buffers do not match")
    out_a = torch.empty((s, r), dtype=torch.int32, device=aug_a.device)
    out_b = torch.empty_like(out_a)
    lib = build.load()
    err = lib.ydt_jv_two_stage(
        *(b.data_ptr() for b in bufs), out_a.data_ptr(), out_b.data_ptr(),
        s, r, nc, int(c_real),
        torch.cuda.current_stream(aug_a.device).cuda_stream)
    build.check_launch("jv_two_stage", err)
    two_stage_launches += 1
    return out_a, out_b


def two_stage_prep(cost_a, levels_a, rows_a, cols, maxd_a, cost_b,
                   rows_b_super, maxd_b):
    """Both stages' ``prep``, in the argument order of ``two_stage_kernel``
    (stage B: one level over the candidate superset)."""
    aug_a, order_a, lv_a, n_a = prep(cost_a, levels_a, rows_a, cols, maxd_a)
    aug_b, order_b, _, n_b = prep(cost_b, torch.zeros_like(levels_a),
                                  rows_b_super, cols, maxd_b)
    n2 = torch.stack([n_a, n_b], -1).contiguous()
    return aug_a, order_a, lv_a, aug_b, order_b, n2


def two_stage_cuda(cost_a, levels_a, rows_a, cols, maxd_a, cost_b,
                   rows_b_super, maxd_b):
    build.require_cuda("jv_two_stage", cost_a, levels_a, rows_a, cols,
                       cost_b, rows_b_super, contiguous=False)
    _check_problem("jv_two_stage", cost_a, levels_a, rows_a, cols,
                   rows_b_super)
    if cost_b.shape != cost_a.shape:
        raise ValueError("jv_two_stage: stage costs differ in shape")
    c = cost_a.shape[2]
    out_a, out_b = two_stage_kernel(
        *two_stage_prep(cost_a, levels_a, rows_a, cols, maxd_a, cost_b,
                        rows_b_super, maxd_b), c)
    return _matches(out_a, rows_a, c), _matches(out_b, rows_b_super, c)
