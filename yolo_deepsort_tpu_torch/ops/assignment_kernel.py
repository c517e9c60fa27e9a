"""Kernels 4 and 5: the JV assignment solver (CUDA ``csrc/assignment.cu``,
with the warp stage runner of ``csrc/jv_stage.cuh``).

Replaces two TPU kernels of ``yolo_deepsort_tpu/ops/assignment_pallas.py``:

* K4 ``_jv_kernel`` (via ``solve_cascade_assignment_pallas``): one
  matching-cascade sweep -> ``solve_cascade_assignment_fused``;
* K5 ``_two_stage_kernel`` (via ``solve_two_stage_pallas``): DeepSORT's
  two-stage match in one launch -> ``solve_two_stage_assignment_fused``,
  which the tracker step (``tracking/tracker.py``) calls once per frame for
  all streams.

Bound on the H100 by latency: a solve is a chain of (rows + Dijkstra
steps) dependent steps, and almost every row finds a free column in its
first step, so the fixed cost per row rules. The design gives each stream
one warp, with the column state in registers, the real cost block staged
in shared memory and no block-wide barrier inside the row loop (see the
notes at the top of the .cu files).

The kernels take the compact problem -- costs (S, R, C), levels, row and
column masks, thresholds -- and do the reference's prep themselves:
eligibility, the private dummies at ``max_distance + 2e-5``, the
``_LEVEL_INACTIVE`` levels, the stable level-major order, the active-row
counts and the unpadding to real columns. ``prep`` / ``two_stage_prep``
(the reference's ``_prep``, batched) and ``kernel_prologue`` (that prep in
the kernels' compact form, with the orders as exact stable ranks) are
their plain versions. No wrapper builds the augmented (S, R, C + R) tensor.

Both solvers take a cost of shape (S, R, C) or (R, C). They take the plain
version (``ops/assignment.py``, one stream at a time) for CPU tensors only;
a CUDA tensor launches the kernel or raises. ``max_distance`` is a float or
a per-stream (S,) tensor.
"""

from __future__ import annotations

import ctypes
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
# whether the last launch staged its cost blocks in shared memory (False:
# the runner read them from device memory)
last_staged = None


def _thresholds(max_distance, s: int, device) -> torch.Tensor:
    """(S,) float32 thresholds; a float becomes a fill, not a host copy."""
    if isinstance(max_distance, torch.Tensor):
        t = max_distance.to(device=device, dtype=torch.float32)
        return t.expand(s) if t.dim() == 0 else t.reshape(s)
    return torch.full((s,), float(max_distance), dtype=torch.float32,
                      device=device)


def stable_rank_order(levels: torch.Tensor) -> torch.Tensor:
    """(S, N) levels -> (S, N) int32 order with order[rank_i] = i, rank_i =
    #{k : (level_k, k) < (level_i, i)}: the kernels' stable sort, equal to
    ``torch.argsort(levels, stable=True)``."""
    s, n = levels.shape
    li, lk = levels[:, :, None], levels[:, None, :]
    idx = torch.arange(n, device=levels.device)
    k_before_i = idx[None, None, :] < idx[None, :, None]
    before = (lk < li) | ((lk == li) & k_before_i)
    rank = before.sum(-1)
    order = torch.empty((s, n), dtype=torch.int32, device=levels.device)
    return order.scatter_(1, rank, idx.to(torch.int32).expand(s, n)
                          .contiguous())


def prep(cost, row_levels, row_mask, col_mask, max_distance):
    """The reference's ``_prep``, batched and unpadded: (S, R, C) costs ->
    (aug (S, R, C + R) f32, order (S, R) i32, levels (S, R) i32,
    n_active (S,) i32)."""
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


def kernel_prologue(cost, row_levels, row_mask, col_mask, max_distance):
    """Plain version of what the kernels build from the compact problem:
    (real (S, R, C) f32 -- eligible costs, else ``_BIG`` --, dummy (S,) f32
    -- the price of each row's own dummy column, every other dummy entry
    being ``_BIG`` --, levels (S, R) i32, order (S, R) i32 as exact stable
    ranks, n_active (S,) i32). ``prep`` is this with the dummy block
    written out."""
    cost = cost.float()
    s = cost.shape[0]
    row_mask, col_mask = row_mask.bool(), col_mask.bool()
    maxd = _thresholds(max_distance, s, cost.device)
    eligible = (row_mask[:, :, None] & col_mask[:, None, :]
                & (cost <= maxd[:, None, None]))
    real = torch.where(eligible, cost, torch.full_like(cost, _BIG))
    levels = torch.where(row_mask, row_levels.to(torch.int32),
                         torch.full_like(row_mask, _LEVEL_INACTIVE,
                                         dtype=torch.int32))
    return (real, maxd + 2e-5, levels, stable_rank_order(levels),
            row_mask.sum(-1, dtype=torch.int32))


def _batched(cost, *rows):
    """Add a stream axis to an unbatched (R, C) problem."""
    if cost.dim() == 3:
        return True, cost, rows
    return False, cost[None], tuple(v[None] for v in rows)


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


def _maxd_arg(max_distance, s: int, device):
    """A threshold as the C entry takes it: (pointer, stride, value). A
    float or a one-element CPU tensor goes by value; a CUDA tensor by
    pointer, stride 0 for one element and 1 for one per stream."""
    if not isinstance(max_distance, torch.Tensor):
        return None, 0, float(max_distance)
    if max_distance.device.type == "cpu" and max_distance.numel() == 1:
        return None, 0, float(max_distance)
    t = max_distance.to(device=device, dtype=torch.float32).reshape(-1)
    if t.numel() not in (1, s):
        raise ValueError(f"max_distance of {t.numel()} values for {s} "
                         "streams")
    return t.contiguous(), int(t.numel() > 1), 0.0


def cascade_inputs(cost, row_levels, row_mask, col_mask, max_distance):
    """The compact buffers ``cascade_kernel`` takes, in its argument order:
    no op for inputs already in the kernel's types and contiguous."""
    build.require_cuda("jv_cascade", cost, row_levels, row_mask, col_mask,
                       contiguous=False)
    _check_problem("jv_cascade", cost, row_levels, row_mask, col_mask)
    return (cost.float().contiguous(),
            row_levels.to(torch.int32).contiguous(),
            row_mask.bool().contiguous(), col_mask.bool().contiguous(),
            _maxd_arg(max_distance, cost.shape[0], cost.device))


def cascade_kernel(cost, levels, row_mask, col_mask, maxd) -> torch.Tensor:
    """Launch K4 on the buffers of ``cascade_inputs``: -> (S, R) int32 real
    column per row (-1 unmatched)."""
    global cascade_launches, last_staged
    md, stride, value = maxd
    bufs = (cost, levels, row_mask, col_mask) + ((md,) if md is not None
                                                 else ())
    build.require_cuda("jv_cascade", *bufs)
    s, r, c = cost.shape
    out = torch.empty((s, r), dtype=torch.int32, device=cost.device)
    staged = ctypes.c_int(0)
    lib = build.load()
    err = lib.ydt_jv_cascade(
        cost.data_ptr(), levels.data_ptr(), row_mask.data_ptr(),
        col_mask.data_ptr(), None if md is None else md.data_ptr(), stride,
        value, out.data_ptr(), s, r, c, ctypes.addressof(staged),
        torch.cuda.current_stream(cost.device).cuda_stream)
    build.check_launch("jv_cascade", err)
    cascade_launches += 1
    last_staged = bool(staged.value)
    return out


def cascade_cuda(cost, row_levels, row_mask, col_mask, max_distance):
    return cascade_kernel(*cascade_inputs(cost, row_levels, row_mask,
                                          col_mask, max_distance))


def two_stage_inputs(cost_a, levels_a, rows_a, cols, maxd_a, cost_b,
                     rows_b_super, maxd_b):
    """The compact buffers ``two_stage_kernel`` takes, in its argument
    order (stage B: one level over the candidate superset)."""
    build.require_cuda("jv_two_stage", cost_a, levels_a, rows_a, cols,
                       cost_b, rows_b_super, contiguous=False)
    _check_problem("jv_two_stage", cost_a, levels_a, rows_a, cols,
                   rows_b_super)
    if cost_b.shape != cost_a.shape:
        raise ValueError("jv_two_stage: stage costs differ in shape")
    s, dev = cost_a.shape[0], cost_a.device
    return (cost_a.float().contiguous(),
            levels_a.to(torch.int32).contiguous(),
            rows_a.bool().contiguous(), cols.bool().contiguous(),
            _maxd_arg(maxd_a, s, dev), cost_b.float().contiguous(),
            rows_b_super.bool().contiguous(), _maxd_arg(maxd_b, s, dev))


def two_stage_kernel(cost_a, levels_a, rows_a, cols, maxd_a, cost_b,
                     rows_b, maxd_b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on the buffers of ``two_stage_inputs``: -> two (S, R)
    int32 real-column assignments (-1 unmatched)."""
    global two_stage_launches, last_staged
    (ma, sa, va), (mb, sb, vb) = maxd_a, maxd_b
    bufs = (cost_a, levels_a, rows_a, cols, cost_b, rows_b) + tuple(
        m for m in (ma, mb) if m is not None)
    build.require_cuda("jv_two_stage", *bufs)
    s, r, c = cost_a.shape
    if cost_b.shape != cost_a.shape:
        raise ValueError("jv_two_stage: stage buffers do not match")
    out_a = torch.empty((s, r), dtype=torch.int32, device=cost_a.device)
    out_b = torch.empty_like(out_a)
    staged = ctypes.c_int(0)
    lib = build.load()
    err = lib.ydt_jv_two_stage(
        cost_a.data_ptr(), levels_a.data_ptr(), rows_a.data_ptr(),
        cols.data_ptr(), None if ma is None else ma.data_ptr(), sa, va,
        cost_b.data_ptr(), rows_b.data_ptr(),
        None if mb is None else mb.data_ptr(), sb, vb, out_a.data_ptr(),
        out_b.data_ptr(), s, r, c, ctypes.addressof(staged),
        torch.cuda.current_stream(cost_a.device).cuda_stream)
    build.check_launch("jv_two_stage", err)
    two_stage_launches += 1
    last_staged = bool(staged.value)
    return out_a, out_b


def two_stage_prep(cost_a, levels_a, rows_a, cols, maxd_a, cost_b,
                   rows_b_super, maxd_b):
    """Both stages' ``prep`` (stage B: one level over the candidate
    superset): the plain version of K5's prologue, with the augmented
    blocks written out -> (aug_a, order_a, levels_a, aug_b, order_b, n2
    (S, 2) [n_a, n_b])."""
    aug_a, order_a, lv_a, n_a = prep(cost_a, levels_a, rows_a, cols, maxd_a)
    aug_b, order_b, _, n_b = prep(cost_b, torch.zeros_like(levels_a),
                                  rows_b_super, cols, maxd_b)
    n2 = torch.stack([n_a, n_b], -1).contiguous()
    return aug_a, order_a, lv_a, aug_b, order_b, n2


def two_stage_cuda(cost_a, levels_a, rows_a, cols, maxd_a, cost_b,
                   rows_b_super, maxd_b):
    return two_stage_kernel(*two_stage_inputs(
        cost_a, levels_a, rows_a, cols, maxd_a, cost_b, rows_b_super,
        maxd_b))
