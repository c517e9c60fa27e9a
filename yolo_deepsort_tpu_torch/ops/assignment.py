"""Masked matching-cascade solver (port of yolo_deepsort_tpu/ops/assignment.py).

Jonker-Volgenant successive shortest augmenting paths over an augmented
(R, C + R) cost: real columns, plus one private dummy column per row priced
at ``max_distance + 2e-5`` (a row whose best real option is over the
threshold takes its dummy -- the reference's clamp-then-drop). The whole
cascade is ONE pass: rows run in level order, and a column owned by an
earlier level is frozen for later levels, so every processed prefix stays
optimal and the result equals the per-level matching cascade.

This is the plain PyTorch solver of the tracker's plain version. It runs
row by row with host-side control flow (every Dijkstra step reads its
argmin back), so it belongs on CPU tensors; the CUDA kernels' warp stage
runner (``csrc/jv_stage.cuh``) runs the same arithmetic on the card. f32 math and
lowest-index argmin ties follow the reference exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch

_BIG = 1e9  # "infinite" cost; arithmetic on it stays finite
_LEVEL_INACTIVE = 2**30

# Work the plain solver did, as the kernels' chain bound counts it: rows
# augmented and Dijkstra steps (argmin + relax or stop), over every solve
# since the caller last set them to 0.
rows_augmented = 0
dijkstra_steps = 0


def _augment_row(aug, row, levels, row_assign, col_owner, owner_level, v):
    """One JV augmentation of ``row`` (in place on the state vectors)."""
    global rows_augmented, dijkstra_steps
    rows_augmented += 1
    nc = aug.shape[1]
    big = torch.full((), _BIG, dtype=torch.float32)
    frozen = owner_level < levels[row]

    def row_costs(i):
        return torch.where(frozen, big, aug[i])

    d = row_costs(row) - v
    pred = torch.full((nc,), row, dtype=torch.int64)
    todo = torch.ones(nc, dtype=torch.bool)
    while True:
        dijkstra_steps += 1
        dj = torch.where(todo, d, big)
        j_min = int(torch.argmin(dj))  # lowest index on ties
        mu = dj[j_min]
        owner = int(col_owner[j_min])
        todo[j_min] = False
        if owner < 0:  # free column: shortest path found
            j_star = j_min
            break
        c2 = row_costs(owner) - v
        alt = mu + c2 - c2[j_min]
        better = todo & (alt < d)
        d = torch.where(better, alt, d)
        pred = torch.where(better, torch.full_like(pred, owner), pred)
    mu_star = d[j_star]
    # dual update on scanned columns keeps reduced costs feasible
    v.copy_(torch.where(todo, v, v + d - mu_star))
    j = j_star
    while True:  # augment along the predecessor chain
        i2 = int(pred[j])
        prev_j = int(row_assign[i2])
        col_owner[j] = i2
        owner_level[j] = levels[i2]
        row_assign[i2] = j
        if i2 == row:
            break
        j = prev_j


def _prep(cost, row_levels, row_mask, col_mask, max_distance):
    cost = cost.float()
    r, c = cost.shape
    maxd = torch.tensor(max_distance, dtype=torch.float32)
    eligible = row_mask[:, None] & col_mask[None, :] & (cost <= maxd)
    real = torch.where(eligible, cost, torch.full_like(cost, _BIG))
    eye = torch.eye(r, dtype=torch.bool)
    dummy = torch.where(eye, maxd + 2e-5, torch.full((r, r), _BIG))
    aug = torch.cat([real, dummy], 1)
    levels = torch.where(row_mask, row_levels.to(torch.int64),
                         torch.full((r,), _LEVEL_INACTIVE, dtype=torch.int64))
    order = torch.argsort(levels, stable=True)
    return aug, levels, order


def solve_cascade_assignment(cost, row_levels, row_mask, col_mask,
                             max_distance):
    """(R, C) costs -> (R,) int32 matched column per row, or -1.

    ``row_levels`` (R,) cascade level per row (lower first); ``row_mask`` /
    ``col_mask`` validity; pairs with cost > max_distance never match."""
    for t in (cost, row_levels, row_mask, col_mask):
        if t.device.type != "cpu":
            raise ValueError("the plain JV solver takes CPU tensors (its "
                             "control flow reads every step back)")
    row_mask, col_mask = row_mask.bool(), col_mask.bool()
    r, c = cost.shape
    aug, levels, order = _prep(cost, row_levels, row_mask,
                               col_mask, max_distance)
    nc = c + r
    row_assign = torch.full((r,), -1, dtype=torch.int64)
    col_owner = torch.full((nc,), -1, dtype=torch.int64)
    owner_level = torch.full((nc,), _LEVEL_INACTIVE, dtype=torch.int64)
    v = torch.zeros(nc, dtype=torch.float32)
    n_active = int(row_mask.sum())
    for k in range(n_active):
        _augment_row(aug, int(order[k]), levels, row_assign, col_owner,
                     owner_level, v)
    matched = (row_assign >= 0) & (row_assign < c) & row_mask
    return torch.where(matched, row_assign, -1).to(torch.int32)


def solve_masked_assignment(cost, row_mask, col_mask, max_distance):
    """Single-level min-cost matching (every row at cascade level 0)."""
    return solve_cascade_assignment(
        cost, torch.zeros(cost.shape[0], dtype=torch.int64), row_mask,
        col_mask, max_distance)


def solve_two_stage_assignment(cost_a, levels_a, rows_a, cols, maxd_a,
                               cost_b, rows_b_super, maxd_b
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSORT's two-stage match: the gated-cosine cascade, then IoU
    matching over the rows of ``rows_b_super`` that stage A left unmatched
    and the detections it left free."""
    match_a = solve_cascade_assignment(cost_a, levels_a, rows_a, cols, maxd_a)
    c = cost_a.shape[1]
    det_taken = torch.zeros(c, dtype=torch.bool)
    det_taken[match_a[match_a >= 0].long()] = True
    rows_b = rows_b_super.bool() & (match_a < 0)
    match_b = solve_masked_assignment(
        cost_b, rows_b, cols.bool() & ~det_taken, maxd_b)
    return match_a, match_b
