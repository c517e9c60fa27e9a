"""The plain twins of what kernels K3-K5 now build inside the launch, and the
plain solver's work counters, on the CPU:

* ``stable_rank_order`` (the kernels' stable sort by exact rank) equals
  ``torch.argsort(stable=True)`` on levels full of ties;
* ``assignment_kernel.kernel_prologue`` (K4/K5's compact prep) equals
  ``prep`` and the JAX package's ``_prep``, unpadded, exactly;
* ``tracker_kernel.kernel_prologue`` (K3's prologue) equals the framework
  ops that built the same buffers before the kernel took them over
  (``_framework_prologue`` below), over a seeded multi-stream scene;
* ``ops/assignment.py``'s ``rows_augmented`` / ``dijkstra_steps`` count a
  hand-worked problem's rows and steps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

import yolo_deepsort_tpu.ops.assignment_pallas as ap
from test_torch_port_gpu import jv_problem
from test_torch_port_tracking import pack, scene
from yolo_deepsort_tpu_torch.config import TrackerConfig
from yolo_deepsort_tpu_torch.ops import assignment as A
from yolo_deepsort_tpu_torch.ops import assignment_kernel as AK
from yolo_deepsort_tpu_torch.ops import boxes as B
from yolo_deepsort_tpu_torch.tracking import tracker as T
from yolo_deepsort_tpu_torch.tracking import tracker_kernel as TK

S, R, C = 3, 24, 12


@pytest.mark.parametrize("seed", range(4))
def test_stable_rank_order_equals_stable_argsort(seed):
    rng = np.random.default_rng(seed)
    levels = rng.integers(0, 4, (3, 37)).astype(np.int32)
    levels[rng.uniform(size=levels.shape) < 0.3] = A._LEVEL_INACTIVE
    lv = torch.from_numpy(levels)
    got = AK.stable_rank_order(lv)
    want = torch.argsort(lv, dim=-1, stable=True).to(torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("maxd", ["scalar", "per_stream"])
def test_assignment_prologue_equals_prep_and_reference(maxd):
    cost, levels, rows, cols, per_stream = jv_problem(
        np.random.default_rng(4), S, R, C)[:5]
    md = 0.15 if maxd == "scalar" else per_stream
    real, dummy, lv, order, n_active = AK.kernel_prologue(
        cost, levels, rows, cols, md)
    aug, p_order, p_lv, p_n = AK.prep(cost, levels, rows, cols, md)
    big = torch.full((S, R, R), A._BIG)
    eye = torch.eye(R, dtype=torch.bool)[None]
    assert torch.equal(torch.cat(
        [real, torch.where(eye, dummy[:, None, None], big)], 2), aug)
    assert torch.equal(order, p_order) and torch.equal(lv, p_lv)
    assert torch.equal(n_active, p_n)
    for i in range(S):
        thr = md if maxd == "scalar" else float(per_stream[i])
        j_aug, j_order, j_lv, j_n, r, c = ap._prep(
            jnp.asarray(cost[i].numpy()), jnp.asarray(levels[i].numpy()),
            jnp.asarray(rows[i].numpy()), jnp.asarray(cols[i].numpy()), thr)
        np.testing.assert_array_equal(real[i].numpy(),
                                      np.asarray(j_aug)[:r, :c])
        np.testing.assert_array_equal(
            np.full(r, dummy[i].item(), np.float32),
            np.diagonal(np.asarray(j_aug)[:r, c:c + r]))
        np.testing.assert_array_equal(order[i].numpy(),
                                      np.asarray(j_order)[:r])
        assert int(n_active[i]) == int(j_n[0])


def _framework_prologue(cfg, state, det_tlwh, det_conf, det_mask):
    """How the framework built the tracker kernel's inputs before the
    kernel took them over: two stable argsorts, sums, a concat."""
    st, tsu = state.state, state.time_since_update
    det_tlwh = det_tlwh.float()
    det_mask = det_mask.bool() & (det_conf > cfg.min_confidence)
    confirmed = st == T.STATE_CONFIRMED
    inactive = torch.full_like(tsu, A._LEVEL_INACTIVE)
    levels = torch.where(confirmed, tsu, inactive).to(torch.int32)
    order_a = torch.argsort(levels, dim=-1, stable=True).to(torch.int32)
    rows_b = (st == T.STATE_TENTATIVE) | (confirmed & (tsu == 0))
    order_b = torch.argsort(torch.where(rows_b, torch.zeros_like(tsu),
                                        inactive), dim=-1,
                            stable=True).to(torch.int32)
    n_a = confirmed.sum(-1, dtype=torch.int32)
    n_b = rows_b.sum(-1, dtype=torch.int32)
    det8 = torch.cat([B.tlwh_to_xyah(det_tlwh), det_tlwh], -1)
    return det8[..., :4], det_mask, levels, order_a, order_b, n_a, n_b


def test_tracker_prologue_equals_framework_ops():
    cfg = TrackerConfig(max_tracks=10, max_dets=8, nn_budget=3, feat_dim=64,
                        max_age=4)
    rng = np.random.default_rng(17)
    scenes = [scene(rng, 9, 14, 240, 320, dropout=0.3) for _ in range(3)]
    state = T.init_tracker_state(cfg, 3, "cpu")
    levels_seen = set()
    for f in range(14):
        args = [torch.from_numpy(a) for a in pack(scenes, f, cfg.max_dets)]
        args[1][0, :2] = cfg.min_confidence  # at the threshold: masked out
        got = TK.kernel_prologue(cfg, state, args[0], args[1], args[3])
        want = _framework_prologue(cfg, state, args[0], args[1], args[3])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), f
        levels_seen.update(got[2][got[2] < A._LEVEL_INACTIVE].tolist())
        state, _, _ = T.tracker_step(cfg, state, *args, (240, 320))
    assert len(levels_seen) > 1  # cascade levels beyond 0 were ordered


def test_plain_solver_counts_rows_and_steps():
    """Row 0 takes column 0 in one step; row 1 finds column 0 owned, relaxes
    through row 0 and takes column 1 for it: 2 rows, 3 steps."""
    A.rows_augmented = A.dijkstra_steps = 0
    got = A.solve_cascade_assignment(
        torch.tensor([[1.0, 2.0], [1.0, 3.0]]),
        torch.zeros(2, dtype=torch.int64), torch.ones(2, dtype=torch.bool),
        torch.ones(2, dtype=torch.bool), 10.0)
    assert got.tolist() == [1, 0]
    assert (A.rows_augmented, A.dijkstra_steps) == (2, 3)
    # an inactive row is never augmented; a row with no eligible column
    # takes its own dummy in one step
    A.rows_augmented = A.dijkstra_steps = 0
    got = A.solve_two_stage_assignment(
        torch.tensor([[1.0, 2.0], [9.0, 9.0]]), torch.zeros(2),
        torch.tensor([True, True]), torch.tensor([True, True]), 5.0,
        torch.zeros(2, 2), torch.tensor([False, False]), 0.5)
    assert [m.tolist() for m in got] == [[0, -1], [-1, -1]]
    assert (A.rows_augmented, A.dijkstra_steps) == (2, 2)
