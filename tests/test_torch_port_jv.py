"""Kernels K4/K5 of the port (``ops/assignment_kernel.py``) against the JAX
package on the CPU, where the port's dispatchers run their plain versions:

* against the Pallas kernels ``solve_cascade_assignment_pallas`` /
  ``solve_two_stage_pallas`` in interpret mode (monkeypatched as
  tests/test_assignment.py does; the JAX package is not changed), and
  against the lax path, batched over S=3 streams with per-stream
  thresholds, exact ties, INFTY gates and inactive rows: discrete outputs
  exactly equal;
* the framework-side prep that feeds the CUDA kernels against the
  reference's ``_prep``, unpadded: exactly equal;
* the tracker step's batched dispatcher against the per-stream loop it
  replaced, over a seeded S=3 scene: every state field and output equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import yolo_deepsort_tpu.ops.assignment_pallas as ap
from test_torch_port_gpu import jv_problem
from test_torch_port_tracking import pack, scene
from yolo_deepsort_tpu.ops.assignment import _solve_cascade_lax
from yolo_deepsort_tpu.ops.assignment import (
    solve_masked_assignment as j_masked,
)
from yolo_deepsort_tpu.ops.assignment import (
    solve_two_stage_assignment as j_two_stage_lax,
)
from yolo_deepsort_tpu_torch.config import TrackerConfig
from yolo_deepsort_tpu_torch.ops import assignment_kernel as AK
from yolo_deepsort_tpu_torch.ops.assignment import solve_two_stage_assignment
from yolo_deepsort_tpu_torch.tracking import tracker as T
from torch_port_threads import torch_threads  # noqa: F401

S, R, C = 3, 24, 12


@pytest.fixture(scope="module")
def problems():
    return [jv_problem(np.random.default_rng(seed), S, R, C)
            for seed in range(3)]


def _np(args):
    return [a.numpy() for a in args]


@pytest.fixture
def interpret(monkeypatch):
    one, two = ap._solve_batched, ap._solve_two_batched_c
    monkeypatch.setattr(ap, "_solve_batched",
                        lambda *a, **k: one(*a, interpret=True))
    monkeypatch.setattr(ap, "_solve_two_batched_c",
                        lambda *a, **k: two(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("case", range(3))
def test_cascade_matches_pallas_and_lax(problems, interpret, case):
    cost, levels, rows, cols, maxd = problems[case][:5]
    got = AK.solve_cascade_assignment_fused(cost, levels, rows, cols,
                                            maxd).numpy()
    c, lv, rm, cm, md = _np((cost, levels, rows, cols, maxd))
    pallas = jax.vmap(ap.solve_cascade_assignment_pallas)(c, lv, rm, cm, md)
    lax = jax.vmap(_solve_cascade_lax)(c, lv, rm, cm, md)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    np.testing.assert_array_equal(got, np.asarray(lax))
    assert (got[1:] >= 0).any() and (got[0] < 0).all()  # stream 0: no rows
    # unbatched in, unbatched out
    one = AK.solve_cascade_assignment_fused(cost[1], levels[1], rows[1],
                                            cols[1], float(maxd[1]))
    np.testing.assert_array_equal(one.numpy(), got[1])
    # the single-level form
    masked = AK.solve_masked_assignment_fused(cost, rows, cols, maxd).numpy()
    for i in range(S):
        np.testing.assert_array_equal(
            masked[i], np.asarray(j_masked(c[i], rm[i], cm[i], md[i])))


@pytest.mark.parametrize("case", range(3))
def test_two_stage_matches_pallas_and_lax(problems, interpret, case):
    cost_a, levels, rows_a, cols, maxd_a, cost_b, rows_b = problems[case]
    maxd_b = torch.tensor([0.7, 0.5, 0.6])
    got = AK.solve_two_stage_assignment_fused(cost_a, levels, rows_a, cols,
                                              maxd_a, cost_b, rows_b, maxd_b)
    args = _np((cost_a, levels, rows_a, cols, maxd_a, cost_b, rows_b,
                maxd_b))
    pallas = jax.vmap(ap.solve_two_stage_pallas)(*args)
    for g, p in zip(got, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
    for i in range(S):
        lax = j_two_stage_lax(*(a[i] for a in args))
        for g, w in zip(got, lax):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    assert (got[1] >= 0).any(), "stage B matched"


@pytest.mark.parametrize("maxd", ["scalar", "per_stream"])
def test_prep_matches_reference(problems, maxd):
    cost, levels, rows, cols, per_stream = problems[0][:5]
    md = 0.15 if maxd == "scalar" else per_stream
    aug, order, lv, n_active = AK.prep(cost, levels, rows, cols, md)
    assert aug.shape == (S, R, C + R) and aug.dtype == torch.float32
    for i in range(S):
        thr = md if maxd == "scalar" else float(per_stream[i])
        j_aug, j_order, j_lv, j_n, r, c = ap._prep(
            jnp.asarray(cost[i].numpy()), jnp.asarray(levels[i].numpy()),
            jnp.asarray(rows[i].numpy()), jnp.asarray(cols[i].numpy()), thr)
        np.testing.assert_array_equal(aug[i].numpy(),
                                      np.asarray(j_aug)[:r, :c + r])
        np.testing.assert_array_equal(order[i].numpy(),
                                      np.asarray(j_order)[:r])
        np.testing.assert_array_equal(lv[i].numpy(), np.asarray(j_lv)[:r])
        assert int(n_active[i]) == int(j_n[0])
    stage = AK.two_stage_prep(*problems[0], 0.7)
    assert stage[5].shape == (S, 2)
    np.testing.assert_array_equal(stage[5][:, 0].numpy(), n_active.numpy())
    np.testing.assert_array_equal(stage[5][:, 1].numpy(),
                                  problems[0][6].sum(-1).numpy())


def _per_stream_loop(cost_a, levels_a, rows_a, cols, maxd_a, cost_b,
                     rows_b_super, maxd_b):
    """The tracker step's match before the batched dispatcher: one solve
    per stream into preallocated CPU buffers."""
    s, t = rows_a.shape
    match_a = torch.full((s, t), -1, dtype=torch.int32)
    match_b = torch.full((s, t), -1, dtype=torch.int32)
    for si in range(s):
        match_a[si], match_b[si] = solve_two_stage_assignment(
            cost_a[si], levels_a[si], rows_a[si], cols[si], maxd_a,
            cost_b[si], rows_b_super[si], maxd_b)
    return match_a, match_b


def test_tracker_step_dispatcher_matches_per_stream_loop(monkeypatch):
    cfg = TrackerConfig(max_tracks=12, max_dets=8, nn_budget=4, feat_dim=64,
                        max_age=5)
    rng = np.random.default_rng(21)
    scenes = [scene(rng, 7, 14, 240, 320, dropout=0.25) for _ in range(3)]
    new, old = (T.init_tracker_state(cfg, 3, "cpu"),
                T.init_tracker_state(cfg, 3, "cpu"))
    emitted = 0
    for f in range(14):
        args = [torch.from_numpy(a) for a in pack(scenes, f, cfg.max_dets)]
        new, n_out, n_emit = T.tracker_step(cfg, new, *args, (240, 320))
        with monkeypatch.context() as m:
            m.setattr(T, "solve_two_stage_assignment_fused", _per_stream_loop)
            old, o_out, o_emit = T.tracker_step(cfg, old, *args, (240, 320))
        for fld in dataclasses.fields(T.TrackerState):
            assert torch.equal(getattr(new, fld.name),
                               getattr(old, fld.name)), (f, fld.name)
        assert torch.equal(n_out, o_out) and torch.equal(n_emit, o_emit)
        emitted += int(n_emit.sum())
    assert emitted > 0
