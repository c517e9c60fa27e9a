"""The port's JV solver and tracker step against the numpy oracle and the
JAX package: assignments exactly equal; a seeded multi-stream scene with
occlusions gives exactly equal discrete state and outputs, boxes within
1 px and Kalman means within rtol 2e-4 (the method of
tests/test_tracker_pallas.py)."""

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from specs.assignment_np import matching_cascade
from yolo_deepsort_tpu.config import TrackerConfig
from yolo_deepsort_tpu.ops.assignment import (
    solve_cascade_assignment as j_cascade,
)
from yolo_deepsort_tpu.ops.assignment import (
    solve_two_stage_assignment as j_two_stage,
)
from yolo_deepsort_tpu.tracking.tracker import init_tracker_state as j_init
from yolo_deepsort_tpu.tracking.tracker import tracker_step as j_step
from yolo_deepsort_tpu_torch.ops.assignment import (
    solve_cascade_assignment,
    solve_two_stage_assignment,
)
from yolo_deepsort_tpu_torch.tracking.tracker import (
    init_tracker_state,
    tracker_step,
)

DISCRETE = ("state", "hits", "age", "time_since_update", "track_id",
            "gallery_head", "gallery_count", "next_id")


class _Track:
    def __init__(self, tsu):
        self.time_since_update = tsu


def _oracle(cost, tsu, maxd):
    def metric(tracks, dets, ti, di):
        return cost[np.ix_(ti, di)].astype(np.float64)

    matches, _, _ = matching_cascade(metric, maxd, 70,
                                     [_Track(t) for t in tsu],
                                     list(range(cost.shape[1])))
    return dict(matches)


@pytest.mark.parametrize("seed", range(6))
def test_cascade_matches_oracle_and_jax(seed):
    rng = np.random.default_rng(seed)
    r, c = 14, 10
    cost = rng.uniform(0, 0.4, (r, c)).astype(np.float32)
    cost[rng.uniform(size=(r, c)) < 0.2] = 1e5  # gated pairs
    tsu = rng.integers(1, 6, r)
    rows = rng.uniform(size=r) < 0.9
    cols = rng.uniform(size=c) < 0.9
    got = solve_cascade_assignment(
        torch.from_numpy(cost), torch.from_numpy(tsu - 1),
        torch.from_numpy(rows), torch.from_numpy(cols), 0.2).numpy()
    want = np.asarray(j_cascade(cost, (tsu - 1).astype(np.int32), rows, cols,
                                0.2))
    np.testing.assert_array_equal(got, want)
    masked = np.where(rows[:, None] & cols[None, :], cost, 1e5)
    assert {i: int(j) for i, j in enumerate(got) if j >= 0} == _oracle(
        masked, tsu, 0.2)


@pytest.mark.parametrize("seed", range(4))
def test_two_stage_matches_jax(seed):
    rng = np.random.default_rng(50 + seed)
    r, c = 12, 9
    cost_a = rng.uniform(0, 0.4, (r, c)).astype(np.float32)
    cost_b = rng.uniform(0, 1.0, (r, c)).astype(np.float32)
    levels = rng.integers(0, 4, r).astype(np.int32)
    rows_a = rng.uniform(size=r) < 0.6
    rows_b = ~rows_a | (rng.uniform(size=r) < 0.3)
    cols = rng.uniform(size=c) < 0.9
    got = solve_two_stage_assignment(
        *(torch.from_numpy(v) for v in (cost_a, levels, rows_a, cols)), 0.2,
        torch.from_numpy(cost_b), torch.from_numpy(rows_b), 0.7)
    want = j_two_stage(cost_a, levels, rows_a, cols, 0.2, cost_b, rows_b, 0.7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def scene(rng, n_obj, frames, h, w, dropout=0.0, feat_dim=64):
    """Jittered walking boxes with detector dropout (occlusions)."""
    base = np.stack([
        rng.uniform(10, w - 90, n_obj), rng.uniform(10, h - 120, n_obj),
        rng.uniform(20, 60, n_obj), rng.uniform(40, 90, n_obj)], axis=1)
    vel = rng.normal(0, 1.5, (n_obj, 2))
    feats = rng.normal(0, 1, (n_obj, feat_dim))
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    out = []
    for f in range(frames):
        tl = base.copy()
        tl[:, :2] += vel * f
        keep = rng.uniform(size=n_obj) > dropout
        jit = tl + rng.normal(0, 0.8, tl.shape)
        fe = feats + rng.normal(0, 0.05, feats.shape)
        fe /= np.linalg.norm(fe, axis=1, keepdims=True)
        out.append((jit[keep], fe[keep]))
    return out


def pack(scenes, f, d, feat_dim=64):
    s = len(scenes)
    tl = np.zeros((s, d, 4), np.float32)
    fe = np.zeros((s, d, feat_dim), np.float32)
    cf = np.zeros((s, d), np.float32)
    mk = np.zeros((s, d), bool)
    for si, sc in enumerate(scenes):
        boxes, fts = sc[f]
        n = min(len(boxes), d)
        tl[si, :n], fe[si, :n], cf[si, :n], mk[si, :n] = (
            boxes[:n], fts[:n], 0.9, True)
    return tl, cf, fe, mk


def assert_frame_equal(f, j_state, j_out, j_emit, t_state, t_out, t_emit):
    for name in DISCRETE:
        np.testing.assert_array_equal(
            getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)),
            err_msg=f"frame {f}: {name}")
    np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
    np.testing.assert_array_equal(t_out.numpy()[..., 4],
                                  np.asarray(j_out)[..., 4])
    np.testing.assert_allclose(t_out.numpy()[..., :4],
                               np.asarray(j_out)[..., :4], atol=1)
    np.testing.assert_allclose(t_state.mean.numpy(), np.asarray(j_state.mean),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(t_state.gallery.numpy(),
                               np.asarray(j_state.gallery), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["multistream", "churn", "empty_frames"])
def test_tracker_step_matches_jax(case):
    if case == "multistream":
        cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=5,
                            feat_dim=64)
        rng = np.random.default_rng(3)
        scenes = [scene(rng, 4, 20, 240, 320, dropout=0.1) for _ in range(2)]
    elif case == "churn":  # births, deletions, cascade levels > 0
        cfg = TrackerConfig(max_tracks=8, max_dets=8, nn_budget=3,
                            feat_dim=64, max_age=4)
        rng = np.random.default_rng(11)
        scenes = [scene(rng, 10, 24, 240, 320, dropout=0.35)]
    else:
        cfg = TrackerConfig(max_tracks=8, max_dets=8, nn_budget=3,
                            feat_dim=64)
        sc = scene(np.random.default_rng(5), 3, 8, 240, 320)
        sc[2] = (sc[2][0][:0], sc[2][1][:0])
        sc[3] = (sc[3][0][:0], sc[3][1][:0])
        scenes = [sc]
    s = len(scenes)
    img_hw = jnp.array([240, 320], jnp.int32)
    step = jax.jit(jax.vmap(lambda st, a, b, c, d: j_step(
        cfg, st, a, b, c, d, img_hw)))
    j_state = jax.tree.map(lambda x: jnp.stack([x] * s), j_init(cfg))
    t_state = init_tracker_state(cfg, s, "cpu")
    for f in range(len(scenes[0])):
        args = pack(scenes, f, cfg.max_dets)
        j_state, j_out, j_emit = step(j_state, *args)
        t_state, t_out, t_emit = tracker_step(
            cfg, t_state, *(torch.from_numpy(a) for a in args), (240, 320))
        assert_frame_equal(f, j_state, j_out, j_emit, t_state, t_out, t_emit)
