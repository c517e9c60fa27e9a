"""The global-id step and the cross-camera matcher on the card against the
CPU, and the seeded scenes the CPU tests against the JAX package share.

The ``gpu`` tests skip without a CUDA device. This file imports no jax, so
it also runs on a machine without it:

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_global_ids_gpu.py

On the card the step and the matcher are plain torch ops (the reference
leaves them to XLA): one f32 product for the similarities (TF32 off), then
masks, argmins and gathers. Gid tables and matcher ids must equal the
CPU's exactly on the card's own inputs, matcher distances within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from yolo_deepsort_tpu_torch.config import TrackerConfig
from yolo_deepsort_tpu_torch.parallel import streams as TS
from yolo_deepsort_tpu_torch.tracking.tracker import (
    STATE_CONFIRMED,
    TrackerState,
)

FIELDS = [f.name for f in dataclasses.fields(TrackerState)]
TOL_DIST = 1e-5


def near_duplicate_scene(seed, n=8, t=6, b=4, f=16):
    """Seeded tracker states and a gid table: random unit galleries with
    random heads and counts, confirmed / tentative / free lanes; some tracks
    copied to other streams exactly (ties) and some with small noise (near
    duplicates, inside and around the 0.2 gate). -> (numpy states, gid,
    owner, TrackerConfig kwargs)."""
    rng = np.random.default_rng(seed)
    gal = rng.normal(size=(n, t, b, f)).astype(np.float32)
    state = rng.choice([0, 1, 2, 2, 2], size=(n, t)).astype(np.int32)
    track_id = np.where(state > 0, rng.integers(1, 40, (n, t)), 0)
    count = np.where(state > 0, rng.integers(0, b + 1, (n, t)), 0)
    head = rng.integers(0, b, (n, t))
    for _ in range(3 * n):  # plant near-duplicates across streams
        s0, t0, s1, t1 = (rng.integers(n), rng.integers(t), rng.integers(n),
                          rng.integers(t))
        noise = rng.choice([0.0, 0.02, 0.1, 0.3])
        gal[s1, t1] = gal[s0, t0] + noise * rng.normal(size=(b, f))
    gal /= np.linalg.norm(gal, axis=-1, keepdims=True)
    arrays = dict(
        mean=np.zeros((n, t, 8), np.float32),
        cov=np.zeros((n, t, 8, 8), np.float32),
        track_id=track_id.astype(np.int32), state=state,
        hits=np.zeros((n, t), np.int32), age=np.zeros((n, t), np.int32),
        time_since_update=np.zeros((n, t), np.int32), gallery=gal,
        gallery_head=head.astype(np.int32),
        gallery_count=count.astype(np.int32),
        next_id=np.full((n,), 40, np.int32))
    owner = arrays["track_id"].copy()
    owner[rng.random((n, t)) < 0.2] += 1  # recycled lanes
    gid = np.where(owner > 0, rng.integers(1, 5 * n * t, (n, t)), 0)
    cfg = dict(max_tracks=t, max_dets=4, feat_dim=f, nn_budget=b)
    return arrays, gid.astype(np.int32), owner.astype(np.int32), cfg


def matcher_case(kind, n=8):
    """-> (numpy states, queries (n, D, F), mask (n, D), TrackerConfig
    kwargs). ``planted``: ``test_cross_camera_gallery_match``'s case;
    ``seeded``: the near-duplicate scene with queries drawn from its
    galleries (some with noise) and random ones."""
    if kind == "planted":
        cfg = dict(max_tracks=4, max_dets=2, feat_dim=8, nn_budget=3)
        rng = np.random.default_rng(0)
        sig = rng.normal(size=(n, 8))
        sig /= np.linalg.norm(sig, axis=1, keepdims=True)
        states = TS.init_stream_states(TrackerConfig(**cfg), n, "cpu")
        arrays = {k: getattr(states, k).numpy() for k in FIELDS}
        for c in range(n):
            arrays["gallery"][c, 0, 0] = sig[c]
            arrays["gallery_count"][c, 0] = 1
            arrays["track_id"][c, 0] = 100 + c
            arrays["state"][c, 0] = STATE_CONFIRMED
        queries = np.zeros((n, cfg["max_dets"], 8), np.float32)
        qmask = np.zeros((n, cfg["max_dets"]), bool)
        for c in range(n):
            queries[c, 0] = sig[(c + 1) % n]
            qmask[c, 0] = True
        return arrays, queries, qmask, cfg
    arrays, _, _, cfg = near_duplicate_scene(7, n=n)
    rng = np.random.default_rng(8)
    d, f = 5, cfg["feat_dim"]
    queries = rng.normal(size=(n, d, f)).astype(np.float32)
    for s in range(n):
        for j in range(3):
            src = arrays["gallery"][rng.integers(n), rng.integers(
                cfg["max_tracks"]), rng.integers(cfg["nn_budget"])]
            queries[s, j] = src + rng.choice([0.0, 0.05]) * rng.normal(
                size=f)
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
    qmask = rng.random((n, d)) < 0.8
    return arrays, queries, qmask, cfg




@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _states(arrays, device):
    return TrackerState(**{k: torch.from_numpy(np.array(arrays[k])).to(device)
                           for k in FIELDS})


def _gids(gid, owner, device):
    return TS.GlobalIDState(torch.from_numpy(gid).to(device),
                            torch.from_numpy(owner).to(device))


def _rounds(arrays, gid, owner, cfg, device):
    """Three chained global-id rounds (the last at a looser threshold) on
    a mesh of one rank on ``device``; -> [(gid, owner)] as numpy."""
    mesh = TS.make_stream_mesh(1, device=device)
    n = arrays["state"].shape[0]
    states, gids = _states(arrays, device), _gids(gid, owner, device)
    out = []
    for kw in ({}, {}, {"match_thresh": 0.5}):
        gids = TS.make_global_id_step(mesh, TrackerConfig(**cfg), n,
                                      **kw)(states, gids)
        out.append((gids.gid.cpu().numpy(), gids.owner.cpu().numpy()))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", [dict(seed=0), dict(seed=1),
                                   dict(seed=2, t=128, b=100, f=512)])
def test_global_id_step_card_equals_cpu(cuda_device, sizes):
    """Seeded near-duplicate scenes, the last at the served tracker sizes
    (T 128, nn_budget 100, F 512, S 8): every round's table equal."""
    arrays, gid, owner, cfg = near_duplicate_scene(**sizes)
    got = _rounds(arrays, gid, owner, cfg, cuda_device)
    want = _rounds(arrays, gid, owner, cfg, "cpu")
    for r, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"round {r}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"round {r}")
    assert (want[-1][0] < gid).any(), "the scene adopted no gid"


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["planted", "seeded"])
def test_cross_camera_matcher_card_equals_cpu(cuda_device, kind):
    arrays, queries, qmask, cfg = matcher_case(kind)
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        mesh = TS.make_stream_mesh(1, device=dev)
        ids, d = TS.make_cross_camera_matcher(mesh, TrackerConfig(**cfg))(
            _states(arrays, dev), torch.from_numpy(queries).to(dev),
            torch.from_numpy(qmask).to(dev))
        res[dev.type] = (ids.cpu().numpy(), d.cpu().numpy())
    np.testing.assert_array_equal(res["cuda"][0], res["cpu"][0])
    np.testing.assert_allclose(res["cuda"][1], res["cpu"][1], atol=TOL_DIST,
                               rtol=0)


@pytest.mark.gpu
def test_global_id_step_never_waits_for_the_card(cuda_device):
    """The step and the provisional ids read nothing back: no synchronizing
    CUDA call (sync debug mode "error"), and the table stays on the card."""
    arrays, gid, owner, cfg = near_duplicate_scene(0)
    mesh = TS.make_stream_mesh(1, device=cuda_device)
    step = TS.make_global_id_step(mesh, TrackerConfig(**cfg), 8)
    states = _states(arrays, cuda_device)
    gids = _gids(gid, owner, cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gids = step(states, gids)
        gids = TS.assign_provisional_gids(states.track_id, gids, 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert gids.gid.device.type == "cuda"
