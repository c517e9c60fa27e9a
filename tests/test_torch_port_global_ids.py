"""The cross-camera global-ID path against the JAX package on the CPU.

The same seeded numpy inputs go through the reference's functions
(``yolo_deepsort_tpu/parallel/streams.py``, on the 8 virtual CPU devices of
``tests/conftest.py``: meshes of 1 and of 8 devices) and through the port's
(``yolo_deepsort_tpu_torch/parallel/streams.py`` on a mesh of one rank):
``assign_provisional_gids``, ``relabel_outputs_global``, the global-id step
on the reference's handoff and no-aliasing scenes and on seeded states with
planted near-duplicate galleries, and the cross-camera matcher. Gid tables
and matcher ids are exactly equal, matcher distances within 1e-5. The
multi-rank port (gloo) is held to the one-rank port in
``tests/test_torch_port_multirank.py``.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from yolo_deepsort_tpu.config import TrackerConfig as JTrackerConfig
from yolo_deepsort_tpu.parallel import streams as JS
from yolo_deepsort_tpu.tracking.tracker import TrackerState as JTrackerState
from yolo_deepsort_tpu.tracking.tracker import tracker_step as j_tracker_step
from yolo_deepsort_tpu_torch.config import TrackerConfig
from yolo_deepsort_tpu_torch.parallel import streams as TS
from yolo_deepsort_tpu_torch.tracking.tracker import (
    STATE_CONFIRMED,
    TrackerState,
    tracker_step,
)

from test_torch_port_global_ids_gpu import matcher_case, near_duplicate_scene
from torch_port_threads import torch_threads  # noqa: F401

FIELDS = [f.name for f in dataclasses.fields(TrackerState)]
TOL_DIST = 1e-5
CPU_MESH = TS.make_stream_mesh(1, device="cpu")


def _np(states):
    return {k: np.array(getattr(states, k)) for k in FIELDS}


def _torch_states(arrays):
    return TrackerState(**{k: torch.from_numpy(np.array(arrays[k]))
                           for k in FIELDS})


def _jax_states(arrays, mesh):
    sharded = NamedSharding(mesh, P("stream"))
    return JTrackerState(**{k: jax.device_put(jnp.asarray(arrays[k]),
                                                sharded) for k in FIELDS})


def _jax_gids(gid, owner, mesh):
    sharded = NamedSharding(mesh, P("stream"))
    return JS.GlobalIDState(gid=jax.device_put(jnp.asarray(gid), sharded),
                            owner=jax.device_put(jnp.asarray(owner), sharded))


def _torch_gids(gid, owner):
    return TS.GlobalIDState(gid=torch.from_numpy(np.array(gid)),
                            owner=torch.from_numpy(np.array(owner)))


def _jax_gid_step(cfg_kw, n_devices, n_streams, **kw):
    """The reference's step on a mesh of ``n_devices``: numpy states and
    table in, numpy (gid, owner) out."""
    mesh = JS.make_stream_mesh(n_devices)
    step = JS.make_global_id_step(mesh, JTrackerConfig(**cfg_kw),
                                  n_streams_total=n_streams, **kw)

    def run(arrays, gid, owner):
        out = step(_jax_states(arrays, mesh), _jax_gids(gid, owner, mesh))
        return np.asarray(out.gid), np.asarray(out.owner)

    return run


def _port_gid_step(cfg_kw, n_streams, **kw):
    step = TS.make_global_id_step(CPU_MESH, TrackerConfig(**cfg_kw),
                                  n_streams_total=n_streams, **kw)

    def run(arrays, gid, owner):
        out = step(_torch_states(arrays), _torch_gids(gid, owner))
        return out.gid.numpy(), out.owner.numpy()

    return run


@pytest.mark.parametrize("seed", range(4))
def test_provisional_gids_and_relabel_match_jax(seed):
    """Seeded tables with fresh, recycled (track_id != owner) and unset
    (gid 0) lanes, the rank's streams at an offset of the global ones."""
    rng = np.random.default_rng(seed)
    s, t, n_total, offset = 4, 6, 8, 4
    track_id = rng.integers(0, 30, (s, t)).astype(np.int32)
    track_id[rng.random((s, t)) < 0.3] = 0
    owner = track_id.copy()
    recycled = rng.random((s, t)) < 0.3
    owner[recycled] = rng.integers(1, 30, int(recycled.sum()))
    gid = rng.integers(0, 200, (s, t)).astype(np.int32)
    gid[rng.random((s, t)) < 0.2] = 0
    want = JS.assign_provisional_gids(
        jnp.asarray(track_id), JS.GlobalIDState(jnp.asarray(gid),
                                                jnp.asarray(owner)),
        n_streams_total=n_total, stream_offset=offset)
    got = TS.assign_provisional_gids(
        torch.from_numpy(track_id), _torch_gids(gid, owner),
        n_streams_total=n_total, stream_offset=offset)
    np.testing.assert_array_equal(got.gid.numpy(), np.asarray(want.gid))
    np.testing.assert_array_equal(got.owner.numpy(), np.asarray(want.owner))
    assert (got.gid.numpy() != gid).any() and (got.gid.numpy() == gid).any()
    for shape in ((s, t, 5), (3, s, t, 5)):  # one step, a K-frame chunk
        outputs = rng.integers(-50, 2000, shape).astype(np.int32)
        want_o = JS.relabel_outputs_global(jnp.asarray(outputs), want)
        got_o = TS.relabel_outputs_global(torch.from_numpy(outputs), got)
        assert got_o.dtype == torch.int32
        np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))


def _scene_trackers(cfg_kw, n):
    j_step = jax.jit(jax.vmap(partial(j_tracker_step,
                                      JTrackerConfig(**cfg_kw))))
    cfg = TrackerConfig(**cfg_kw)
    img_hw = jnp.broadcast_to(jnp.array([720, 1280], jnp.int32), (n, 2))

    def port(states, tlwh, conf, feat, mask):
        return tracker_step(cfg, states, *(torch.from_numpy(a) for a in
                                           (tlwh, conf, feat, mask)),
                            (720, 1280))

    def ref(states, tlwh, conf, feat, mask):
        return j_step(states, tlwh, conf, feat, mask, img_hw)

    return port, ref


def _handoff_inputs(cfg, n, t, rng, f_obj):
    """``test_global_id_handoff_across_cameras``'s frame ``t``: camera 0
    sees the object for t < 10, camera n - 1 from t >= 8."""
    d, f = cfg["max_dets"], cfg["feat_dim"]
    tlwh = np.zeros((n, d, 4), np.float32)
    conf = np.zeros((n, d), np.float32)
    feat = np.zeros((n, d, f), np.float32)
    mask = np.zeros((n, d), bool)
    for cam, on, box in ((0, t < 10, [200 + 5 * t, 300, 40, 80]),
                         (n - 1, t >= 8, [100 + 5 * t, 400, 40, 80])):
        if on:
            tlwh[cam, 0] = box
            conf[cam, 0] = 0.9
            feat[cam, 0] = f_obj + rng.normal(0, 0.02, f)
            feat[cam, 0] /= np.linalg.norm(feat[cam, 0])
            mask[cam, 0] = True
    return tlwh, conf, feat, mask


def _no_alias_inputs(cfg, n, t, feats):
    """``test_global_id_no_false_aliasing``'s frame ``t``: two objects of
    distinct appearance on every camera."""
    d, f = cfg["max_dets"], cfg["feat_dim"]
    tlwh = np.zeros((n, d, 4), np.float32)
    conf = np.zeros((n, d), np.float32)
    feat = np.zeros((n, d, f), np.float32)
    mask = np.zeros((n, d), bool)
    for s in range(n):
        for j in range(2):
            tlwh[s, j] = [150 + 300 * j + 4 * t, 300, 40, 80]
            conf[s, j] = 0.9
            feat[s, j] = feats[s, j]
            mask[s, j] = True
    return tlwh, conf, feat, mask


SCENE_CFG = dict(max_tracks=8, max_dets=4, feat_dim=32, nn_budget=5)


@pytest.mark.parametrize("n_devices", [1, 8])
@pytest.mark.parametrize("scene", ["handoff", "no_aliasing"])
def test_global_id_step_scenes_match_jax(scene, n_devices):
    """The reference's two scenes, 8 cameras: each framework's tracker,
    then its global-id step after every frame. Per frame the port's table
    equals the reference's (on a mesh of ``n_devices``), and the port's
    step on the reference's own states gives it too. Then the scene's own
    claim: the handoff keeps gid 1, no two live tracks share a gid."""
    n = 8
    port_trk, ref_trk = _scene_trackers(SCENE_CFG, n)
    ref_gid = _jax_gid_step(SCENE_CFG, n_devices, n)
    port_gid = _port_gid_step(SCENE_CFG, n)
    rng = np.random.default_rng(0 if scene == "handoff" else 3)
    if scene == "handoff":
        f_obj = rng.normal(size=32)
        f_obj /= np.linalg.norm(f_obj)
        frames = [partial(_handoff_inputs, SCENE_CFG, n, t, rng, f_obj)
                  for t in range(16)]
    else:
        feats = rng.normal(size=(n, 2, 32))
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        frames = [partial(_no_alias_inputs, SCENE_CFG, n, t, feats)
                  for t in range(6)]
    j_states = JS.init_stream_states(JTrackerConfig(**SCENE_CFG), n)
    t_states = TS.init_stream_states(TrackerConfig(**SCENE_CFG), n, "cpu")
    zeros = np.zeros((n, SCENE_CFG["max_tracks"]), np.int32)
    j_tab = t_tab = (zeros, zeros)
    for f, inputs in enumerate(frames):
        inputs = inputs()
        j_states, j_out, j_emit = ref_trk(j_states, *inputs)
        t_states, t_out, t_emit = port_trk(t_states, *inputs)
        j_arr, t_arr = _np(j_states), _np(t_states)
        for k in ("track_id", "state", "gallery_head", "gallery_count"):
            np.testing.assert_array_equal(t_arr[k], j_arr[k])
        new_j = ref_gid(j_arr, *j_tab)
        new_t = port_gid(t_arr, *t_tab)
        on_ref = port_gid(j_arr, *j_tab)  # the port's step, same inputs
        for got in (new_t, on_ref):
            np.testing.assert_array_equal(got[0], new_j[0], err_msg=f"{f}")
            np.testing.assert_array_equal(got[1], new_j[1], err_msg=f"{f}")
        j_tab, t_tab = new_j, new_t
    g, trk = t_tab[0], t_arr["state"]
    if scene == "handoff":
        lane = int(np.argmax(trk[n - 1] == STATE_CONFIRMED))
        assert trk[n - 1, lane] == STATE_CONFIRMED
        assert g[n - 1, lane] == 1, f"no handoff: gids cam {n - 1} = {g[-1]}"
        out_g = TS.relabel_outputs_global(
            t_out, TS.GlobalIDState(torch.from_numpy(g),
                                    torch.from_numpy(t_tab[1]))).numpy()
        assert out_g[n - 1][t_emit[n - 1].numpy()][0, 4] == 1
    else:
        live = g[trk == STATE_CONFIRMED]
        assert len(live) == 2 * n and len(set(live.tolist())) == 2 * n


@pytest.mark.parametrize("n_devices", [1, 8])
@pytest.mark.parametrize("seed", range(3))
def test_global_id_step_near_duplicates_match_jax(seed, n_devices):
    """Two chained rounds on seeded states with planted near-duplicate and
    duplicate galleries; a third at a looser threshold."""
    arrays, gid, owner, cfg = near_duplicate_scene(seed)
    n = arrays["state"].shape[0]
    adopted = 0
    for kw in ({}, {}, {"match_thresh": 0.5}):
        want = _jax_gid_step(cfg, n_devices, n, **kw)(arrays, gid, owner)
        got = _port_gid_step(cfg, n, **kw)(arrays, gid, owner)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        adopted += int((want[0] < gid).sum())
        gid, owner = want
    assert adopted > 0, "the scene adopted no gid"


@pytest.mark.parametrize("n_devices", [1, 8])
@pytest.mark.parametrize("kind", ["planted", "seeded"])
def test_cross_camera_matcher_matches_jax(kind, n_devices):
    arrays, queries, qmask, cfg = matcher_case(kind)
    n = queries.shape[0]
    mesh = JS.make_stream_mesh(n_devices)
    sharded = NamedSharding(mesh, P("stream"))
    want_id, want_d = JS.make_cross_camera_matcher(
        mesh, JTrackerConfig(**cfg))(
        _jax_states(arrays, mesh), jax.device_put(jnp.asarray(queries),
                                                  sharded),
        jax.device_put(jnp.asarray(qmask), sharded))
    got_id, got_d = TS.make_cross_camera_matcher(
        CPU_MESH, TrackerConfig(**cfg))(
        _torch_states(arrays), torch.from_numpy(queries),
        torch.from_numpy(qmask))
    np.testing.assert_array_equal(got_id.numpy(), np.asarray(want_id))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               atol=TOL_DIST, rtol=0)
    assert (got_id.numpy() == -1).any() and (got_id.numpy() >= 0).any()
    if kind == "planted":
        for c in range(n):
            assert got_id[c, 0] == 100 + (c + 1) % n
            assert got_d[c, 0] < 1e-4 and got_id[c, 1] == -1


def test_shared_gallery_and_mesh_of_one_rank():
    """A mesh of one rank has no group; its tiled gather is the identity,
    its stacked gather a new axis of one."""
    from yolo_deepsort_tpu_torch.parallel.mesh import all_gather

    assert CPU_MESH.group is None and (CPU_MESH.rank, CPU_MESH.size) == (0, 1)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert TS.shared_gallery_distance(CPU_MESH, x) is x
    assert torch.equal(all_gather(CPU_MESH, x, tiled=False), x[None])
    with pytest.raises(ValueError, match="do not divide"):
        TS.make_global_id_step(dataclasses.replace(CPU_MESH, size=2),
                               TrackerConfig(), 3)
    cfg = TrackerConfig(max_tracks=4, max_dets=2, feat_dim=8, nn_budget=3)
    step = TS.make_global_id_step(CPU_MESH, cfg, 3)
    with pytest.raises(ValueError, match="holds 2 streams"):
        step(TS.init_stream_states(cfg, 2, "cpu"),
             TS.init_global_ids(cfg, 2, "cpu"))
