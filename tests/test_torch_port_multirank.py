"""The port's stream mesh across processes: gloo ranks on the CPU.

Each test starts ``world`` Python processes on 127.0.0.1 (one intra-op
thread each), every rank computing its S / world streams, and holds what
they give, gathered, to the port on a mesh of one rank -- exactly equal --
and, for the sharded serving step, to the JAX package on 2 devices:

* the global-id step (three chained rounds) and the cross-camera matcher on
  seeded states with planted near-duplicate galleries, at 2 and 4 ranks;
* ``make_sharded_step`` (yolov3-tiny at 96 px, f32, 2 streams of 64x96) at
  2 ranks, against the one-rank port and the reference's sharded step;
* the port's dryrun tool with 2 CPU processes: the cross-rank handoff line.

A test's processes share one time limit of at most 120 s; on expiry every
child is killed and the test fails.
"""

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import cpu_subprocess_env
from specs.weights_np import random_darknet_weights
from yolo_deepsort_tpu.cfg.architectures import ARCHITECTURES
from yolo_deepsort_tpu.config import DetectorConfig as JDetectorConfig
from yolo_deepsort_tpu.config import TrackerConfig as JTrackerConfig
from yolo_deepsort_tpu.models import weights as W
from yolo_deepsort_tpu.models.darknet import build_network as j_build
from yolo_deepsort_tpu.models.darknet import network_apply
from yolo_deepsort_tpu.models.reid import random_reid_params as j_reid_params
from yolo_deepsort_tpu.ops.letterbox import letterbox as j_letterbox
from yolo_deepsort_tpu.parallel import streams as JS
from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
from yolo_deepsort_tpu_torch.models.darknet import build_network
from yolo_deepsort_tpu_torch.models.reid import random_reid_params
from yolo_deepsort_tpu_torch.parallel import streams as TS
from yolo_deepsort_tpu_torch.weights import darknet_from_raw, reid_from_params

from test_torch_port_global_ids import CPU_MESH, _torch_gids, _torch_states
from test_torch_port_global_ids_gpu import matcher_case, near_duplicate_scene
from test_torch_port_slice import _plant_small_boxes
from test_torch_port_tracking import DISCRETE

REPO = Path(__file__).resolve().parent.parent
TIME_LIMIT = 120  # seconds, all of a test's processes together

# One rank: reads the case, runs its streams' slice, writes its results.
WORKER = r"""
import pickle, sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, port, case_path, out_path = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
try:
    from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
    from yolo_deepsort_tpu_torch.parallel import streams as TS
    from yolo_deepsort_tpu_torch.tracking.tracker import TrackerState

    with open(case_path, "rb") as f:
        case = pickle.load(f)
    mesh = TS.make_stream_mesh(world, device="cpu")
    assert (mesh.rank, mesh.size) == (rank, world)
    n = case["n_streams"]
    mine = slice(rank * n // world, (rank + 1) * n // world)
    res = {}
    if case["job"] == "gid":
        arrays = {k: torch.from_numpy(v[mine]) for k, v in
                  case["arrays"].items()}
        states = TrackerState(**arrays)
        cfg = TrackerConfig(**case["cfg"])
        gids = TS.GlobalIDState(torch.from_numpy(case["gid"][mine]),
                                torch.from_numpy(case["owner"][mine]))
        res["gid"] = []
        for kw in case["rounds"]:
            gids = TS.make_global_id_step(mesh, cfg, n, **kw)(states, gids)
            res["gid"].append((gids.gid.numpy(), gids.owner.numpy()))
        ids, d = TS.make_cross_camera_matcher(mesh, cfg)(
            states, torch.from_numpy(case["queries"][mine]),
            torch.from_numpy(case["qmask"][mine]))
        res["match"] = (ids.numpy(), d.numpy())
    else:  # the sharded serving step
        from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
        from yolo_deepsort_tpu_torch.models.darknet import build_network
        from yolo_deepsort_tpu_torch.models.reid import random_reid_params
        from yolo_deepsort_tpu_torch.weights import (darknet_from_raw,
                                                     reid_from_params)

        plan = build_network(ARCHITECTURES["yolov3-tiny"](img_size=96))
        step = TS.make_sharded_step(
            mesh, darknet_from_raw(plan, case["raw"]),
            reid_from_params(random_reid_params(0)),
            DetectorConfig(**case["det_cfg"]),
            TrackerConfig(**case["trk_cfg"]), case["frame_hw"])
        states = TS.init_stream_states(TrackerConfig(**case["trk_cfg"]),
                                       mine.stop - mine.start, "cpu")
        res["frames"] = []
        for frames in case["frames"]:
            states, (out, emit) = step(states, torch.from_numpy(
                frames[mine]))
            res["frames"].append((out.numpy(), emit.numpy(), {
                k: getattr(states, k).numpy().copy()
                for k in case["fields"]}))
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
finally:
    dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = cpu_subprocess_env(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _run_ranks(argvs, timeout=TIME_LIMIT):
    """Start every argv at once; -> their outputs. All share ``timeout``;
    on expiry, or when one fails, every child is killed."""
    procs = [subprocess.Popen(a, cwd=REPO, env=_env(), text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for a in argvs]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for i, p in enumerate(procs):
            left = max(1.0, deadline - time.monotonic())
            out, _ = p.communicate(timeout=left)
            outs.append(out)
            assert p.returncode == 0, f"rank {i} failed:\n{out[-4000:]}"
    except subprocess.TimeoutExpired:
        pytest.fail(f"the ranks did not finish within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _run_worker(tmp_path, case, world):
    """Run ``WORKER`` on ``world`` gloo ranks; -> each rank's results."""
    case_path = tmp_path / "case.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(case, f)
    port = _free_port()
    outs = [tmp_path / f"rank{r}.pkl" for r in range(world)]
    _run_ranks([[sys.executable, "-c", WORKER, str(r), str(world), str(port),
                 str(case_path), str(outs[r])] for r in range(world)])
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


ROUNDS = ({}, {}, {"match_thresh": 0.5})


@pytest.mark.parametrize("world", [2, 4])
def test_gid_step_and_matcher_are_mesh_size_invariant(tmp_path, world):
    """On 2 and 4 gloo ranks the gathered gid tables, matcher ids AND
    matcher distances equal the one-rank port's bit for bit."""
    arrays, gid, owner, cfg = near_duplicate_scene(0)
    _, queries, qmask, _ = matcher_case("seeded")
    n = arrays["state"].shape[0]
    ranks = _run_worker(tmp_path, dict(
        job="gid", n_streams=n, arrays=arrays, gid=gid, owner=owner, cfg=cfg,
        rounds=ROUNDS, queries=queries, qmask=qmask), world)

    states, tcfg = _torch_states(arrays), TrackerConfig(**cfg)
    gids = _torch_gids(gid, owner)
    for r, kw in enumerate(ROUNDS):
        gids = TS.make_global_id_step(CPU_MESH, tcfg, n, **kw)(states, gids)
        for part, want in enumerate((gids.gid, gids.owner)):
            got = np.concatenate([res["gid"][r][part] for res in ranks])
            np.testing.assert_array_equal(got, want.numpy(),
                                          err_msg=f"round {r}")
    assert (gids.gid.numpy() < gid).any(), "the scene adopted no gid"
    ids, dist = TS.make_cross_camera_matcher(CPU_MESH, tcfg)(
        states, torch.from_numpy(queries), torch.from_numpy(qmask))
    got_ids = np.concatenate([res["match"][0] for res in ranks])
    got_d = np.concatenate([res["match"][1] for res in ranks])
    np.testing.assert_array_equal(got_ids, ids.numpy())
    np.testing.assert_array_equal(got_d, dist.numpy())
    # a rank's best can lie on another rank: queries of rank 0 found
    # tracks that only other ranks hold
    own = set(arrays["track_id"][: n // world].ravel().tolist())
    assert any(i >= 0 and i not in own for i in got_ids[: n // world].ravel())


H, W_, SIZE, FRAMES = 64, 96, 96, 5


def _sharded_case():
    defs = ARCHITECTURES["yolov3-tiny"](img_size=SIZE)
    jplan = j_build(defs)
    blob = random_darknet_weights(jplan.defs(), seed=0, well_conditioned=True)
    _, raw = W.load_darknet_weights(blob, jplan.defs())
    raw = _plant_small_boxes(raw, jplan)
    folded = W.fold_inference_params(raw, jplan.defs())
    base = np.random.default_rng(0).integers(0, 256, (2, H, W_, 3), np.uint8)
    # one threshold, halfway between two objectness values around the 5th
    # per stream, so last-ulp differences flip no candidate
    dec = np.asarray(network_apply(
        jplan, folded, jax.vmap(lambda f: j_letterbox(f, SIZE))(base)))
    obj = np.sort(dec[..., 4].ravel())[::-1]
    thr = float((obj[2 * 5 - 1] + obj[2 * 5]) / 2)
    return dict(jplan=jplan, folded=folded, raw=raw, frames=[base] * FRAMES,
                det_cfg=dict(img_size=SIZE, conf_thres=thr, max_dets=8),
                trk_cfg=dict(max_tracks=16, max_dets=8, nn_budget=4))


def test_sharded_step_two_ranks_match_one_rank_and_jax(tmp_path):
    """yolov3-tiny-96, f32, 2 streams: the port on 2 gloo ranks (a stream
    each) and on one rank give the reference's rows on 2 devices; per
    frame emit, rows and discrete state exactly equal, Kalman means within
    the tracker's tolerance (rtol 2e-4, atol 2e-3)."""
    case = _sharded_case()
    fields = list(DISCRETE) + ["mean"]
    ranks = _run_worker(tmp_path, dict(
        job="sharded", n_streams=2, raw=case["raw"],
        frames=case["frames"], det_cfg=case["det_cfg"],
        trk_cfg=case["trk_cfg"], frame_hw=(H, W_), fields=fields), 2)

    mesh = JS.make_stream_mesh(2)
    j_step = JS.make_sharded_step(
        mesh, case["jplan"], JDetectorConfig(**case["det_cfg"]),
        JTrackerConfig(**case["trk_cfg"]), (H, W_))
    j_states = JS.init_stream_states(JTrackerConfig(**case["trk_cfg"]), 2)
    tplan = build_network(ARCHITECTURES["yolov3-tiny"](img_size=SIZE))
    t_step = TS.make_sharded_step(
        CPU_MESH, darknet_from_raw(tplan, case["raw"]),
        reid_from_params(random_reid_params(0)),
        DetectorConfig(**case["det_cfg"]),
        TrackerConfig(**case["trk_cfg"]), (H, W_))
    t_states = TS.init_stream_states(TrackerConfig(**case["trk_cfg"]), 2,
                                     "cpu")
    emitted = 0
    for f, frames in enumerate(case["frames"]):
        j_states, (j_out, j_emit) = j_step(case["folded"], j_reid_params(0),
                                           j_states, jnp.asarray(frames))
        t_states, (t_out, t_emit) = t_step(t_states,
                                           torch.from_numpy(frames))
        r_out = np.concatenate([r["frames"][f][0] for r in ranks])
        r_emit = np.concatenate([r["frames"][f][1] for r in ranks])
        for tag, out, emit in (("one rank", t_out.numpy(), t_emit.numpy()),
                               ("two ranks", r_out, r_emit)):
            np.testing.assert_array_equal(emit, np.asarray(j_emit),
                                          err_msg=f"{tag} frame {f}")
            np.testing.assert_array_equal(out, np.asarray(j_out),
                                          err_msg=f"{tag} frame {f}")
        for k in DISCRETE:
            want = np.asarray(getattr(j_states, k))
            got = np.concatenate([r["frames"][f][2][k] for r in ranks])
            np.testing.assert_array_equal(getattr(t_states, k).numpy(), want,
                                          err_msg=f"{k} frame {f}")
            np.testing.assert_array_equal(got, want, err_msg=f"{k} frame {f}")
        got_mean = np.concatenate([r["frames"][f][2]["mean"] for r in ranks])
        for mean in (t_states.mean.numpy(), got_mean):
            np.testing.assert_allclose(mean, np.asarray(j_states.mean),
                                       rtol=2e-4, atol=2e-3)
        emitted += int(t_emit.sum())
    assert emitted > 0, "tracks confirmed and were emitted"


def test_dryrun_tool_two_cpu_processes():
    """The port's dryrun tool, 2 gloo ranks of 4 streams: the sharded step
    on every rank, and the object that leaves rank 0's first stream keeps
    gid 1 on rank 1's last stream."""
    port = _free_port()
    tool = "yolo_deepsort_tpu_torch.tools.dryrun_multihost"
    outs = _run_ranks([
        [sys.executable, "-m", tool, "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(i), "--device", "cpu"]
        for i in range(2)])
    assert "tracking + collectives ok" in outs[0], outs[0][-2000:]
    assert "cross-host global-id handoff ok" in outs[1], outs[1][-2000:]
    for i, out in enumerate(outs):
        assert f"rank {i}: sharded tracking step ok" in out, out[-2000:]
