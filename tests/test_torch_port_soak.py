"""The port's serving soaks (``yolo_deepsort_tpu_torch/tools/soak.py``,
``soak_multichip.py``) on the CPU:

* ``soak.py`` at yolov3-tiny-64, 2 streams of 64x128, K 2, 6 chunks,
  checks every 2: ``ok``, one JSON line with the reference's keys, one
  stats readback a chunk, no launch counted (CPU tensors take the plain
  versions);
* its soak loop on the reference's honest load (``tools/bench_probes.py``)
  against the JAX package's bucketed step over the same chunks: the
  confirmed-track population at every check and the id growth exactly
  equal;
* its checker lists a NaN planted into the Kalman mean, an inf in the
  covariance, a gallery over budget and a drifted population;
* ``soak_multichip.py`` on 2 gloo ranks (started once, at the first test,
  beside the others; at most 120 s, every child killed on expiry): ``ok``
  on both, the same verdict, gids stable on stable lanes; its summary flags
  a stable lane whose gid changed and not a recycled one.
"""

import contextlib
import dataclasses
import io
import json
import os
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
from yolo_deepsort_tpu_torch.kernels.launches import LAUNCH_COUNTERS
from yolo_deepsort_tpu_torch.config import TrackerConfig
from yolo_deepsort_tpu_torch.parallel.mesh import make_stream_mesh
from yolo_deepsort_tpu_torch.parallel.streams import (
    GlobalIDState,
    init_stream_states,
)
from yolo_deepsort_tpu_torch.tools import soak as TS
from yolo_deepsort_tpu_torch.tools import soak_multichip as TM
from torch_port_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TIME_LIMIT = 120  # seconds, both ranks together
TINY = ["--model", "yolov3-tiny", "--img-size", "64", "--frame-h", "64",
        "--frame-w", "128", "--target-dets", "8", "--check-every", "2"]
SOAK_ARGV = TINY + ["--streams", "2", "--scan", "2", "--chunks", "6",
                    "--device", "cpu"]
MULTI_ARGV = TINY + ["--frames-per-chunk", "2", "--chunks", "4",
                     "--device", "cpu"]
SOAK_KEYS = {"metric", "value", "unit", "chunks", "frames", "minutes",
             "tracks_mean", "tracks_min", "tracks_max", "id_growth_per_chunk",
             "failures", "ok"}
MULTI_KEYS = {"metric", "value", "unit", "devices", "chunks", "frames",
              "minutes", "tracks_mean", "id_growth_per_chunk", "failures",
              "ok"}


class Ranks:
    """Both gloo ranks of the multichip soak, started together."""

    def __init__(self, world: int = 2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = cpu_subprocess_env(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        self.deadline = time.monotonic() + TIME_LIMIT
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "yolo_deepsort_tpu_torch.tools."
             "soak_multichip", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(world), "--process-id", str(r)]
            + MULTI_ARGV, cwd=REPO, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for r in range(world)]
        self.outs = None

    def results(self):
        """-> [(returncode, stdout, stderr)] of every rank; on expiry every
        child is killed and the test fails."""
        if self.outs is None:
            outs = []
            try:
                for p in self.procs:
                    left = max(1.0, self.deadline - time.monotonic())
                    out, err = p.communicate(timeout=left)
                    outs.append((p.returncode, out, err))
            except subprocess.TimeoutExpired:
                pytest.fail(f"the ranks did not finish within {TIME_LIMIT} s")
            finally:
                self.kill()
            self.outs = outs
        return self.outs

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", autouse=True)
def ranks():
    r = Ranks()
    try:
        yield r
    finally:
        r.kill()


@pytest.fixture(scope="module")
def soak_main():
    """``soak.main`` at the tiny size: (its exit code, its stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = TS.main(SOAK_ARGV)
    return rc, out.getvalue()


def test_soak_main_prints_one_json_line(soak_main):
    rc, out = soak_main
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert SOAK_KEYS <= set(rec), SOAK_KEYS - set(rec)
    assert rc == 0 and rec["ok"] and rec["failures"] == []
    assert rec["route"] == "cpu" and rec["device"] == "cpu"
    assert (rec["chunks"], rec["frames"], rec["checks"]) == (6, 24, 3)
    assert rec["stats_readbacks"] == 6  # one a chunk
    assert set(rec["launches"]) == set(LAUNCH_COUNTERS)
    assert not any(rec["launches"].values())
    assert rec["tracks_min"] > 0


def test_soak_matches_the_jax_bucketed_step():
    """The port's soak loop (``soak.soak``) and the reference's (3 warm-up
    chunks, then the counted ones) over the JAX package's bucketed step,
    both on the reference's honest load (``tools/bench_probes.py``: the
    same folded weights, frames and thresholds): the confirmed-track
    population after the warm-up and at every check, and the id growth,
    exactly equal. (The reference tool takes the Pallas letterbox, which
    the CPU backend refuses: the JAX step is built with the XLA letterbox
    and crops here.)"""
    import importlib.util

    from yolo_deepsort_tpu.config import DetectorConfig as JDet
    from yolo_deepsort_tpu.config import TrackerConfig as JTrk
    from yolo_deepsort_tpu.models.reid import random_reid_params as j_reid
    from yolo_deepsort_tpu.parallel import streams as JS
    from yolo_deepsort_tpu_torch.config import DetectorConfig
    from yolo_deepsort_tpu_torch.models.darknet import Darknet
    from yolo_deepsort_tpu_torch.models.reid import random_reid_params
    from yolo_deepsort_tpu_torch.parallel.streams import BucketedScannedStep
    from yolo_deepsort_tpu_torch.weights import (
        darknet_params_from_folded,
        reid_from_params,
    )

    spec = importlib.util.spec_from_file_location(
        "reference_tool_bench_probes", REPO / "tools" / "bench_probes.py")
    probes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probes)
    k, s, hw, chunks, every = 2, 2, (64, 128), 6, 2
    plan, det_params, frames, conf_vec = probes.bn_weights_and_frames(
        "yolov3-tiny", 64, k, s, hw, 8)
    conf_vec = np.array(conf_vec)
    buckets = (16, 24, 32, 36, 40, 48)
    trk = JTrk(max_dets=64)
    step = JS.make_scanned_step_bucketed(
        plan, JDet(img_size=64, conf_thres=float(conf_vec.mean())), trk,
        hw, buckets=buckets, compute_dtype=jnp.bfloat16,
        use_pallas_letterbox=False, use_pallas_crops=False,
        conf_thres_per_stream=conf_vec, donate_state=False)
    states = JS.init_stream_states(trk, s)
    tracks = []
    for i in range(3 + chunks):
        states, _ = step(det_params, jax.tree_util.tree_map(
            jnp.asarray, j_reid(0)), states, frames)
        tracks.append(float(jnp.mean(jnp.sum(states.state == 2, -1))))
        if i == 2:
            base_id = int(jnp.max(states.next_id))
    growth = int(jnp.max(states.next_id)) - base_id

    det = Darknet(plan)
    det.load_params(darknet_params_from_folded(
        jax.tree_util.tree_map(np.asarray, det_params)))
    det = det.eval().to(torch.bfloat16, memory_format=torch.channels_last)
    reid = reid_from_params(random_reid_params(0)).to(
        torch.bfloat16, memory_format=torch.channels_last)
    t_trk = TrackerConfig(max_dets=64)
    t_step = BucketedScannedStep(
        det, reid, DetectorConfig(img_size=64,
                                  conf_thres=float(conf_vec.mean())),
        t_trk, hw, buckets=buckets, conf_thres_per_stream=conf_vec)
    res = TS.soak(t_step, init_stream_states(t_trk, s, "cpu"),
                  torch.from_numpy(np.array(frames)), chunks, every,
                  t_trk.nn_budget, hw)
    assert res["failures"] == [] and tracks[2] > 0
    assert res["base_tracks"] == tracks[2]
    assert res["track_counts"] == tracks[3 + every - 1::every]
    assert res["id_growth"] == growth


def _states(cfg, n=2):
    st = init_stream_states(cfg, n, "cpu")
    return dataclasses.replace(
        st, state=torch.full_like(st.state, 2),
        track_id=torch.arange(1, st.track_id.numel() + 1, dtype=torch.int32
                              ).reshape(st.track_id.shape))


@pytest.mark.parametrize("fault", ["nan mean", "inf cov", "over budget",
                                   "drift", "none"])
def test_soak_checker_lists_what_is_planted(fault):
    cfg = TrackerConfig(max_tracks=8, max_dets=4, feat_dim=8, nn_budget=3)
    st = _states(cfg)
    if fault == "nan mean":
        st.mean[1, 3, 0] = float("nan")
    elif fault == "inf cov":
        st.cov[0, 0, 2, 2] = float("inf")
    elif fault == "over budget":
        st.gallery_count[0, 5] = cfg.nn_budget + 1
    base = 8.0 if fault != "drift" else 20.0
    summary = TS.summarize(st, cfg.nn_budget).tolist()
    failures = TS.check(summary, base, "chunk 7")
    want = {"nan mean": "non-finite tracker state",
            "inf cov": "non-finite tracker state",
            "over budget": "gallery_count over budget",
            "drift": "track population drifted 20.0 -> 8.0"}.get(fault)
    if want is None:
        assert failures == []
    else:
        assert failures == [f"chunk 7: {want}"]


def test_multichip_summary_flags_a_relabelled_stable_lane():
    """A lane whose track id stayed and whose gid changed is flagged; a
    lane whose track id changed (recycled) may change its gid; a free lane
    is ignored."""
    cfg = TrackerConfig(max_tracks=8, max_dets=4, feat_dim=8, nn_budget=3)
    mesh = make_stream_mesh(1, device="cpu")
    st = _states(cfg, 1)
    gid = torch.arange(1, 9, dtype=torch.int32)[None]
    gids = GlobalIDState(gid=gid, owner=st.track_id.clone())

    def flagged(prev_tid, prev_gid):
        return TM.summarize(mesh, st, gids, prev_tid, prev_gid,
                            cfg.nn_budget).tolist()[3]

    tid = st.track_id.clone()
    assert flagged(tid, gid.clone()) == 0
    recycled_tid, relabelled = tid.clone(), gid.clone()
    recycled_tid[0, 2] += 100
    relabelled[0, 2] += 1
    assert flagged(recycled_tid, relabelled) == 0
    relabelled[0, 4] += 1
    assert flagged(recycled_tid, relabelled) == 1
    free = _states(cfg, 1)
    free.track_id[0, 4] = 0
    only4 = gid.clone()
    only4[0, 4] += 1
    assert TM.summarize(mesh, free, gids, free.track_id.clone(), only4,
                        cfg.nn_budget).tolist()[3] == 0


def test_multichip_soak_two_gloo_ranks(ranks):
    recs = []
    for rank, (rc, out, err) in enumerate(ranks.results()):
        lines = out.strip().splitlines()
        assert rc == 0 and lines, f"rank {rank} failed:\n{err[-4000:]}"
        rec = json.loads(lines[-1])
        assert MULTI_KEYS <= set(rec), MULTI_KEYS - set(rec)
        assert rec["ok"] and rec["failures"] == [], rec["failures"]
        assert (rec["rank"], rec["devices"], rec["backend"]) == (rank, 2,
                                                                 "gloo")
        assert (rec["chunks"], rec["frames"], rec["checks"]) == (4, 16, 2)
        assert rec["tracks_mean"] > 0  # stable lanes were there to check
        assert not any(rec["launches"].values())
        recs.append(rec)
    # one all-reduced summary: every rank reaches the same verdict
    assert recs[0]["tracks_mean"] == recs[1]["tracks_mean"]
    assert recs[0]["id_growth_per_chunk"] == recs[1]["id_growth_per_chunk"]
