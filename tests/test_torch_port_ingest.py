"""The decoded-video path of the port on the CPU: ``tools/soak.py
--ingest`` and the frame rings' waits.

* ``ensure_clips`` against the reference's ``_ensure_clips`` (``tools/
  soak.py``, loaded by file path): the same file names and, decoded, the
  same frames bit for bit;
* ``bound_label`` equal to ``_bound_label`` over a grid that reaches each
  of its four labels;
* the ingest loop (``ingest``: looping cv2 decoders -> ``FramePool`` ->
  two pinned-or-plain chunk buffers -> ``BucketedScannedStep`` pipelined
  one chunk deep) at yolov3-tiny-64, 2 streams of 64x128, K 2, on 5-frame
  clips, so the decoders loop and the rings fill: every chunk it uploads
  equals the clips' frames in order, looped and turned RGB, none lost or
  repeated; and the JAX package's bucketed step on those chunks (XLA
  letterbox and crops, the reference's ``bench_probes`` weights and
  per-stream thresholds on both sides) ends with exactly the same confirmed-track
  population per stream and id growth, and the last chunk's emitted rows
  with the same ids and boxes within 1 px. Both steps compute in float32
  here: in bfloat16 the two frameworks' forwards differ in the last bits
  (``test_torch_port_scanned_step.py``), which on these clips flips the
  association of one 3 x 4 px box on the frame's border in chunk 3 and so
  one id;
* ``main(["--ingest", "--device", "cpu", ...])``: one JSON line with the
  reference's keys, exit 0;
* F9: producers whose rings are full wait for the consumer's pop instead of
  retrying (``FramePool.push_wait``): ``MultiStreamTracker`` with rings of
  2 and a consumer that holds 0.2 s before each pop counts few full-ring
  rejections (``stats()["dropped"]``), and loses no frame.
"""

import contextlib
import importlib.util
import io
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from yolo_deepsort_tpu_torch.kernels.launches import LAUNCH_COUNTERS
from yolo_deepsort_tpu_torch.tools import soak as TS
from torch_port_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
HW, K, S, CLIP_FRAMES, CHUNKS = (64, 128), 2, 2, 5, 6
BUCKETS, WINDOWS = (16, 24, 32, 36, 40, 48), ((240, 128), (320, 192))
INGEST_KEYS = {"metric", "value", "unit", "decode_only_fps", "chunks",
               "frames", "minutes", "starved_frac", "decode_pushed_fps",
               "variants_seen", "capacity_bucket", "dets_bucket_max",
               "h2d_gbps", "transfer_ceiling_fps", "bound", "failures", "ok"}

pytestmark = [
    pytest.mark.skipif(importlib.util.find_spec("cv2") is None,
                       reason="needs cv2 (the clips are encoded and decoded)"),
    pytest.mark.skipif(shutil.which("g++") is None,
                       reason="needs g++ (the native frame ring is built at "
                              "first use)"),
]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ref_soak():
    return _load("reference_tool_soak", REPO / "tools" / "soak.py")


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    return TS.ensure_clips(str(tmp_path_factory.mktemp("clips")), S, HW,
                           CLIP_FRAMES)


def _decoded(path):
    """Every frame of ``path``, BGR, as cv2 decodes it."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


def test_ensure_clips_matches_the_reference(ref_soak, tmp_path):
    got = TS.ensure_clips(str(tmp_path / "port"), 2, (64, 128), 6)
    want = ref_soak._ensure_clips(str(tmp_path / "ref"), 2, (64, 128), 6)
    assert [Path(p).name for p in got] == [Path(p).name for p in want] == [
        "soak_0_64x128_6.mp4", "soak_1_64x128_6.mp4"]
    for a, b in zip(got, want):
        fa, fb = _decoded(a), _decoded(b)
        assert fa.shape == (6, 64, 128, 3)
        np.testing.assert_array_equal(fa, fb)
    # the clips differ from each other and from frame to frame
    assert not np.array_equal(_decoded(got[0]), _decoded(got[1]))
    assert not np.array_equal(_decoded(got[0])[0], _decoded(got[0])[1])
    # a clip already there is kept, not rewritten
    stamp = Path(got[0]).stat().st_mtime_ns
    TS.ensure_clips(str(tmp_path / "port"), 2, (64, 128), 6)
    assert Path(got[0]).stat().st_mtime_ns == stamp


# (achieved, decode_only, decode_during, transfer_ceiling): each label, and
# each threshold's two sides
BOUND_CASES = [
    (100.0, 105.0, 500.0, 500.0),   # host-decode
    (100.0, 110.5, 500.0, 500.0),
    (100.0, 500.0, 500.0, 125.0),   # h2d-transfer
    (100.0, 500.0, 500.0, 131.0),
    (100.0, 500.0, 150.0, 500.0),   # host-serialized
    (100.0, 500.0, 161.0, 500.0),   # chip
    (100.0, 110.0, 159.0, 129.0),
    (0.0, 0.0, 0.0, 0.0),
]


@pytest.mark.parametrize("case", BOUND_CASES)
def test_bound_label_matches_the_reference(ref_soak, case):
    assert TS.bound_label(*case) == ref_soak._bound_label(*case)


def test_bound_label_grid_reaches_every_label():
    labels = {TS.bound_label(*c) for c in BOUND_CASES}
    assert labels == {"host-decode", "h2d-transfer", "chip",
                      "host-serialized (decode+assembly+dispatch on one "
                      "core)"}


@pytest.fixture(scope="module")
def ingested(clips):
    """The port's ingest loop over ``clips`` on the reference's honest load
    (``tools/bench_probes.py``), thresholds recalibrated on the clips'
    first frames, one a stream, as the port's tool does. -> (every uploaded chunk, the loop's
    result, the reference's plan, folded params and per-stream
    thresholds)."""
    from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
    from yolo_deepsort_tpu_torch.models.darknet import Darknet
    from yolo_deepsort_tpu_torch.models.reid import random_reid_params
    from yolo_deepsort_tpu_torch.parallel.streams import (
        BucketedScannedStep,
        init_stream_states,
    )
    from yolo_deepsort_tpu_torch.runtime.native import FramePool
    from yolo_deepsort_tpu_torch.weights import (
        darknet_params_from_folded,
        reid_from_params,
    )

    probes = _load("reference_tool_bench_probes",
                   REPO / "tools" / "bench_probes.py")
    plan, det_params, _, _ = probes.bn_weights_and_frames(
        "yolov3-tiny", 64, 1, S, HW, 8)
    first = TS.first_frames_rgb(clips)
    conf_vec = np.array(probes.calibrate_conf(plan, det_params, first, 64,
                                              8))
    thr = float(conf_vec.mean())

    det = Darknet(plan)
    det.load_params(darknet_params_from_folded(
        jax.tree_util.tree_map(np.asarray, det_params)))
    det = det.eval()  # float32, as the JAX step below
    reid = reid_from_params(random_reid_params(0))
    trk = TrackerConfig(max_dets=64)
    step = BucketedScannedStep(det, reid, DetectorConfig(img_size=64,
                                                         conf_thres=thr),
                               trk, HW, buckets=BUCKETS, windows=WINDOWS,
                               conf_thres_per_stream=conf_vec)
    pool = FramePool(S, *HW, depth=max(2 * K, 8))
    decoders = TS.Decoders(clips, pool)
    stage = TS.ChunkStage(pool, decoders, K, torch.device("cpu"))
    chunks = []
    decoders.start()
    try:
        res = TS.ingest(step, init_stream_states(trk, S, "cpu"), stage,
                        CHUNKS, HW, tap=lambda f: chunks.append(f.numpy()))
    finally:
        decoders.close()
        pool.close()
    return chunks, res, (plan, det_params, conf_vec)


def test_ingest_chunks_are_the_clips_frames_in_order(clips, ingested):
    chunks, res, _ = ingested
    assert len(chunks) == 1 + CHUNKS  # the warm-up chunk, then the timed
    assert res["failures"] == [] and res["stats_readbacks"] == CHUNKS
    got = np.concatenate(chunks)  # (frames, S, H, W, 3)
    for i, path in enumerate(clips):
        rgb = _decoded(path)[:, :, :, ::-1]
        assert len(rgb) == CLIP_FRAMES
        want = rgb[np.arange(len(got)) % CLIP_FRAMES]  # looped
        np.testing.assert_array_equal(got[:, i], want, err_msg=f"stream {i}")


def test_ingest_matches_the_jax_bucketed_step(ingested):
    """The JAX package's bucketed step over the chunks the port's loop
    uploaded, warmed up as the loop is (its first chunk twice)."""
    from yolo_deepsort_tpu.config import DetectorConfig as JDet
    from yolo_deepsort_tpu.config import TrackerConfig as JTrk
    from yolo_deepsort_tpu.models.reid import random_reid_params as j_reid
    from yolo_deepsort_tpu.parallel import streams as JS

    chunks, res, (plan, det_params, conf_vec) = ingested
    trk = JTrk(max_dets=64)
    step = JS.make_scanned_step_bucketed(
        plan, JDet(img_size=64, conf_thres=float(conf_vec.mean())), trk, HW,
        buckets=BUCKETS, compute_dtype=jnp.float32,
        use_pallas_letterbox=False, use_pallas_crops=False,
        conf_thres_per_stream=conf_vec, donate_state=False, windows=WINDOWS)
    reid = jax.tree_util.tree_map(jnp.asarray, j_reid(0))
    states = JS.init_stream_states(trk, S)
    for _ in range(2):
        states, _ = step(det_params, reid, states, jnp.asarray(chunks[0]))
    base = int(jnp.max(states.next_id))  # id growth counts from here
    assert res["base_next_id"] == base
    for frames in chunks[1:]:
        states, (outputs, emit) = step(det_params, reid, states,
                                       jnp.asarray(frames))

    port = res["states"]
    confirmed = (port.state == 2).sum(-1).tolist()
    assert confirmed == np.asarray(jnp.sum(states.state == 2, -1)).tolist()
    assert sum(confirmed) > 0, "tracks confirmed"
    assert port.next_id.max().item() - base == int(
        jnp.max(states.next_id)) - base
    assert port.next_id.max().item() > base, "ids grew over the run"
    got = TS.emitted_rows(res["outputs"], res["emit"])
    want = np.asarray(outputs)[np.asarray(emit)]
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got[:, 4], want[:, 4])
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1)


def test_ingest_main_prints_one_json_line(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = TS.main([
            "--ingest", "--device", "cpu", "--model", "yolov3-tiny",
            "--img-size", "64", "--frame-h", str(HW[0]), "--frame-w",
            str(HW[1]), "--target-dets", "8", "--streams", str(S), "--scan",
            str(K), "--chunks", "4", "--clip-frames", str(CLIP_FRAMES),
            "--decode-probe-secs", "0.2", "--clip-dir", str(tmp_path)])
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert INGEST_KEYS <= set(rec), INGEST_KEYS - set(rec)
    assert rc == 0 and rec["ok"] and rec["failures"] == []
    assert (rec["chunks"], rec["frames"]) == (4, 4 * K * S)
    assert rec["route"] == "cpu" and rec["device"] == "cpu"
    assert rec["stats_readbacks"] == 4  # one a chunk
    assert set(rec["launches"]) == set(LAUNCH_COUNTERS)
    assert not any(rec["launches"].values())
    assert rec["decode_only_fps"] > 0 and rec["decode_pushed_fps"] > 0
    assert 0 <= rec["starved_frac"] <= 1
    assert sum(rec["variants_seen"].values()) == 4
    assert len(list(tmp_path.glob("soak_*_64x128_5.mp4"))) == S


def test_ingest_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.run(["--ingest"])


def _block_clip(path, n, h, w, seed):
    from yolo_deepsort_tpu_torch.runtime.video import VideoWriter

    rng = np.random.default_rng(seed)
    wri = VideoWriter(str(path), 10.0, (w, h))
    for _ in range(n):
        blocks = rng.integers(0, 256, (h // 8, w // 8, 3), np.uint8)
        wri.write(np.kron(blocks, np.ones((8, 8, 1), np.uint8)))
    wri.release()


def test_full_rings_make_producers_wait_not_spin(tmp_path):
    """F9: with rings of 2 and a consumer that holds 0.2 s before each pop,
    each producer finds its ring full about once a pop and then waits for
    the pop. Retrying in a loop instead rejects thousands of pushes. Every
    frame still arrives once, in order."""
    from yolo_deepsort_tpu_torch import api as PA
    from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
    from yolo_deepsort_tpu_torch.models.reid import random_reid_params
    from yolo_deepsort_tpu_torch.runtime.multistream import MultiStreamTracker

    h, w, n = 64, 96, 8
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"s{i}.mp4"))
        _block_clip(paths[-1], n, h, w, i)
    mst = MultiStreamTracker(
        PA.Darknet("yolov3-tiny", img_size=64, device="cpu"), paths,
        random_reid_params(0), (h, w),
        tracker_config=TrackerConfig(max_tracks=8, max_dets=4, nn_budget=4),
        det_config=DetectorConfig(img_size=64, conf_thres=0.3), half=False,
        ring_depth=2)
    seen = np.zeros(2, int)
    steps = 0
    gen = mst.run()
    try:
        while True:
            time.sleep(0.2)  # the consumer is busy; the rings stay full
            try:
                _, _, valid = next(gen)
            except StopIteration:
                break
            seen += valid
            steps += 1
    finally:
        gen.close()
        dropped = mst.stats()["dropped"]
        mst.close()
    assert seen.tolist() == [n, n], "every frame arrived once"
    assert dropped <= 4 * steps * 2, (dropped, steps)
