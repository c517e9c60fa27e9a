"""The port's single-video bench (``yolo_deepsort_tpu_torch/tools/
bench_video.py``) on the CPU, at yolov3-tiny-64 on a 64x128 clip, chunk 2,
8 frames a pass:

* ``main(["--device", "cpu", ...])`` prints one JSON line with the
  reference tool's keys, ``frames == 8``, no launch counted (CPU tensors
  take the plain versions) and 5 chunks enqueued by the timed pass (the
  generator runs one chunk deep);
* the timed pass's emitted rows equal, in number, those of the JAX
  package's ``VideoTracker.track(chunk=2)`` run the same way (two warm
  passes, then the timed one) on the same clip, ``.weights`` file and
  threshold;
* asked for the card without one, it raises.
"""

import contextlib
import importlib.util
import io
import json

import pytest
import torch

import jax  # noqa: E402,F401

from yolo_deepsort_tpu_torch.kernels.launches import LAUNCH_COUNTERS
from yolo_deepsort_tpu_torch.tools import bench_video as TB

ARGV = ["--model", "yolov3-tiny", "--img-size", "64", "--frame-h", "64",
        "--frame-w", "128", "--target-dets", "8", "--chunk", "2",
        "--frames", "8"]
BENCH_KEYS = {"metric", "value", "unit", "steady_fps", "chunk_p50_ms",
              "slow_chunks", "chunk", "frames", "tracks_per_frame",
              "per_frame_mode_steady_fps", "h2d_gbps",
              "transfer_ceiling_fps", "transfer_bound", "clip"}

pytestmark = pytest.mark.skipif(
    importlib.util.find_spec("cv2") is None,
    reason="needs cv2 (the clip is encoded and decoded)")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("clips"))


@pytest.fixture(scope="module")
def record(clip_dir):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = TB.main(ARGV + ["--device", "cpu", "--clip-dir", clip_dir])
    lines = out.getvalue().strip().splitlines()
    assert rc == 0 and len(lines) == 1
    return json.loads(lines[0])


def test_bench_video_main_prints_one_json_line(record):
    assert BENCH_KEYS <= set(record), BENCH_KEYS - set(record)
    assert (record["frames"], record["chunk"]) == (8, 2)
    assert record["route"] == "cpu" and record["device"] == "cpu"
    assert record["chunks_run"] == 5  # 4 drawn, one more enqueued
    assert set(record["launches"]) == set(LAUNCH_COUNTERS)
    assert not any(record["launches"].values())
    assert record["clip"].endswith("soak_0_64x128_120.mp4")
    assert record["dets"] > 0 and record["value"] > 0


def test_bench_video_matches_the_jax_video_tracker(record, clip_dir,
                                                   tmp_path):
    from yolo_deepsort_tpu import api as JA

    args = TB.parser().parse_args(ARGV + ["--clip-dir", clip_dir])
    path = str(tmp_path / "honest.weights")
    _, thr, clip = TB.honest_video_model(args, torch.device("cpu"), path)
    assert thr == record["conf_thres"] and clip == record["clip"]
    model = JA.Darknet("yolov3-tiny", img_size=64)
    model.load_darknet_weights(path)
    vt = JA.VideoTracker(model, tracked_classes=None, conf_thres=thr,
                         half=True)
    for _ in range(2):
        TB.run_pass(vt, clip, 2, 8)
    n, dets, _, _ = TB.run_pass(vt, clip, 2, 8)
    assert (n, dets) == (record["frames"], record["dets"])


def test_bench_video_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.run([])
