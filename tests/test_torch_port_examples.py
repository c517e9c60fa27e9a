"""The port's example CLIs (``yolo_deepsort_tpu_torch/examples/``) and the
two facade arguments they complete, on the CPU:

* every example parses ``--help`` in a subprocess (imports and argument
  wiring; ``--device`` among the arguments), one process per file;
* ``ops/letterbox.py`` ``letterbox_nearest_batch`` bit for bit equal to the
  reference's ``letterbox(..., interp="nearest")``, and
  ``ImageDetector(interp="nearest")`` against the reference facade's rows
  (the tolerances of ``test_torch_port_api.py``'s detector test);
* ``Extractor(max_batch=4)`` on 5 crops: the features of the port's
  extractor without it, bit for bit, and the reference's with it within
  ``test_torch_port_api.py``'s extractor tolerance;
* the examples end to end as ``tests/test_examples.py`` runs the
  originals, with ``--device cpu`` (``slow``: a subprocess each, and the
  video examples need ``cv2``).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

import yolo_deepsort_tpu.api as JA
from conftest import cpu_subprocess_env
from yolo_deepsort_tpu.ops.letterbox import letterbox as j_letterbox
from yolo_deepsort_tpu_torch import api as PA
from yolo_deepsort_tpu_torch.ops.letterbox import letterbox_nearest_batch
from torch_port_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = ("detect_image", "detect_folder", "track_video",
            "track_multicamera", "make_demo")


def _run(args, timeout=900):
    return subprocess.run(
        [sys.executable, "-m", "yolo_deepsort_tpu_torch.examples." + args[0],
         *args[1:]], capture_output=True, text=True, cwd=REPO,
        env=cpu_subprocess_env(OMP_NUM_THREADS="2"), timeout=timeout)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_help(name):
    r = _run([name, "--help"], timeout=120)
    assert r.returncode == 0, r.stderr[-800:]
    assert "--device" in r.stdout


@pytest.mark.parametrize("hw", [(144, 192), (192, 144), (100, 100),
                                (1080, 1920), (37, 50)])
@pytest.mark.parametrize("size", [96, 416])
def test_nearest_letterbox_matches_the_reference(hw, size):
    frame = np.random.default_rng(sum(hw)).integers(0, 256, hw + (3,),
                                                    np.uint8)
    got = letterbox_nearest_batch(torch.from_numpy(frame[None]), size)
    want = np.asarray(j_letterbox(jnp.asarray(frame), size, interp="nearest"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), want)
    half = letterbox_nearest_batch(torch.from_numpy(frame[None]), size,
                                   torch.bfloat16)
    assert torch.equal(half, got.to(torch.bfloat16))


@pytest.fixture(scope="module")
def models():
    return PA.Darknet("yolov3-tiny", img_size=96, device="cpu"), JA.Darknet(
        "yolov3-tiny", img_size=96)


def test_image_detector_nearest_matches_the_reference(models):
    frame = np.random.default_rng(1).integers(0, 256, (144, 192, 3), np.uint8)
    got = PA.ImageDetector(models[0], conf_thres=0.3,
                           interp="nearest").detect(frame)
    want = JA.ImageDetector(models[1], conf_thres=0.3,
                            interp="nearest").detect(frame)
    bilinear = PA.ImageDetector(models[0], conf_thres=0.3).detect(frame)
    assert got.shape == want.shape and len(got) > 4
    np.testing.assert_array_equal(got[:, 6], want[:, 6])
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-2)
    np.testing.assert_allclose(got[:, 4:6], want[:, 4:6], atol=1e-4)
    assert got.shape != bilinear.shape or not np.allclose(got, bilinear)
    with pytest.raises(ValueError, match="interp"):
        PA.ImageDetector(models[0], interp="bicubic")


def test_extractor_max_batch_matches_the_reference():
    rng = np.random.default_rng(7)
    crops = [rng.integers(0, 256, (h, w, 3), np.uint8)
             for h, w in ((100, 40), (128, 64), (220, 90), (37, 19),
                          (64, 64))]
    ext = PA.Extractor(max_batch=4, device="cpu")
    assert ext.max_batch == 4
    got = ext(crops)
    assert got.shape == (5, 512)
    np.testing.assert_array_equal(got, PA.Extractor(device="cpu")(crops))
    want = JA.Extractor(max_batch=4)(crops)
    np.testing.assert_allclose(got, want, atol=5e-4)


def _image(path, seed, hw=(96, 96)):
    from PIL import Image

    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, hw + (3,), np.uint8)).save(path)


def _clip(path, seed, frames=3):
    from yolo_deepsort_tpu_torch.runtime.video import VideoWriter

    wri = VideoWriter(str(path), 10.0, (96, 72))
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        wri.write(rng.integers(0, 256, (72, 96, 3), np.uint8))
    wri.release()


TINY = ["--cfg", "yolov3-tiny", "--img-size", "96", "--device", "cpu"]


@pytest.mark.slow
def test_detect_image_example(tmp_path):
    _image(tmp_path / "in.jpg", 0)
    out = tmp_path / "out.jpg"
    r = _run(["detect_image", str(tmp_path / "in.jpg"), *TINY,
              "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists() and "detections ->" in r.stdout


@pytest.mark.slow
def test_detect_folder_example(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(2):
        _image(d / f"{i}.jpg", 1 + i)
    out_dir = tmp_path / "out"
    r = _run(["detect_folder", str(d), *TINY, "--out-dir", str(out_dir)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(list(out_dir.iterdir())) == 2


@pytest.mark.slow
def test_track_video_example(tmp_path):
    pytest.importorskip("cv2")
    _clip(tmp_path / "clip.mp4", 2)
    out = tmp_path / "tracked.mp4"
    r = _run(["track_video", str(tmp_path / "clip.mp4"), *TINY,
              "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "3 frames ->" in r.stdout


@pytest.mark.slow
def test_track_multicamera_example(tmp_path):
    pytest.importorskip("cv2")
    clips = []
    for i in range(2):
        _clip(tmp_path / f"cam{i}.mp4", 3 + i)
        clips.append(str(tmp_path / f"cam{i}.mp4"))
    r = _run(["track_multicamera", *clips, *TINY, "--height", "72",
              "--width", "96", "--max-steps", "4"])
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.slow
def test_make_demo_example(tmp_path):
    pytest.importorskip("cv2")
    out = tmp_path / "demo.mp4"
    r = _run(["make_demo", "--out", str(out), "--frames", "12", "--width",
              "160", "--height", "120", "--objects", "2", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists() and out.stat().st_size > 0
