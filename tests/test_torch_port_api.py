"""The port's public facades (``yolo_deepsort_tpu_torch/api.py``) against
the JAX package's on the CPU, from identical weights (yolov3-tiny at 96 with
both packages' seeded random darknet params; the seeded random ReID net).

Tolerances, measured on this suite's inputs:
* integer rows (``DeepSort.update``, ``VideoTracker.track_frame`` /
  ``track_frames`` / ``track``): exactly equal;
* ``ImageDetector.detect``: the same rows and classes, boxes within
  1e-2 px and scores within 1e-4 (measured 1.2e-3 px: f32 convs summed in
  another order);
* ``Extractor``: features within 5e-4 (measured 1.4e-4). The port resizes
  crops with torch bilinear rounded to uint8, the reference with
  cv2.INTER_LINEAR, whose fixed-point weights put about 1 pixel in 8 one
  level apart;
* the 128-d ReID net: features within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

import yolo_deepsort_tpu.api as JA
from specs.weights_np import random_darknet_weights
from test_reid import TorchNet, TorchOriginalNet
from yolo_deepsort_tpu.config import TrackerConfig as JTrackerConfig
from yolo_deepsort_tpu.models import reid as JR
from yolo_deepsort_tpu.models import weights as JW
from yolo_deepsort_tpu.ops.nms import roi_nms_mask as j_roi_nms
from yolo_deepsort_tpu.utils import checkpoint as JCK
from yolo_deepsort_tpu_torch import api as PA
from yolo_deepsort_tpu_torch.config import TrackerConfig
from yolo_deepsort_tpu_torch.models import reid as PR
from yolo_deepsort_tpu_torch.ops.nms import roi_nms_mask
from yolo_deepsort_tpu_torch.utils import checkpoint as PCK
from yolo_deepsort_tpu_torch.weights import reid_from_params

H, W = 144, 192


@pytest.fixture(scope="module")
def models():
    return PA.Darknet("yolov3-tiny", img_size=96, device="cpu"), JA.Darknet(
        "yolov3-tiny", img_size=96)


@pytest.fixture(scope="module")
def noise_frames():
    """A noise frame sliding right 2 px per frame: detections that persist."""
    base = np.random.default_rng(1).integers(0, 256, (H, W + 40, 3),
                                             np.uint8)
    return np.stack([base[:, 40 - 2 * t: 40 - 2 * t + W] for t in range(9)])


@pytest.fixture(scope="module")
def tracked(models, noise_frames):
    """The two most frequent detected classes: the class filter keeps some
    detections and drops others."""
    det = JA.ImageDetector(models[1], conf_thres=0.3).detect(noise_frames[0])
    counts = np.bincount(det[:, 6].astype(int), minlength=80)
    assert counts.sum() > counts.max(), "more than one class detected"
    return [JA.COCO_NAMES[i] for i in np.argsort(-counts, kind="stable")[:2]]


def _trackers(models, tracked):
    kw = dict(tracked_classes=tracked, conf_thres=0.3)
    return (PA.VideoTracker(models[0], tracker_config=TrackerConfig(
        max_tracks=16, max_dets=16, nn_budget=10), **kw),
            JA.VideoTracker(models[1], tracker_config=JTrackerConfig(
                max_tracks=16, max_dets=16, nn_budget=10), **kw))


def test_image_detector_matches_jax(models, noise_frames):
    got = PA.ImageDetector(models[0], conf_thres=0.3).detect(noise_frames[0])
    want = JA.ImageDetector(models[1], conf_thres=0.3).detect(noise_frames[0])
    assert got.dtype == np.float32 and got.shape == want.shape
    assert len(got) > 4
    np.testing.assert_array_equal(got[:, 6], want[:, 6])
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-2)
    np.testing.assert_allclose(got[:, 4:6], want[:, 4:6], atol=1e-4)


def test_track_frame_matches_jax(models, noise_frames, tracked):
    port, ref = _trackers(models, tracked)
    emitted = 0
    for t, frame in enumerate(noise_frames):
        got, want = port.track_frame(frame), ref.track_frame(frame)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=f"frame {t}")
        emitted += len(got)
    assert emitted > 0
    assert port.host_readbacks == len(noise_frames), "one wait per call"
    # the filter dropped detections of other classes
    unfiltered, _ = _trackers(models, None)
    assert sum(len(unfiltered.track_frame(f)) for f in noise_frames) > emitted


def test_track_frames_matches_jax(models, noise_frames, tracked):
    port, ref = _trackers(models, tracked)
    emitted = 0
    for chunk in (noise_frames[:3], noise_frames[3:6], noise_frames[6:]):
        got, want = port.track_frames(chunk), ref.track_frames(chunk)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            emitted += len(g)
    assert emitted > 0
    # the chunked step and the per-frame step agree on the same frames
    port_frame, _ = _trackers(models, tracked)
    per_frame = [port_frame.track_frame(f) for f in noise_frames]
    port_chunk, _ = _trackers(models, tracked)
    chunked = port_chunk.track_frames(noise_frames)
    for a, b in zip(per_frame, chunked):
        np.testing.assert_array_equal(a, b)


def _walking_scene(n_frames=14, h=240, w=320):
    """Four textured objects walking across a flat frame; object 2 is
    occluded (absent) on frames 5 and 6, objects 0 and 1 pass each other
    late, one partly hiding the other."""
    rng = np.random.default_rng(9)
    textures = [rng.integers(0, 256, (70, 34, 3), np.uint8) for _ in range(4)]
    starts = [(40, 60), (120, 110), (220, 150), (60, 185)]
    vel = [(5, 1), (-3, 0), (-4, -1), (4, -2)]
    frames, boxes = [], []
    for t in range(n_frames):
        frame = np.full((h, w, 3), 30, np.uint8)
        rows = []
        for i, ((x, y), (vx, vy), tex) in enumerate(zip(starts, vel,
                                                         textures)):
            if i == 2 and t in (5, 6):
                continue
            cx, cy = x + vx * t, y + vy * t
            x1, y1 = int(cx - 17), int(cy - 35)
            frame[y1:y1 + 70, x1:x1 + 34] = tex
            rows.append((cx, cy, 34, 70))
        frames.append(frame)
        boxes.append(np.array(rows, np.float32))
    return frames, boxes


@pytest.mark.parametrize("overlap", [1.0, 0.5])
def test_deepsort_update_matches_jax(overlap):
    kw = dict(max_tracks=16, max_dets=8, nn_budget=10, n_init=2,
              nms_max_overlap=overlap)
    port, ref = PA.DeepSort(device="cpu", **kw), JA.DeepSort(**kw)
    frames, boxes = _walking_scene()
    ids = set()
    for t, (frame, b) in enumerate(zip(frames, boxes)):
        if overlap < 1.0:  # a duplicate box the ROI NMS must drop
            b = np.concatenate([b, b[:1] + [2, 1, 0, 0]])
        conf = np.linspace(0.9, 0.6, len(b))
        got, want = port.update(b, conf, frame), ref.update(b, conf, frame)
        np.testing.assert_array_equal(got, want, err_msg=f"frame {t}")
        ids.update(got[:, 4].tolist())
    assert len(ids) >= 4 and port.host_readbacks == len(frames)
    # an empty update: tracks coast (emitted once more), then a fresh
    # tracker emits nothing
    np.testing.assert_array_equal(port.update(np.zeros((0, 4)), [], frame),
                                  ref.update(np.zeros((0, 4)), [], frame))
    empty = PA.DeepSort(device="cpu", **kw).update(np.zeros((0, 4)), [],
                                                   frame)
    assert empty.shape == (0, 5) and empty.dtype == np.int64


def test_deepsort_state_files_interchange(tmp_path):
    kw = dict(max_tracks=16, max_dets=8, nn_budget=10)
    frames, boxes = _walking_scene()
    port, ref = PA.DeepSort(device="cpu", **kw), JA.DeepSort(**kw)
    for frame, b in zip(frames[:6], boxes[:6]):
        port.update(b, [0.9] * len(b), frame)
        ref.update(b, [0.9] * len(b), frame)
    port.save_state(tmp_path / "port.npz")
    ref.save_state(tmp_path / "ref.npz")
    # each package resumes from the other's file
    port2, ref2 = PA.DeepSort(device="cpu", **kw), JA.DeepSort(**kw)
    port2.load_state(tmp_path / "ref.npz")
    ref2.load_state(tmp_path / "port.npz")
    for frame, b in zip(frames[6:], boxes[6:]):
        out = [d.update(b, [0.9] * len(b), frame)
               for d in (port, ref, port2, ref2)]
        for o in out[1:]:
            np.testing.assert_array_equal(out[0], o)
    port.reset()
    assert int(port.state.next_id[0]) == 1 and int(port.state.state.sum()) == 0


def test_extractor_matches_jax():
    rng = np.random.default_rng(6)
    crops = [rng.integers(0, 256, (h, w, 3), np.uint8)
             for h, w in ((100, 40), (128, 64), (220, 90), (37, 19))]
    got = PA.Extractor(device="cpu")(crops)
    want = JA.Extractor()(crops)
    assert got.shape == (4, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-4)
    assert PA.Extractor(device="cpu")([]).shape == (0, 512)


def test_original_reid_net_matches_jax():
    np.testing.assert_array_equal(
        PR.random_original_reid_params(2)["dense"]["w"],
        JR.random_original_reid_params(2)["dense"]["w"])
    params = JR.random_original_reid_params(0)
    x = np.random.default_rng(4).normal(0, 1, (3, 128, 64, 3)).astype(
        np.float32)
    want = np.asarray(JR.reid_apply(params, jnp.asarray(x)))
    net = reid_from_params(params)
    assert isinstance(net, PR.OriginalReIDNet)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 128) and PR.feat_dim_of(params) == 128
    np.testing.assert_allclose(got, want, atol=1e-4)


def _assert_trees_equal(a, b):
    assert type(a) is type(b) or (a is None) == (b is None)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    elif a is not None:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reid_checkpoints_load_like_jax(tmp_path):
    from yolo_deepsort_tpu.train.reid_train import init_train_params

    params, stats = init_train_params(num_classes=5, seed=3)
    JCK.save_reid_checkpoint(tmp_path / "ck.npz", params, acc=0.7, epoch=2,
                             stats=stats)
    _assert_trees_equal(PR.load_reid_checkpoint(tmp_path / "ck.npz"),
                        JR.load_reid_checkpoint(str(tmp_path / "ck.npz")))
    torch.manual_seed(0)
    for net in (TorchNet(num_classes=10), TorchOriginalNet(num_classes=10)):
        path = tmp_path / "ckpt.t7"
        torch.save({"net_dict": net.state_dict(), "acc": 0.9, "epoch": 7},
                   str(path))
        got, want = PR.load_reid_checkpoint(path), JR.load_reid_checkpoint(
            str(path))
        _assert_trees_equal(got, want)
        assert PR.feat_dim_of(got) == JR.feat_dim_of(want)


def test_checkpoint_pytrees_interchange(tmp_path):
    tree = {"a": [np.arange(3), (np.ones((2, 2)), None)], 7: {"x/y": 1.5}}
    PCK.save_pytree(tmp_path / "p.npz", tree)
    JCK.save_pytree(tmp_path / "j.npz", tree)
    for path in ("p.npz", "j.npz"):
        _assert_trees_equal(PCK.load_pytree(tmp_path / path),
                            JCK.load_pytree(tmp_path / path))
    loaded = PCK.load_pytree(tmp_path / "p.npz")[7]
    template = {"x/y": torch.zeros(())}
    _assert_trees_equal(PCK.restore_like(template, loaded),
                        JCK.restore_like(template, loaded))
    nested = PCK.load_pytree(tmp_path / "p.npz")["a"]
    template = [torch.zeros(3), (torch.zeros(2, 2), None)]
    _assert_trees_equal(PCK.restore_like(template, nested),
                        JCK.restore_like(template, nested))
    with pytest.raises(ValueError, match="mismatch"):
        PCK.restore_like([np.zeros(4), np.zeros(1)], nested)


def test_roi_nms_mask_matches_jax():
    rng = np.random.default_rng(8)
    for _ in range(5):
        d = 12
        xy = rng.uniform(0, 60, (d, 2))
        tlwh = np.concatenate([xy, rng.uniform(10, 40, (d, 2))], 1).astype(
            np.float32)
        scores = rng.integers(0, 6, d).astype(np.float32) / 5  # ties
        mask = rng.uniform(size=d) < 0.8
        for overlap in (0.3, 0.6):
            got = roi_nms_mask(torch.from_numpy(tlwh),
                               torch.from_numpy(scores),
                               torch.from_numpy(mask), overlap)
            want = j_roi_nms(tlwh, scores, mask, overlap)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_darknet_weights_round_trip(models, tmp_path):
    port = PA.Darknet("yolov3-tiny", img_size=96, device="cpu")
    blob = random_darknet_weights(port.plan.defs(), seed=4,
                                  well_conditioned=True)
    (tmp_path / "in.weights").write_bytes(blob)
    port.load_darknet_weights(str(tmp_path / "in.weights"))
    port.save_darknet_weights(str(tmp_path / "out.weights"))
    assert (tmp_path / "out.weights").read_bytes() == blob
    header, raw = JW.load_darknet_weights(str(tmp_path / "out.weights"),
                                          models[1].plan.defs())
    _assert_trees_equal(raw, port.raw_params)
    # a cutoff save writes the first layers only; JAX reads it back
    port.save_darknet_weights(str(tmp_path / "cut.weights"), cutoff=8)
    _, cut = JW.load_darknet_weights(str(tmp_path / "cut.weights"),
                                     models[1].plan.defs(), cutoff=8)
    assert sorted(cut) == [i for i in sorted(raw) if i < 8]
    ref = JA.Darknet("yolov3-tiny", img_size=96).load_darknet_weights(
        str(tmp_path / "in.weights"))
    x = np.random.default_rng(3).uniform(0, 1, (1, 96, 96, 3)).astype(
        np.float32)
    np.testing.assert_allclose(port(x).numpy(), np.asarray(ref(x)),
                               rtol=1e-4, atol=1e-3)


def _write_clip(path, frames):
    from yolo_deepsort_tpu_torch.runtime.video import VideoWriter

    writer = VideoWriter(str(path), 10.0, (frames.shape[2], frames.shape[1]))
    for f in frames:
        writer.write(np.ascontiguousarray(f[:, :, ::-1]))
    writer.release()


def test_video_detector_and_tracker_over_a_clip(models, noise_frames,
                                                tracked, tmp_path):
    pytest.importorskip("cv2")
    clip = tmp_path / "clip.mp4"
    _write_clip(clip, noise_frames[:7])
    out = tmp_path / "out.mp4"
    got = list(PA.VideoDetector(PA.ImageDetector(
        models[0], conf_thres=0.3)).detect(str(clip), str(out),
                                           skip_frames=1))
    want = list(JA.VideoDetector(JA.ImageDetector(
        models[1], conf_thres=0.3)).detect(str(clip), skip_frames=1))
    assert len(got) == len(want) == 7 and out.stat().st_size > 0
    np.testing.assert_array_equal(got[0][1], got[1][1])  # skipped frame
    for (ga, gd), (_, wd) in zip(got, want):
        assert ga.shape == (H, W, 3)
        np.testing.assert_allclose(gd[:, :4], wd[:, :4], atol=1e-2)
    for chunk in (0, 3):  # per frame; chunked with a per-frame tail
        port, ref = _trackers(models, tracked)
        a = [o for _, o in port.track(str(clip), chunk=chunk)]
        b = [o for _, o in ref.track(str(clip), chunk=chunk)]
        assert len(a) == len(b) == 7
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
