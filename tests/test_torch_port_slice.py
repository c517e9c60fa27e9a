"""The serving slice as a whole: the JAX package's BucketedScannedStep
against the port's, over 2 streams x 3 chunks x K=2 frames of 64x128
frames with yolov3-tiny at 64, max_tracks 16, max_dets 8 and a small crop
window ladder, from identical parameters.

* detect stage: boxes7 to 1e-4 relative, mask and stats exactly equal;
* track stage, fed the SAME detect outputs: every (K, S, T, 5) output and
  emit exactly equal, and the same capacity bucket and crop window.
"""

import numpy as np
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from specs.weights_np import random_darknet_weights
from yolo_deepsort_tpu.cfg.architectures import ARCHITECTURES
from yolo_deepsort_tpu.config import DetectorConfig, TrackerConfig
from yolo_deepsort_tpu.models import weights as W
from yolo_deepsort_tpu.models.darknet import build_network as j_build
from yolo_deepsort_tpu.models.darknet import network_apply
from yolo_deepsort_tpu.models.reid import random_reid_params as j_reid_params
from yolo_deepsort_tpu.ops.letterbox import letterbox as j_letterbox
from yolo_deepsort_tpu.parallel import streams as JS
from yolo_deepsort_tpu_torch.models.darknet import build_network
from yolo_deepsort_tpu_torch.models.reid import random_reid_params
from yolo_deepsort_tpu_torch.parallel import streams as TS
from yolo_deepsort_tpu_torch.weights import darknet_from_raw, reid_from_params

H, W_, K, S, CHUNKS = 64, 128, 2, 2, 3
WINDOWS = ((16, 16), (32, 40), (48, 64))


def _plant_small_boxes(raw, plan, height=12.0, aspect=0.5):
    """Aim the yolo heads' tw/th biases at ~12 px letterboxed boxes, so the
    chunk's crops fit a window of the ladder (random anchors would decode
    frame-sized boxes and only exercise the dense path)."""
    for head in plan.heads:
        layer = raw[head.module_index - 1]
        per = 5 + head.num_classes
        for a, (pw, ph) in enumerate(head.anchors):
            cw, ch = a * per + 2, a * per + 3
            layer["conv_weight"][[cw, ch]] = 0.0
            layer["conv_bias"][cw] = np.log(aspect * height / pw)
            layer["conv_bias"][ch] = np.log(height / ph)
    return raw


def test_bucketed_scanned_step_matches_jax():
    defs = ARCHITECTURES["yolov3-tiny"](img_size=64)
    jplan, tplan = j_build(defs), build_network(defs)
    blob = random_darknet_weights(jplan.defs(), seed=0, well_conditioned=True)
    _, raw = W.load_darknet_weights(blob, jplan.defs())
    raw = _plant_small_boxes(raw, jplan)
    folded = W.fold_inference_params(raw, jplan.defs())
    base = np.random.default_rng(0).integers(0, 256, (S, H, W_, 3), np.uint8)
    frames = np.broadcast_to(base[None], (K, S, H, W_, 3)).copy()

    # per-stream thresholds halfway between the 6th and 7th objectness, so
    # the two frameworks' last-ulp differences cannot flip a candidate
    dec = np.asarray(network_apply(
        jplan, folded, jax.vmap(lambda f: j_letterbox(f, 64))(base)))
    obj = np.sort(dec[..., 4], -1)
    thr = ((obj[:, -6] + obj[:, -7]) / 2).astype(np.float32)

    det_cfg = DetectorConfig(img_size=64, conf_thres=0.5, max_dets=8)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    kw = dict(buckets=(4, 8), conf_thres_per_stream=thr, windows=WINDOWS)
    j_step = JS.BucketedScannedStep(jplan, det_cfg, trk_cfg, (H, W_),
                                    donate_state=False, **kw)
    t_step = TS.BucketedScannedStep(
        darknet_from_raw(tplan, raw), reid_from_params(random_reid_params(0)),
        det_cfg, trk_cfg, (H, W_), **kw)
    reid_params = j_reid_params(0)
    j_states = JS.init_stream_states(trk_cfg, S)
    t_states = TS.init_stream_states(trk_cfg, S, "cpu")
    emitted = 0
    for _ in range(CHUNKS):
        j_handle = j_step.detect(folded, jnp.asarray(frames))
        t_handle = t_step.detect(torch.from_numpy(frames))
        j_b7, j_mask, j_stats = (np.array(a) for a in j_handle[1:])
        np.testing.assert_array_equal(t_handle[2].numpy(), j_mask)
        np.testing.assert_array_equal(t_handle[3].numpy(), j_stats)
        np.testing.assert_allclose(t_handle[1].numpy(), j_b7, rtol=1e-4,
                                   atol=1e-4)

        j_states, (j_out, j_emit) = j_step.track(reid_params, j_states,
                                                 j_handle)
        same = (t_handle[0], torch.from_numpy(j_b7),
                torch.from_numpy(j_mask), torch.from_numpy(j_stats))
        t_states, (t_out, t_emit) = t_step.track(t_states, same)
        assert t_out.shape == (K, S, trk_cfg.max_tracks, 5)
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
        np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
        assert t_step.last_bucket == j_step.last_bucket
        assert t_step.last_window == j_step.last_window
        emitted += int(t_emit.sum())
    assert t_step.last_window != (H, W_), "the windowed crop path ran"
    assert emitted > 0, "tracks confirmed and were emitted"
    assert t_step.saturation() == j_step.saturation()
    assert t_step.host_readbacks == CHUNKS, "one stats readback per chunk"
