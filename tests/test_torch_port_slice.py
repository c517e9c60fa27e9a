"""The serving slice as a whole: the JAX package's BucketedScannedStep
against the port's, over 2 streams x 3 chunks x K=2 frames of 64x128
frames with yolov3-tiny at 64, max_tracks 16, max_dets 8 and a small crop
window ladder, from identical parameters.

* detect stage: boxes7 to 1e-4 relative, mask and stats exactly equal;
* track stage, fed the SAME detect outputs: every (K, S, T, 5) output and
  emit exactly equal, and the same capacity bucket and crop window.

The same with the int8 ReID embed routes (``embed_int8``), ONE package from
the JAX package's quantizer fed to both sides: the integer rows are exactly
equal too. The features themselves differ slightly (the JAX step makes f32
crops and rounds them to bf16 at the front's first conv, the port makes the
crops with kernel 2's bf16 rounding points and its bf16 front rounds each
conv's output), but on static frames the assignment is unambiguous, so
every emitted row, id and box agrees. The stored gallery features are held
to a cosine against the JAX step's: > 0.9999 for the f32 embed and the
per-layer route (f32 crops on both sides), > 0.999 for the resident route
(measured 0.9998: the crop and front roundings above).
"""

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from specs.weights_np import random_darknet_weights
from yolo_deepsort_tpu.cfg.architectures import ARCHITECTURES
from yolo_deepsort_tpu.config import DetectorConfig, TrackerConfig
from yolo_deepsort_tpu.models import quantize as JQ
from yolo_deepsort_tpu.models import weights as W
from yolo_deepsort_tpu.models.darknet import build_network as j_build
from yolo_deepsort_tpu.models.darknet import network_apply
from yolo_deepsort_tpu.models.reid import random_reid_params as j_reid_params
from yolo_deepsort_tpu.ops.letterbox import letterbox as j_letterbox
from yolo_deepsort_tpu.parallel import streams as JS
from yolo_deepsort_tpu_torch.models.darknet import build_network
from yolo_deepsort_tpu_torch.models.reid import random_reid_params
from yolo_deepsort_tpu_torch.parallel import streams as TS
from yolo_deepsort_tpu_torch.weights import (
    darknet_from_raw,
    reid_from_params,
    reid_int8_package_to_torch,
)

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


def _setup():
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
    return dict(jplan=jplan, folded=folded, frames=frames, det_cfg=det_cfg,
                trk_cfg=trk_cfg, kw=kw,
                detector=darknet_from_raw(tplan, raw))


def _run_both(su, j_reid, t_reid, embed_int8=False, min_cos=0.9999):
    """CHUNKS chunks through both BucketedScannedSteps; returns the port's
    step and its outputs per chunk."""
    det_cfg, trk_cfg, kw = su["det_cfg"], su["trk_cfg"], su["kw"]
    frames, folded = su["frames"], su["folded"]
    j_step = JS.BucketedScannedStep(su["jplan"], det_cfg, trk_cfg, (H, W_),
                                    donate_state=False,
                                    embed_int8=embed_int8, **kw)
    t_step = TS.BucketedScannedStep(su["detector"], t_reid, det_cfg, trk_cfg,
                                    (H, W_), embed_int8=embed_int8, **kw)
    j_states = JS.init_stream_states(trk_cfg, S)
    t_states = TS.init_stream_states(trk_cfg, S, "cpu")
    emitted, outs = 0, []
    for _ in range(CHUNKS):
        j_handle = j_step.detect(folded, jnp.asarray(frames))
        t_handle = t_step.detect(torch.from_numpy(frames))
        j_b7, j_mask, j_stats = (np.array(a) for a in j_handle[1:])
        np.testing.assert_array_equal(t_handle[2].numpy(), j_mask)
        np.testing.assert_array_equal(t_handle[3].numpy(), j_stats)
        np.testing.assert_allclose(t_handle[1].numpy(), j_b7, rtol=1e-4,
                                   atol=1e-4)

        j_states, (j_out, j_emit) = j_step.track(j_reid, j_states, j_handle)
        same = (t_handle[0], torch.from_numpy(j_b7),
                torch.from_numpy(j_mask), torch.from_numpy(j_stats))
        t_states, (t_out, t_emit) = t_step.track(t_states, same)
        assert t_out.shape == (K, S, trk_cfg.max_tracks, 5)
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
        np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
        assert t_step.last_bucket == j_step.last_bucket
        assert t_step.last_window == j_step.last_window
        emitted += int(t_emit.sum())
        outs.append((t_out, t_emit))
    assert t_step.last_window != (H, W_), "the windowed crop path ran"
    assert emitted > 0, "tracks confirmed and were emitted"
    assert t_step.saturation() == j_step.saturation()
    assert t_step.host_readbacks == CHUNKS, "one stats readback per chunk"
    # the embeds themselves: every stored gallery feature against JAX's
    j_gal, t_gal = np.asarray(j_states.gallery), t_states.gallery.numpy()
    filled = np.linalg.norm(j_gal, axis=-1) > 0
    assert filled.any()
    cos = (j_gal * t_gal).sum(-1)[filled]
    assert cos.min() > min_cos, cos.min()
    return t_step, t_states, outs


def test_bucketed_scanned_step_matches_jax():
    _run_both(_setup(), j_reid_params(0),
              reid_from_params(random_reid_params(0)))


@pytest.fixture(scope="module")
def calib():
    return np.random.default_rng(5).normal(0, 1, (8, 128, 64, 3)).astype(
        np.float32)


def test_bucketed_scanned_step_embed_int8_resident_matches_jax(calib):
    """``embed_int8="resident"`` on both sides, one package; and the port's
    ``"resident_pallas"`` on CPU tensors takes kernel 8's plain version, so
    it gives exactly what ``"resident"`` gives, features included."""
    su = _setup()
    pkg = JQ.quantize_reid_params_resident(j_reid_params(0), calib)
    t_pkg = reid_int8_package_to_torch(pkg, "cpu")
    _, st_a, outs_a = _run_both(su, pkg, t_pkg, embed_int8="resident",
                                min_cos=0.999)
    step = TS.BucketedScannedStep(
        su["detector"], t_pkg, su["det_cfg"], su["trk_cfg"], (H, W_),
        embed_int8="resident_pallas", **su["kw"])
    st_b = TS.init_stream_states(su["trk_cfg"], S, "cpu")
    for out_a, emit_a in outs_a:
        st_b, (out_b, emit_b) = step(st_b, torch.from_numpy(su["frames"]))
        assert torch.equal(out_a, out_b) and torch.equal(emit_a, emit_b)
    assert torch.equal(st_a.gallery, st_b.gallery)
    assert float(st_b.gallery.abs().max()) > 0


def test_bucketed_scanned_step_embed_int8_per_layer_matches_jax(calib):
    """``embed_int8=True``: the per-layer W8A8 route (no kernel), f32
    crops on both sides."""
    pkg = JQ.quantize_reid_params(j_reid_params(0), calib)
    _run_both(_setup(), pkg, reid_int8_package_to_torch(pkg, "cpu"),
              embed_int8=True)


def test_embed_route_and_package_must_agree(calib):
    su = _setup()
    args = (su["det_cfg"], su["trk_cfg"], (H, W_), 4)
    pkg = JQ.quantize_reid_params_resident(j_reid_params(0), calib)
    with pytest.raises(ValueError, match="quantize_reid_params_resident"):
        TS.make_scanned_track_stage(reid_from_params(random_reid_params(0)),
                                    *args, embed_int8="resident")
    with pytest.raises(ValueError, match="quantize_reid_params "):
        TS.make_scanned_track_stage(
            reid_int8_package_to_torch(pkg, "cpu"), *args, embed_int8=True)
    with pytest.raises(ValueError, match="needs an embed_int8 route"):
        TS.make_scanned_track_stage(pkg, *args)
    with pytest.raises(ValueError, match="unknown embed route"):
        TS.make_scanned_track_stage(pkg, *args, embed_int8="resident_xla")


def test_bucketed_step_hands_the_conv_route_to_its_detect_stage():
    """``use_pallas_conv`` / ``backbone_int8_pkg`` on the bucketed step (and
    its constructor function) reach the detect stage: its detect outputs
    equal those of a detect stage built directly with the route, and differ
    from the unrouted step's."""
    from yolo_deepsort_tpu_torch.models.quantize_darknet import (
        quantize_darknet_from_frames,
    )

    su = _setup()
    det_cfg, trk_cfg, kw = su["det_cfg"], su["trk_cfg"], su["kw"]
    frames = torch.from_numpy(su["frames"])
    pkg = quantize_darknet_from_frames(su["detector"], su["frames"][0], 64)
    assert pkg
    reid = reid_from_params(random_reid_params(0))
    route = dict(use_pallas_conv=True, backbone_int8_pkg=pkg)
    direct = TS.make_scanned_detect_stage(
        su["detector"], det_cfg, trk_cfg, (H, W_),
        conf_thres_per_stream=kw["conf_thres_per_stream"], **route)(frames)
    plain = TS.BucketedScannedStep(su["detector"], reid, det_cfg, trk_cfg,
                                   (H, W_), **kw).detect(frames)
    for make in (TS.BucketedScannedStep, TS.make_scanned_step_bucketed):
        handle = make(su["detector"], reid, det_cfg, trk_cfg, (H, W_), **kw,
                      **route).detect(frames)
        for got, want in zip(handle[1:4], direct):
            assert torch.equal(got, want)
        assert not torch.equal(handle[1], plain[1])
    # the residual-chain route reaches the detect stage too: its int8 form
    # needs the package (yolov3-tiny has no residual chain to route)
    with pytest.raises(ValueError, match="requires backbone_int8_pkg"):
        TS.BucketedScannedStep(su["detector"], reid, det_cfg, trk_cfg,
                               (H, W_), use_resblock="int8", **kw)
    routed = TS.BucketedScannedStep(su["detector"], reid, det_cfg, trk_cfg,
                                    (H, W_), use_resblock=True,
                                    **kw).detect(frames)
    assert torch.equal(routed[1], plain[1])


def test_crops_layout_dispatch_matches_jax_interleaved(monkeypatch):
    """Under ``YDT_CROPS_LAYOUT=interleaved`` the port's
    ``crop_and_normalize_fused`` serves kernel 6; on CPU tensors that is
    ``crops_plain`` (the plain version of both crop kernels). Against the
    JAX interleaved kernel in interpret mode: atol 0.06, the reference's
    bound between its two kernels (bf16 sums in another order)."""
    from yolo_deepsort_tpu.ops.pallas_crops import (
        pallas_crop_and_normalize_batch,
    )
    from yolo_deepsort_tpu_torch.ops import crops_kernel

    rng = np.random.default_rng(4)
    b, d, h, w = 2, 4, 64, 128
    frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    bw, bh = rng.uniform(2, 40, (b, d)), rng.uniform(2, 30, (b, d))
    x1, y1 = rng.uniform(0, w - 41, (b, d)), rng.uniform(0, h - 31, (b, d))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    monkeypatch.setenv("YDT_CROPS_LAYOUT", "interleaved")
    want = np.asarray(pallas_crop_and_normalize_batch(
        frames, boxes, 32, 40, interpret=True))
    before = (crops_kernel.launches, crops_kernel.launches_interleaved)
    got = crops_kernel.crop_and_normalize_fused(
        torch.from_numpy(frames), torch.from_numpy(boxes), 32, 40)
    assert (crops_kernel.launches,
            crops_kernel.launches_interleaved) == before
    assert got.shape == (b, d, 128, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=0.06)
    monkeypatch.delenv("YDT_CROPS_LAYOUT")
    assert torch.equal(got, crops_kernel.crop_and_normalize_fused(
        torch.from_numpy(frames), torch.from_numpy(boxes), 32, 40))
