"""The K=1 low-latency step and the multi-stream runtime against the JAX
package on the CPU: ``make_batched_step`` (yolov3-tiny at 64, 2 streams of
64x128 frames, f32, identical seeded parameters, several static frames so
that tracks confirm) in five variants, and ``MultiStreamTracker`` on two
short videos.

Per frame: emit, track ids and the emitted integer boxes exactly equal; the
Kalman means within rtol 2e-4 / atol 2e-3 (the tolerance the fused tracker
step is held to, tests/test_torch_port_kernels.py); the discrete state
exactly equal. The JAX side runs its fused tracker kernel (and, in the conv
variant, its conv kernel) in Pallas interpret mode.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from specs.weights_np import random_darknet_weights
from yolo_deepsort_tpu.cfg.architectures import ARCHITECTURES
from yolo_deepsort_tpu.config import DetectorConfig, TrackerConfig
from yolo_deepsort_tpu.models import quantize_darknet as JQ
from yolo_deepsort_tpu.models import weights as W
from yolo_deepsort_tpu.models.darknet import build_network as j_build
from yolo_deepsort_tpu.models.darknet import network_apply
from yolo_deepsort_tpu.models.reid import random_reid_params as j_reid_params
from yolo_deepsort_tpu.ops.letterbox import letterbox as j_letterbox
from yolo_deepsort_tpu.parallel import streams as JS
from yolo_deepsort_tpu_torch.models import quantize_darknet as TQ
from yolo_deepsort_tpu_torch.models.darknet import build_network
from yolo_deepsort_tpu_torch.models.reid import random_reid_params
from yolo_deepsort_tpu_torch.parallel import streams as TS
from yolo_deepsort_tpu_torch.weights import darknet_from_raw, reid_from_params

from test_torch_port_slice import _plant_small_boxes
from test_torch_port_tracking import DISCRETE

H, W_, S, FRAMES = 64, 128, 2, 5


@pytest.fixture(scope="module")
def setup():
    defs = ARCHITECTURES["yolov3-tiny"](img_size=64)
    jplan, tplan = j_build(defs), build_network(defs)
    blob = random_darknet_weights(jplan.defs(), seed=0, well_conditioned=True)
    _, raw = W.load_darknet_weights(blob, jplan.defs())
    raw = _plant_small_boxes(raw, jplan)
    folded = W.fold_inference_params(raw, jplan.defs())
    frames = np.random.default_rng(0).integers(0, 256, (S, H, W_, 3),
                                               np.uint8)
    # one threshold for all streams, halfway between two objectness values
    # around the 6th per stream, so last-ulp differences flip no candidate
    dec = np.asarray(network_apply(
        jplan, folded, jax.vmap(lambda f: j_letterbox(f, 64))(frames)))
    obj = np.sort(dec[..., 4].ravel())[::-1]
    thr = float((obj[2 * 6 - 1] + obj[2 * 6]) / 2)
    return dict(jplan=jplan, folded=folded, frames=frames, thr=thr,
                detector=darknet_from_raw(tplan, raw),
                reid=reid_from_params(random_reid_params(0)),
                j_reid=j_reid_params(0))


def _compare_frame(t_states, j_states, t_out, t_emit, j_out, j_emit, tag):
    np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit),
                                  err_msg=tag)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out),
                                  err_msg=tag)
    for name in DISCRETE:
        np.testing.assert_array_equal(
            getattr(t_states, name).numpy(),
            np.asarray(getattr(j_states, name)), err_msg=f"{tag}: {name}")
    np.testing.assert_allclose(t_states.mean.numpy(),
                               np.asarray(j_states.mean), rtol=2e-4,
                               atol=2e-3, err_msg=tag)


VARIANTS = {
    # name: (kwargs of both make_batched_step, JAX-only kwargs)
    "plain": (dict(), dict()),
    "cap_window_fits": (dict(cap=6, crop_window=(32, 40)),
                        dict(use_fused_tracker=True)),
    "cap_window_guard": (dict(cap=6, crop_window=(8, 8)),
                         dict(use_fused_tracker=True)),
    "class_filter": (dict(tracked_class_ids=None), dict()),  # ids set below
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_make_batched_step_matches_jax(setup, variant):
    kw, j_kw = (dict(d) for d in VARIANTS[variant])
    det_cfg = DetectorConfig(img_size=64, conf_thres=setup["thr"],
                             max_dets=8)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    if variant == "class_filter":
        # track the classes of about half of the first frame's detections
        dec = np.asarray(network_apply(
            setup["jplan"], setup["folded"], jax.vmap(
                lambda f: j_letterbox(f, 64))(setup["frames"])))
        keep = dec[..., 4] >= setup["thr"]
        classes = np.unique(dec[keep][:, 5:].argmax(-1))
        kw["tracked_class_ids"] = classes[::2].tolist()
        assert 0 < len(kw["tracked_class_ids"]) < len(classes)
    j_step = JS.make_batched_step(setup["jplan"], det_cfg, trk_cfg, (H, W_),
                                  donate_state=False, **kw, **j_kw)
    t_step = TS.make_batched_step(setup["detector"], setup["reid"], det_cfg,
                                  trk_cfg, (H, W_), **kw)
    j_states = JS.init_stream_states(trk_cfg, S)
    t_states = TS.init_stream_states(trk_cfg, S, "cpu")
    frames = setup["frames"]
    emitted = 0
    for f in range(FRAMES):
        j_states, (j_out, j_emit) = j_step(setup["folded"], setup["j_reid"],
                                           j_states, jnp.asarray(frames))
        t_states, (t_out, t_emit) = t_step(t_states,
                                           torch.from_numpy(frames))
        _compare_frame(t_states, j_states, t_out, t_emit, j_out, j_emit,
                       f"{variant} frame {f}")
        emitted += int(t_emit.sum())
    assert emitted > 0, "tracks confirmed and were emitted"
    if variant == "class_filter":
        plain = TS.make_batched_step(setup["detector"], setup["reid"],
                                     det_cfg, trk_cfg, (H, W_))
        st = TS.init_stream_states(trk_cfg, S, "cpu")
        for f in range(FRAMES):
            st, _ = plain(st, torch.from_numpy(frames))
        assert int((st.state > 0).sum()) > int((t_states.state > 0).sum())


GRAPH_COUNTERS = {"detector_graph": "detector_graph_launches",
                  "detector_capture": "detector_capture_launches",
                  "detector_eager": "detector_eager_launches"}


def test_cpu_step_never_captures(setup, monkeypatch):
    """On the CPU the K=1 step's detector runs as it did before the card's
    graph: no CUDA graph is built, the graph counters stay 0, and the step
    still equals the JAX step frame by frame."""
    from yolo_deepsort_tpu_torch.kernels.launches import (read_launches,
                                                          zero_launches)

    def no_graph(*args, **kwargs):
        raise AssertionError("a CUDA graph was built for CPU tensors")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    monkeypatch.setattr(torch.cuda, "graph", no_graph)
    det_cfg = DetectorConfig(img_size=64, conf_thres=setup["thr"],
                             max_dets=8)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    j_step = JS.make_batched_step(setup["jplan"], det_cfg, trk_cfg, (H, W_),
                                  donate_state=False, cap=6,
                                  use_fused_tracker=True)
    t_step = TS.make_batched_step(setup["detector"], setup["reid"], det_cfg,
                                  trk_cfg, (H, W_), cap=6)
    j_states = JS.init_stream_states(trk_cfg, S)
    t_states = TS.init_stream_states(trk_cfg, S, "cpu")
    frames = setup["frames"]
    zero_launches()
    for f in range(FRAMES):
        j_states, (j_out, j_emit) = j_step(setup["folded"], setup["j_reid"],
                                           j_states, jnp.asarray(frames))
        t_states, (t_out, t_emit) = t_step(t_states,
                                           torch.from_numpy(frames))
        _compare_frame(t_states, j_states, t_out, t_emit, j_out, j_emit,
                       f"frame {f}")
    got = read_launches()
    assert {k: got[k] for k in GRAPH_COUNTERS} == dict.fromkeys(
        GRAPH_COUNTERS, 0)
    assert got["letterbox"] == got["nms"] == got["tracker"] == 0  # plain


def test_detector_graph_on_the_cpu_is_the_forward(setup):
    """``DetectorGraph`` on CPU tensors returns the detector's own forward
    bit for bit and keeps no key, graph or static buffer."""
    frames = torch.from_numpy(setup["frames"])
    xs = TS.letterbox_batch_fused(frames, 64)
    graph = TS.DetectorGraph(setup["detector"])
    with torch.no_grad():
        want = setup["detector"](xs)
        for _ in range(3):
            assert torch.equal(graph(xs), want)
    assert graph.key is graph.graph is graph.x is graph.out is None


def test_detector_graph_key_follows_what_it_can_observe(setup):
    """The graph's key changes with the input's shape and dtype, with an
    in-place change of any detector weight (``load_params`` included) and
    with the float32 math modes, and with nothing else."""
    import copy

    from yolo_deepsort_tpu_torch.train.trees import full_f32

    detector = copy.deepcopy(setup["detector"])
    graph = TS.DetectorGraph(detector)
    xs = TS.letterbox_batch_fused(torch.from_numpy(setup["frames"]), 64)
    key = graph.key_of(xs)
    assert graph.key_of(xs.clone()) == key
    assert graph.key_of(xs[:1]) != key
    assert graph.key_of(xs.double()) != key
    with full_f32():
        assert graph.key_of(xs) != key
    assert graph.key_of(xs) == key
    with torch.no_grad():
        detector.convs["0"].bias.add_(0.0)
    changed = graph.key_of(xs)
    assert changed != key
    params = {int(k): {"w": c.weight.detach().clone(),
                       "b": c.bias.detach().clone()}
              for k, c in detector.convs.items()}
    detector.load_params(params)
    assert graph.key_of(xs) not in (key, changed)


def test_graph_counters_are_launch_counters():
    """The detector graph's three counters are in the registry of launch
    counters: ``zero_launches`` sets them to 0, ``read_launches`` reads
    them."""
    from yolo_deepsort_tpu_torch.kernels.launches import (LAUNCH_COUNTERS,
                                                          read_launches,
                                                          zero_launches)

    for name, attr in GRAPH_COUNTERS.items():
        assert LAUNCH_COUNTERS[name] == ("parallel.streams", attr)
    for i, attr in enumerate(GRAPH_COUNTERS.values(), 1):
        setattr(TS, attr, i)
    got = read_launches()
    assert [got[k] for k in GRAPH_COUNTERS] == [1, 2, 3]
    zero_launches()
    got = read_launches()
    assert [got[k] for k in GRAPH_COUNTERS] == [0, 0, 0]
    assert all(getattr(TS, attr) == 0 for attr in GRAPH_COUNTERS.values())


def test_window_guard_takes_the_dense_crops(setup):
    """With a window smaller than the crops the step must give what the
    step without a window gives (the dense crops), bit for bit; with a
    window that fits it takes the windowed resampler, which is bit-identical
    to dense by construction."""
    det_cfg = DetectorConfig(img_size=64, conf_thres=setup["thr"],
                             max_dets=8)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    frames = torch.from_numpy(setup["frames"])
    results = []
    for window in (None, (8, 8), (32, 40)):
        step = TS.make_batched_step(setup["detector"], setup["reid"],
                                    det_cfg, trk_cfg, (H, W_), cap=6,
                                    crop_window=window)
        st = TS.init_stream_states(trk_cfg, S, "cpu")
        for _ in range(3):
            st, (out, emit) = step(st, frames)
        results.append((st, out, emit))
    for st, out, emit in results[1:]:
        assert torch.equal(out, results[0][1])
        assert torch.equal(emit, results[0][2])
        assert torch.equal(st.gallery, results[0][0].gallery)
        assert torch.equal(st.mean, results[0][0].mean)


def test_with_validity_freezes_an_invalid_stream(setup):
    det_cfg = DetectorConfig(img_size=64, conf_thres=setup["thr"],
                             max_dets=8)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    j_step = JS.make_batched_step(setup["jplan"], det_cfg, trk_cfg, (H, W_),
                                  donate_state=False, with_validity=True)
    t_step = TS.make_batched_step(setup["detector"], setup["reid"], det_cfg,
                                  trk_cfg, (H, W_), with_validity=True)
    j_states = JS.init_stream_states(trk_cfg, S)
    t_states = TS.init_stream_states(trk_cfg, S, "cpu")
    frames = setup["frames"]
    valids = [(True, True), (True, True), (True, False), (True, True),
              (False, True), (True, True)]
    for f, valid in enumerate(valids):
        valid = np.asarray(valid)
        before = {name: getattr(t_states, name).clone()
                  for name in DISCRETE + ("mean", "cov", "gallery")}
        j_states, (j_out, j_emit) = j_step(
            setup["folded"], setup["j_reid"], j_states, jnp.asarray(frames),
            jnp.asarray(valid))
        t_states, (t_out, t_emit) = t_step(
            t_states, torch.from_numpy(frames), torch.from_numpy(valid))
        np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
        # the JAX step leaves an invalid stream's outputs unspecified (they
        # are never emitted): compare the emitted rows
        np.testing.assert_array_equal(t_out.numpy()[t_emit.numpy()],
                                      np.asarray(j_out)[np.asarray(j_emit)])
        for name in DISCRETE:
            np.testing.assert_array_equal(
                getattr(t_states, name).numpy(),
                np.asarray(getattr(j_states, name)), err_msg=f"{f}: {name}")
        np.testing.assert_allclose(t_states.mean.numpy(),
                                   np.asarray(j_states.mean), rtol=2e-4,
                                   atol=2e-3)
        for s in np.flatnonzero(~valid):  # untouched state, nothing emitted
            assert not t_emit[s].any()
            for name, old in before.items():
                assert torch.equal(getattr(t_states, name)[s], old[s]), name
    assert int(t_emit.sum()) > 0


def test_make_batched_step_int8_conv_route_matches_jax(setup):
    """``use_pallas_conv`` with an int8 package: the JAX step runs the Pallas
    conv kernel in interpret mode, the port the kernel's plain version, both
    from the SAME package (calibrated by the JAX package from the frames;
    the port's own package holds the same ``wq``). The routed layers emit
    bf16, so detections move by up to a bf16 ulp between the frameworks:
    emit and ids exactly equal, emitted boxes within 1 px."""
    det_cfg = DetectorConfig(img_size=64, conf_thres=0.5, max_dets=8)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    frames = setup["frames"]
    pkg = JQ.quantize_darknet_from_frames(setup["jplan"], setup["folded"],
                                          frames, 64)
    own = TQ.quantize_darknet_from_frames(setup["detector"], frames, 64)
    assert pkg and set(own) == set(pkg)
    for idx in pkg:
        assert own[idx]["wq"].tobytes() == pkg[idx]["wq"].tobytes()

    # a threshold in the widest gap of the routed forward's objectness
    dec = np.asarray(network_apply(
        setup["jplan"], setup["folded"],
        jax.vmap(lambda f: j_letterbox(f, 64))(frames),
        conv_impl=JQ.make_xla_int8_conv_impl(pkg)))
    obj = np.sort(dec[..., 4].ravel())[::-1][4:24]
    gap = int(np.argmax(obj[:-1] - obj[1:]))
    det_cfg = DetectorConfig(img_size=64, max_dets=8,
                             conf_thres=float((obj[gap] + obj[gap + 1]) / 2))

    j_step = JS.make_batched_step(setup["jplan"], det_cfg, trk_cfg, (H, W_),
                                  donate_state=False,
                                  use_pallas_conv="interpret",
                                  backbone_int8_pkg=pkg)
    t_step = TS.make_batched_step(setup["detector"], setup["reid"], det_cfg,
                                  trk_cfg, (H, W_), use_pallas_conv=True,
                                  backbone_int8_pkg=pkg)
    j_states = JS.init_stream_states(trk_cfg, S)
    t_states = TS.init_stream_states(trk_cfg, S, "cpu")
    emitted = 0
    for f in range(FRAMES):
        j_states, (j_out, j_emit) = j_step(setup["folded"], setup["j_reid"],
                                           j_states, jnp.asarray(frames))
        t_states, (t_out, t_emit) = t_step(t_states,
                                           torch.from_numpy(frames))
        np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
        np.testing.assert_array_equal(t_out.numpy()[..., 4],
                                      np.asarray(j_out)[..., 4])
        np.testing.assert_allclose(t_out.numpy()[..., :4],
                                   np.asarray(j_out)[..., :4], atol=1)
        for name in DISCRETE:
            np.testing.assert_array_equal(
                getattr(t_states, name).numpy(),
                np.asarray(getattr(j_states, name)), err_msg=f"{f}: {name}")
        emitted += int(t_emit.sum())
    assert emitted > 0


def test_detect_stage_takes_the_conv_route(setup):
    """``make_scanned_detect_stage`` takes the conv route: the int8 kernel
    route (its plain version on the CPU) and the plain twin do
    the same arithmetic, so their detect outputs are exactly equal, and
    both differ from the unrouted stage."""
    det_cfg = DetectorConfig(img_size=64, conf_thres=setup["thr"],
                             max_dets=8)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    frames = torch.from_numpy(setup["frames"][None].copy())
    pkg = TQ.quantize_darknet_from_frames(setup["detector"],
                                          setup["frames"], 64)
    outs = []
    for route in ({"int8": frozenset(pkg)}, "plain-twin", False):
        detect = TS.make_scanned_detect_stage(
            setup["detector"], det_cfg, trk_cfg, (H, W_),
            use_pallas_conv=route, backbone_int8_pkg=pkg if route else None)
        outs.append(detect(frames))
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    assert not torch.equal(outs[0][0], outs[2][0])
    # the reference's CPU-test value of the chain route has no meaning
    # here (CPU tensors take the plain version) and is refused by name
    with pytest.raises(ValueError, match="unknown resblock route"):
        TS.make_scanned_detect_stage(setup["detector"], det_cfg, trk_cfg,
                                     (H, W_), use_resblock="interpret")


@pytest.mark.parametrize("kw,name", [(dict(use_resblock="int8"), "K9"),
                                     (dict(embed_int8="resident"), "K8")],
                         ids=["kw0-K9", "kw1-K8"])
def test_unported_routes_raise(setup, kw, name):
    """No route is unported any more (the test keeps its name). The fused
    residual chains (K9) and the int8 embed (K8) are ported: asking for the
    int8 chains without the detector's int8 package, or for the int8 embed
    with the float ``nn.Module`` in place of its quantized package, is
    refused by name."""
    exc, match = ((ValueError, "requires backbone_int8_pkg") if name == "K9"
                  else (ValueError, "quantize_reid_params_resident"))
    with pytest.raises(exc, match=match):
        TS.make_batched_step(setup["detector"], setup["reid"],
                             DetectorConfig(img_size=64), TrackerConfig(),
                             (H, W_), **kw)


def test_make_batched_step_embed_int8_matches_jax(setup):
    """``embed_int8="resident"`` with cap and a crop window that fits, ONE
    resident package (the JAX quantizer's) on both sides: the discrete state
    and every emitted row exactly equal, as in the f32 variants (the features
    differ by the two frameworks' bf16 roundings of crops and front, which
    on static frames moves no assignment; stored gallery features agree to
    cosine > 0.999). ``"resident_pallas"`` on CPU tensors takes kernel 8's
    plain version: the same states bit for bit."""
    from yolo_deepsort_tpu.models import quantize as JQR
    from yolo_deepsort_tpu_torch.weights import reid_int8_package_to_torch

    calib = np.random.default_rng(5).normal(0, 1, (8, 128, 64, 3)).astype(
        np.float32)
    pkg = JQR.quantize_reid_params_resident(setup["j_reid"], calib)
    t_pkg = reid_int8_package_to_torch(pkg, "cpu")
    det_cfg = DetectorConfig(img_size=64, conf_thres=setup["thr"],
                             max_dets=8)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    kw = dict(cap=6, crop_window=(32, 40))
    j_step = JS.make_batched_step(setup["jplan"], det_cfg, trk_cfg, (H, W_),
                                  donate_state=False, use_fused_tracker=True,
                                  embed_int8="resident", **kw)
    t_step = TS.make_batched_step(setup["detector"], t_pkg, det_cfg, trk_cfg,
                                  (H, W_), embed_int8="resident", **kw)
    k_step = TS.make_batched_step(setup["detector"], t_pkg, det_cfg, trk_cfg,
                                  (H, W_), embed_int8="resident_pallas", **kw)
    j_states = JS.init_stream_states(trk_cfg, S)
    t_states = TS.init_stream_states(trk_cfg, S, "cpu")
    k_states = TS.init_stream_states(trk_cfg, S, "cpu")
    frames = setup["frames"]
    emitted = 0
    for f in range(FRAMES):
        j_states, (j_out, j_emit) = j_step(setup["folded"], pkg, j_states,
                                           jnp.asarray(frames))
        t_states, (t_out, t_emit) = t_step(t_states,
                                           torch.from_numpy(frames))
        k_states, (k_out, k_emit) = k_step(k_states,
                                           torch.from_numpy(frames))
        _compare_frame(t_states, j_states, t_out, t_emit, j_out, j_emit,
                       f"embed_int8 frame {f}")
        assert torch.equal(k_out, t_out) and torch.equal(k_emit, t_emit)
        emitted += int(t_emit.sum())
    assert emitted > 0
    assert torch.equal(k_states.gallery, t_states.gallery)
    j_gal, t_gal = np.asarray(j_states.gallery), t_states.gallery.numpy()
    filled = np.linalg.norm(j_gal, axis=-1) > 0
    assert filled.any() and (j_gal * t_gal).sum(-1)[filled].min() > 0.999


def _write_clip(path, n, h, w, seed):
    from yolo_deepsort_tpu.runtime.video import VideoWriter

    # a static frame of coarse random blocks (survives the codec), so that
    # the detector fires and tracks confirm
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (h // 8, w // 8, 3), np.uint8)
    frame = np.kron(blocks, np.ones((8, 8, 1), np.uint8))
    wri = VideoWriter(str(path), 10.0, (w, h))
    for _ in range(n):
        wri.write(frame)
    wri.release()


def test_multistream_tracker_matches_jax(tmp_path):
    """Two short videos, the second ending early, through both
    ``MultiStreamTracker``s, then again with ``global_ids=True``. Which streams a step finds ready depends on the
    decoder threads' timing, but a stream's state moves only on its own
    valid steps, so per stream the sequence of valid steps' rows is
    compared: the same tracks with the same ids on every frame, boxes within
    1 px (a box clipped at the frame border puts a Kalman mean an ulp from
    an integer, and the two frameworks truncate it to either side)."""
    pytest.importorskip("cv2")
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("needs g++ (the native frame ring is built at first use)")
    from yolo_deepsort_tpu import api as JA
    from yolo_deepsort_tpu.runtime.multistream import (
        MultiStreamTracker as JMST,
    )
    from yolo_deepsort_tpu_torch import api as PA
    from yolo_deepsort_tpu_torch.runtime.multistream import MultiStreamTracker

    h, w = 64, 96
    p1, p2 = tmp_path / "a.mp4", tmp_path / "b.mp4"
    _write_clip(p1, 7, h, w, 1)
    _write_clip(p2, 4, h, w, 2)
    kw = dict(
        tracker_config=TrackerConfig(max_tracks=8, max_dets=4, nn_budget=4),
        det_config=DetectorConfig(img_size=96, conf_thres=0.3),
        half=False, ring_depth=4)
    ref = JMST(JA.Darknet("yolov3-tiny", img_size=96), [str(p1), str(p2)],
               j_reid_params(0), (h, w), **kw)
    port = MultiStreamTracker(
        PA.Darknet("yolov3-tiny", img_size=96, device="cpu"),
        [str(p1), str(p2)], random_reid_params(0), (h, w), **kw)

    def per_stream(mst):
        rows = [[], []]
        partial, steps = False, 0
        for outputs, emit, valid in mst.run(max_steps=40):
            assert outputs.shape == (2, 8, 5) and emit.shape == (2, 8)
            partial |= bool(valid[0] and not valid[1])
            steps += 1
            for s in range(2):
                if valid[s]:
                    rows[s].append(np.asarray(outputs[s])[np.asarray(
                        emit[s])])
                else:
                    assert not np.asarray(emit[s]).any()
        return rows, partial, steps

    want, _, _ = per_stream(ref)
    got, partial, steps = per_stream(port)
    assert partial, "stream 2 ended early: the isolation path ran"
    assert port.host_readbacks == steps, "one readback per step"
    assert [len(r) for r in got] == [7, 4] == [len(r) for r in want]
    for s in range(2):
        for f, (a, b) in enumerate(zip(got[s], want[s])):
            tag = f"stream {s} frame {f}"
            np.testing.assert_array_equal(a[:, 4], b[:, 4], err_msg=tag)
            np.testing.assert_allclose(a[:, :4], b[:, :4], atol=1,
                                       err_msg=tag)
    assert sum(len(r) for rows in got for r in rows) > 0, "rows were emitted"
    assert set(port.stats()) == set(ref.stats()) == {"dropped"}
    ref.close()
    port.close()

    # global_ids=True: a gid round reads every stream's state at once, so
    # each clip is decoded whole into its ring before the first pop (no
    # thread timing decides what a step sees): both trackers take the same
    # (frames, valid) sequence, 4 steps of both streams, then 3 of one
    kw.update(ring_depth=8, global_ids=True, global_id_every=2)
    ref = _prefilled(JMST)(JA.Darknet("yolov3-tiny", img_size=96),
                           [str(p1), str(p2)], j_reid_params(0), (h, w),
                           **kw)
    port = _prefilled(MultiStreamTracker)(
        PA.Darknet("yolov3-tiny", img_size=96, device="cpu"),
        [str(p1), str(p2)], random_reid_params(0), (h, w), **kw)
    steps = []
    for mst in (ref, port):
        mst.prefill()
        steps.append([(np.asarray(o), np.asarray(e), v,
                       np.asarray(mst.gid_state.gid),
                       np.asarray(mst.gid_state.owner))
                      for o, e, v in mst.run(max_steps=40)])
    assert port.host_readbacks == len(steps[1]), "one readback per step"
    assert [v.tolist() for *_, v, _, _ in steps[1]] == (
        [[True, True]] * 4 + [[True, False]] * 3)
    shown = 0
    for f, (want, got) in enumerate(zip(*steps, strict=True)):
        np.testing.assert_array_equal(got[3], want[3], err_msg=f"gid {f}")
        np.testing.assert_array_equal(got[4], want[4], err_msg=f"owner {f}")
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"emit {f}")
        for s in range(2):
            a, b = got[0][s][got[1][s]], want[0][s][want[1][s]]
            np.testing.assert_array_equal(a[:, 4], b[:, 4],
                                          err_msg=f"stream {s} step {f}")
            np.testing.assert_allclose(a[:, :4], b[:, :4], atol=1)
            assert (a[:, 4] > 0).all()
            shown += len(a)
    assert shown > 0, "rows with global ids were emitted"
    ref.close()
    port.close()


def _prefilled(cls):
    """``cls`` with a ``prefill()`` that decodes every clip whole into its
    ring (the ring must hold the clip) and no decoder threads."""

    class Prefilled(cls):
        def prefill(self):
            for i, path in enumerate(self.paths):
                cls._decoder(self, i, path)

        def _decoder(self, stream, path):
            pass

    return Prefilled
