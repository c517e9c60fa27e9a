"""The K=1 step's detector graph (``parallel/streams.py`` ``DetectorGraph``)
against an eager twin of the same step on the card.

yolov3 at 128 (its three residual chains fit the chain kernel there), 2
streams of 96x160 frames, four noisy frame sets of one scene in turn. For
each route -- the bf16 default (every conv on kernel 7), float32 (library
convs), the conv route with an int8 package (kernel 7's int8 modes) and the
chain route (kernel 9) -- a graphed step and its twin, whose detector always
runs eagerly, start from the same states and are fed the same frames. Every
step's rows, emit mask, tracker-state field and the detector's decoded rows
are held exactly equal. The graph follows an in-place weight change and a
second stream count (one eager call, then a new capture), and the launch
counters count the detector's kernels at the eager call and the capture,
never at a replay. yolov4 at its published 608, 8 streams of 1080p in bf16,
replays its detector bit for bit as its eager forward computes it.

Every test is marked ``gpu`` and skips without a CUDA device. This file
imports no jax:

    python -m pytest --noconftest -q -m gpu \
        tests/test_torch_port_k1_graph_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from specs.weights_np import random_darknet_weights
from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
from yolo_deepsort_tpu_torch.kernels.launches import (read_launches,
                                                      zero_launches)
from yolo_deepsort_tpu_torch.models.darknet import build_network
from yolo_deepsort_tpu_torch.models.quantize_darknet import (
    quantize_darknet_from_frames,
)
from yolo_deepsort_tpu_torch.models.reid import random_reid_params
from yolo_deepsort_tpu_torch.ops.letterbox_kernel import letterbox_batch_fused
from yolo_deepsort_tpu_torch.parallel import streams as TS
from yolo_deepsort_tpu_torch.weights import (
    darknet_from_raw,
    load_darknet_weights,
    reid_from_params,
)

pytestmark = pytest.mark.gpu

H, W, S, SIZE, STEPS, VARIANTS = 96, 160, 2, 128, 20, 4
GRAPH = ("detector_graph", "detector_capture", "detector_eager")


@pytest.fixture(scope="module")
def load():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    plan = build_network(ARCHITECTURES["yolov3"](img_size=SIZE))
    blob = random_darknet_weights(plan.defs(), seed=0, well_conditioned=True)
    _, raw = load_darknet_weights(blob, plan.defs())
    # one scene a stream, each frame set with its own sensor noise: the
    # input changes every step and the tracks still confirm
    rng = np.random.default_rng(0)
    scene = rng.integers(0, 256, (1, S, H, W, 3))
    noise = rng.integers(-2, 3, (VARIANTS, S, H, W, 3))
    frames = torch.from_numpy(np.clip(scene + noise, 0, 255).astype(
        np.uint8)).to(dev)
    f32 = darknet_from_raw(plan, raw).to(dev)
    pkg = quantize_darknet_from_frames(f32, frames[0], SIZE, k3_only=True)
    assert pkg
    return dict(dev=dev, plan=plan, raw=raw, frames=frames, pkg=pkg)


def _models(load, dtype):
    cl = torch.channels_last
    detector = darknet_from_raw(load["plan"], load["raw"]).to(
        load["dev"], dtype, memory_format=cl)
    reid = reid_from_params(random_reid_params(0)).to(
        load["dev"], dtype, memory_format=cl)
    return detector, reid


class _Eager(TS.DetectorGraph):
    """The twin's detector: the same forward, never captured."""

    def __call__(self, xs):
        return self.forward(xs)


def _steps(load, detector, reid, route, monkeypatch):
    """(graphed step, eager twin, trk_cfg): the same ``make_batched_step``
    twice, the twin built with ``_Eager``."""
    xs = letterbox_batch_fused(load["frames"][0], SIZE,
                               next(detector.parameters()).dtype)
    with torch.no_grad():
        obj = detector(xs)[..., 4].flatten().sort(descending=True).values
    # halfway between the 12th and 13th objectness of the first frame set
    thr = float((obj[11] + obj[12]) / 2)
    det_cfg = DetectorConfig(img_size=SIZE, conf_thres=thr, max_dets=16)
    trk_cfg = TrackerConfig(max_tracks=32, max_dets=16, nn_budget=4)
    kw = dict(cap=12, crop_window=(48, 64), **route)
    graphed = TS.make_batched_step(detector, reid, det_cfg, trk_cfg, (H, W),
                                   **kw)
    with monkeypatch.context() as m:
        m.setattr(TS, "DetectorGraph", _Eager)
        twin = TS.make_batched_step(detector, reid, det_cfg, trk_cfg, (H, W),
                                    **kw)
    return graphed, twin, trk_cfg


def _recording(monkeypatch):
    """The decoded rows handed to the K=1 step's NMS, a clone per call."""
    seen = []
    nms = TS.batched_nms

    def recorded(decoded, *args):
        seen.append(decoded.clone())
        return nms(decoded, *args)

    monkeypatch.setattr(TS, "batched_nms", recorded)
    return seen


def _assert_equal(a, b, tag):
    assert torch.equal(a, b), tag


def _assert_states_equal(a, b, tag):
    for f in dataclasses.fields(a):
        _assert_equal(getattr(a, f.name), getattr(b, f.name),
                      f"{tag}: {f.name}")


def _run_pair(graphed, twin, trk_cfg, frames, steps, seen, s=S,
              states=None):
    """``steps`` calls of both steps over the frame sets in turn; every
    output, state field and decoded tensor held equal. -> (states, the
    graphed step's per-call launch deltas, emitted rows)."""
    dev = frames.device
    if states is None:
        states = (TS.init_stream_states(trk_cfg, s, dev),) * 2
    st_g, st_e = states
    deltas, emitted = [], 0
    for i in range(steps):
        fr = frames[i % frames.shape[0]][:s]
        before = read_launches()
        st_g, (out_g, emit_g) = graphed(st_g, fr)
        after = read_launches()
        deltas.append({k: after[k] - before[k] for k in after})
        dec_g = seen[-1]
        st_e, (out_e, emit_e) = twin(st_e, fr)
        dec_e = seen[-1]
        tag = f"step {i}"
        _assert_equal(dec_g, dec_e, f"{tag}: decoded")
        _assert_equal(out_g, out_e, f"{tag}: outputs")
        _assert_equal(emit_g, emit_e, f"{tag}: emit")
        _assert_states_equal(st_g, st_e, tag)
        emitted += int(emit_g.sum())
    return (st_g, st_e), deltas, emitted


def _detector_launches(detector, route, xs):
    """Kernel launches of one eager forward of the route's detector."""
    conv_impl = TS._make_conv_impl(route.get("use_pallas_conv", False),
                                   route.get("backbone_int8_pkg"))
    block_impl = TS._make_block_impl(detector.plan,
                                     route.get("use_resblock", False),
                                     route.get("backbone_int8_pkg"))
    zero_launches()
    with torch.no_grad():
        TS.DetectorGraph(detector, conv_impl, block_impl).forward(xs)
    torch.cuda.synchronize()
    return {k: v for k, v in read_launches().items() if v}


ROUTES = {
    "bf16": (torch.bfloat16, {}),
    "f32": (torch.float32, {}),
    "int8_conv": (torch.bfloat16, {"use_pallas_conv": True, "int8": True}),
    "resblock": (torch.bfloat16, {"use_resblock": True}),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_graphed_k1_step_equals_eager_twin(load, name, monkeypatch):
    dtype, route = ROUTES[name]
    route = dict(route)
    if route.pop("int8", False):
        route["backbone_int8_pkg"] = load["pkg"]
    detector, reid = _models(load, dtype)
    graphed, twin, trk_cfg = _steps(load, detector, reid, route, monkeypatch)
    seen = _recording(monkeypatch)
    det = _detector_launches(
        detector, route, letterbox_batch_fused(load["frames"][0], SIZE,
                                               dtype))
    if name == "f32":
        assert det == {}  # library convs: no kernel of the port
    else:
        assert det.get("conv", 0) + det.get("resblock", 0) > 0, det
    if name == "resblock":
        assert det["resblock"] == 3, det  # one launch per routed chain
    zero_launches()
    _, deltas, emitted = _run_pair(graphed, twin, trk_cfg, load["frames"],
                                   STEPS, seen)
    assert emitted > 0, "tracks confirmed and were emitted"
    totals = read_launches()
    assert {k: totals[k] for k in GRAPH} == {
        "detector_graph": STEPS - 1, "detector_capture": 1,
        "detector_eager": 1}
    eager, capture, replay = deltas[0], deltas[1], deltas[2]
    assert {k: eager[k] for k in GRAPH} == {
        "detector_graph": 0, "detector_capture": 0, "detector_eager": 1}
    assert {k: capture[k] for k in GRAPH} == {
        "detector_graph": 1, "detector_capture": 1, "detector_eager": 0}
    # the capture counts the detector's launches as the eager call does; a
    # replay counts none of them
    strip = lambda d: {k: v for k, v in d.items() if k not in GRAPH}
    assert strip(capture) == strip(eager)
    want = {k: v - det.get(k, 0) for k, v in strip(eager).items()}
    for i, d in enumerate(deltas[2:], 2):
        assert strip(d) == want, (i, d, want)
        assert {k: d[k] for k in GRAPH} == {
            "detector_graph": 1, "detector_capture": 0,
            "detector_eager": 0}, i


def test_graph_follows_weights_and_stream_count(load, monkeypatch):
    """An in-place weight change invalidates the graph (one eager call, a
    new capture) and the graphed step follows the new weights; a second
    stream count captures a second graph; both stay equal to the twin."""
    detector, reid = _models(load, torch.bfloat16)
    graphed, twin, trk_cfg = _steps(load, detector, reid, {}, monkeypatch)
    seen = _recording(monkeypatch)
    frames = load["frames"]
    zero_launches()
    states, _, _ = _run_pair(graphed, twin, trk_cfg, frames, 4, seen)
    before = seen[-2].clone()  # the graphed step's decoded, frame set 3
    with torch.no_grad():
        for conv in list(detector.convs.values())[-3:]:
            conv.weight.mul_(0.5)
    states, _, _ = _run_pair(graphed, twin, trk_cfg, frames[3:], 1, seen,
                             states=states)
    assert not torch.equal(seen[-2], before), "the new weights are read"
    states, _, _ = _run_pair(graphed, twin, trk_cfg, frames, 4, seen,
                             states=states)
    got = read_launches()
    assert {k: got[k] for k in GRAPH} == {
        "detector_graph": 3 + 4, "detector_capture": 2, "detector_eager": 2}
    # three streams: a new key, so one eager call and a new capture
    frames3 = torch.cat([frames, frames[:, :1].flip(2)], 1)
    _run_pair(graphed, twin, trk_cfg, frames3, 4, seen, s=S + 1)
    got = read_launches()
    assert {k: got[k] for k in GRAPH} == {
        "detector_graph": 7 + 3, "detector_capture": 3, "detector_eager": 3}


def test_no_capture_while_the_profiler_records(load, monkeypatch):
    """A step whose graph is still to be captured runs eagerly while a
    torch profiler records, and captures at the first call after it."""
    detector, reid = _models(load, torch.bfloat16)
    graphed, twin, trk_cfg = _steps(load, detector, reid, {}, monkeypatch)
    seen = _recording(monkeypatch)
    frames = load["frames"]
    zero_launches()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        states, _, _ = _run_pair(graphed, twin, trk_cfg, frames, 2, seen)
    got = read_launches()
    assert {k: got[k] for k in GRAPH} == {
        "detector_graph": 0, "detector_capture": 0, "detector_eager": 2}
    _run_pair(graphed, twin, trk_cfg, frames, 2, seen, states=states)
    got = read_launches()
    assert {k: got[k] for k in GRAPH} == {
        "detector_graph": 2, "detector_capture": 1, "detector_eager": 2}


def test_yolov4_608_replay_equals_eager():
    """yolov4 at its published 608, 8 streams of 1080p, bf16 (every conv
    on kernel 7): the replayed detector's decoded rows are its eager
    forward's bit for bit, on two frame sets in turn, and the eager
    forward under a profiler (its module spans recorded) gives them too.
    Every call counts the forward's 72 mish convs in ``conv_mish``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from torch.profiler import ProfilerActivity, profile

    from yolo_deepsort_tpu_torch.tools.honest_load import bn_consistent_raw

    dev = torch.device("cuda", 0)
    plan = build_network(ARCHITECTURES["yolov4"](img_size=608))
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 8, 1080, 1920, 3),
                                           dtype=np.uint8)).to(dev)
    detector = darknet_from_raw(plan, bn_consistent_raw(plan, frames[0])).to(
        dev, torch.bfloat16, memory_format=torch.channels_last)
    graph = TS.DetectorGraph(detector)
    zero_launches()
    with torch.no_grad():
        for i in range(5):
            xs = letterbox_batch_fused(frames[i % 2], 608, torch.bfloat16)
            mish = read_launches()["conv_mish"]
            got = graph(xs).clone()
            # 72 mish convs a forward: eager, captured and replayed alike
            assert read_launches()["conv_mish"] - mish == 72, f"call {i}"
            _assert_equal(got, graph.forward(xs), f"call {i}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            traced = graph.forward(xs)
        _assert_equal(traced, got, "under the profiler")
    got = read_launches()
    assert {k: got[k] for k in GRAPH} == {
        "detector_graph": 4, "detector_capture": 1, "detector_eager": 1}
