"""The serving steps' stage spans and the detector's module spans
(``utils/profiling.span``) on the CPU, yolov3-tiny and yolov4 at 64 px, 2
streams of 64 x 128, float32 (the plain paths):

* under ``device_trace`` a K=1 step (``make_batched_step``) writes one
  ``ydt.k1_step`` holding, in order, the letterbox, detector, NMS, crops,
  embed and tracker spans;
* two chunks of ``BucketedScannedStep`` write their detect, stats-wait and
  track spans once a chunk, with one tracker span a frame inside the track;
* a detector forward writes one ``ydt.det.*`` span a module, in module
  order, named by its kind (yolov4: 72 mish, 35 leaky and 3 linear convs,
  3 max-pools, 21 routes, 2 upsamples, 23 shortcuts, 3 heads), and every
  operation between the first module's span and the last's lies in exactly
  one of them; a residual chain that the chain route claims is one
  ``ydt.det.block`` span in place of its modules';
* with no profiler recording, a step constructs no range at all;
* a step's outputs and states are the same bits with the profiler on and
  off.
"""

import dataclasses
import json
from collections import Counter
from typing import List, NamedTuple

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
from yolo_deepsort_tpu_torch.models.darknet import (
    BLOCK_SPAN,
    build_network,
    module_span,
)
from yolo_deepsort_tpu_torch.models.reid import random_reid_params
from yolo_deepsort_tpu_torch.ops.letterbox import letterbox_batch
from yolo_deepsort_tpu_torch.ops.resblock_kernel import (
    find_residual_spans,
    make_resblock_impl,
)
from yolo_deepsort_tpu_torch.parallel import streams as TS
from yolo_deepsort_tpu_torch.tools.honest_load import (
    bn_consistent_raw,
    calibrate_conf,
)
from yolo_deepsort_tpu_torch.utils import profiling as P
from yolo_deepsort_tpu_torch.weights import darknet_from_raw, reid_from_params

K, S, HW, IMG = 2, 2, (64, 128), 64
TRK = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
K1_STAGES = ["ydt.letterbox", "ydt.detector", "ydt.nms", "ydt.crops",
             "ydt.embed", "ydt.tracker"]
MODELS = ["yolov3-tiny", "yolov4"]
DET = "ydt.det."
# the modules of AlexeyAB's cfg/yolov4.cfg, by kind
YOLOV4_KINDS = {"ydt.det.conv.mish": 72, "ydt.det.conv.leaky": 35,
                "ydt.det.conv.linear": 3, "ydt.det.maxpool": 3,
                "ydt.det.route": 21, "ydt.det.upsample": 2,
                "ydt.det.shortcut": 23, "ydt.det.yolo": 3}


class Load(NamedTuple):
    detector: torch.nn.Module
    frames: torch.Tensor  # (K, S, H, W, 3) uint8
    conf_vec: np.ndarray  # (S,) float32


class Span(NamedTuple):
    name: str
    start: float
    end: float

    def holds(self, other: "Span") -> bool:
        return self.start <= other.start and other.end <= self.end


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the small ops of a 64 px net run faster alone
    than with a pool spinning over the test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def loads():
    """model -> a float32 detector with BN-consistent weights, K copies of
    S seeded noise frames, the thresholds of the float32 forward the steps
    run (``calibrate_conf``; yolov4's bf16 objectness saturates at 64 px)
    and a ReID net, built once a module."""
    cache = {}

    def get(model):
        if model not in cache:
            plan = build_network(ARCHITECTURES[model](img_size=IMG))
            base = torch.from_numpy(np.random.default_rng(0).integers(
                0, 256, (S, *HW, 3), dtype=np.uint8))
            detector = darknet_from_raw(plan, bn_consistent_raw(plan, base))
            cache[model] = dict(load=Load(
                detector=detector,
                frames=base[None].expand(K, -1, -1, -1, -1).contiguous(),
                conf_vec=calibrate_conf(detector, base, IMG, 4)),
                reid=reid_from_params(random_reid_params(0)))
        return cache[model]

    return get


@pytest.fixture(scope="module")
def setup(loads):
    return loads("yolov3-tiny")


def _k1_step(su):
    det_cfg = DetectorConfig(img_size=IMG,
                             conf_thres=float(su["load"].conf_vec.min()),
                             max_dets=TRK.max_dets)
    return TS.make_batched_step(su["load"].detector, su["reid"], det_cfg,
                                TRK, HW, cap=6, crop_window=(32, 32))


def _chunk_step(su):
    det_cfg = DetectorConfig(img_size=IMG, max_dets=TRK.max_dets)
    return TS.BucketedScannedStep(
        su["load"].detector, su["reid"], det_cfg, TRK, HW, buckets=(4, 8),
        conf_thres_per_stream=su["load"].conf_vec, windows=((32, 32),))


def _run(kind, su, units=2):
    """``units`` K=1 steps or chunks from fresh states -> (states, [rows,
    emit of each unit])."""
    states = TS.init_stream_states(TRK, S, "cpu")
    frames = su["load"].frames
    outs = []
    if kind == "k1":
        step = _k1_step(su)
        for i in range(units):
            states, out = step(states, frames[i % K])
            outs += list(out)
    else:
        step = _chunk_step(su)
        for _ in range(units):
            states, out = step.track(states, step.detect(frames))
            outs += list(out)
    return states, outs


def _events(trace_dir) -> List[dict]:
    (path,) = list(trace_dir.iterdir())
    return json.loads(path.read_text())["traceEvents"]


def _spans(trace_dir, modules: bool = False) -> List[Span]:
    """The ``ydt.*`` spans of the trace: the stage spans, or with
    ``modules`` the detector's module spans (``ydt.det.*``) alone."""
    spans = [Span(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in _events(trace_dir)
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("ydt.")
             and e["name"].startswith(DET) == modules]
    return sorted(spans, key=lambda s: (s.start, -s.end))


def test_span_is_live_only_while_a_profiler_records():
    off = P.span("ydt.a")
    assert off is P.span("ydt.b")  # one shared null context
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = P.span("ydt.a")
        assert isinstance(on, torch.profiler.record_function)
        with on:
            pass


def test_k1_step_spans_nest_in_stage_order(setup, tmp_path):
    step = _k1_step(setup)
    states = TS.init_stream_states(TRK, S, "cpu")
    with P.device_trace(str(tmp_path)):
        step(states, setup["load"].frames[0])
    spans = _spans(tmp_path)
    roots = [s for s in spans if s.name == "ydt.k1_step"]
    assert len(roots) == 1
    stages = [s for s in spans if s is not roots[0]]
    assert [s.name for s in stages] == K1_STAGES
    assert all(roots[0].holds(s) for s in stages)
    for a, b in zip(stages, stages[1:]):  # one after another, no overlap
        assert a.end <= b.start, (a, b)


def test_bucketed_chunks_write_their_stage_spans(setup, tmp_path):
    with P.device_trace(str(tmp_path)):
        _run("chunk", setup, units=2)
    spans = _spans(tmp_path)

    def named(name):
        return [s for s in spans if s.name == name]

    detects, waits, tracks = (named("ydt.chunk." + n)
                              for n in ("detect", "stats_wait", "track"))
    assert len(detects) == len(waits) == len(tracks) == 2
    for det, wait, trk in zip(detects, waits, tracks):
        assert det.end <= wait.start and wait.end <= trk.start
        inside = [s.name for s in spans if det.holds(s) and s is not det]
        assert inside == ["ydt.letterbox", "ydt.detector", "ydt.nms"]
        inside = [s.name for s in spans if trk.holds(s) and s is not trk]
        assert inside == ["ydt.crops", "ydt.embed"] + ["ydt.tracker"] * K
    assert len(named("ydt.tracker")) == 2 * K


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("kind", ["k1", "chunk"])
def test_off_path_constructs_no_range(loads, model, kind, monkeypatch):
    def no_range(name):
        raise AssertionError(f"a range {name!r} was built while no "
                             "profiler recorded")

    su = loads(model)
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    states, outs = _run(kind, su)
    assert int(states.next_id.sum()) > S  # tracks were started


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("kind", ["k1", "chunk"])
def test_outputs_equal_with_the_profiler_on_and_off(loads, model, kind,
                                                    tmp_path):
    su = loads(model)
    off_states, off = _run(kind, su, units=3)
    with P.device_trace(str(tmp_path)):
        on_states, on = _run(kind, su, units=3)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    for f in dataclasses.fields(off_states):
        assert torch.equal(getattr(on_states, f.name),
                           getattr(off_states, f.name)), f.name


def _chain_route(plan):
    """The chain route (plain version on the CPU) and the (start, modules)
    of every chain it claimed."""
    impl = make_resblock_impl(plan)
    claimed = []

    def route(x, convs, i):
        res = impl(x, convs, i)
        if res is not None:
            claimed.append((i, res[1]))
        return res

    return route, claimed


@pytest.mark.parametrize("route", ["modules", "chains"])
def test_detector_spans_cover_every_module(loads, route, tmp_path):
    load = loads("yolov4")["load"]
    plan = load.detector.plan
    defs = plan.defs()
    block_impl, claimed = (_chain_route(plan) if route == "chains"
                           else (None, []))
    xs = letterbox_batch(load.frames[0], IMG)
    with torch.no_grad():
        load.detector(xs, block_impl=block_impl)  # packs the chains' weights
        claimed.clear()
        with P.device_trace(str(tmp_path)):
            load.detector(xs, block_impl=block_impl)
    spans = _spans(tmp_path, modules=True)
    (det,) = [s for s in _spans(tmp_path) if s.name == "ydt.detector"]
    assert all(det.holds(s) for s in spans)
    for a, b in zip(spans, spans[1:]):  # one after another, no overlap
        assert a.end <= b.start, (a, b)
    # one span a module in module order, a claimed chain's modules as one
    want, i = [], 0
    starts = dict(claimed)
    while i < len(defs):
        if i in starts:
            want.append(BLOCK_SPAN)
            i += starts[i]
        else:
            want.append(module_span(defs[i]))
            i += 1
    assert [s.name for s in spans] == want
    if route == "modules":
        assert dict(Counter(want)) == YOLOV4_KINDS
    else:  # the three chains whose maps fit the kernel at 64 px
        chains = {c[0]: len(c) for c in find_residual_spans(plan)}
        assert [(i, 3 * chains[i]) for i, _ in claimed] == claimed
        assert len(claimed) == want.count(BLOCK_SPAN) == 3
    # every operation between the first module's span and the last's lies
    # in exactly one of them (with the chain route, in at most one: the
    # forward hands each module's input to the route and takes a claimed
    # chain's output back in views outside the route's span)
    ops = [Span(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in _events(tmp_path)
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"
           and spans[0].start <= float(e["ts"]) <= spans[-1].end]
    assert ops
    for op in ops:
        n = sum(s.holds(op) for s in spans)
        assert n == 1 or (route == "chains" and n == 0), op
