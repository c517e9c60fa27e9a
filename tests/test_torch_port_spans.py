"""The serving steps' stage spans (``utils/profiling.span``) on the CPU,
yolov3-tiny at 64 px, 2 streams of 64 x 128, float32 (the plain paths):

* under ``device_trace`` a K=1 step (``make_batched_step``) writes one
  ``ydt.k1_step`` holding, in order, the letterbox, detector, NMS, crops,
  embed and tracker spans;
* two chunks of ``BucketedScannedStep`` write their detect, stats-wait and
  track spans once a chunk, with one tracker span a frame inside the track;
* with no profiler recording, a step constructs no range at all;
* a step's outputs and states are the same bits with the profiler on and
  off.
"""

import dataclasses
import json
from typing import List, NamedTuple

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
from yolo_deepsort_tpu_torch.models.reid import random_reid_params
from yolo_deepsort_tpu_torch.parallel import streams as TS
from yolo_deepsort_tpu_torch.tools.honest_load import bn_weights_and_frames
from yolo_deepsort_tpu_torch.utils import profiling as P
from yolo_deepsort_tpu_torch.weights import reid_from_params

K, S, HW, IMG = 2, 2, (64, 128), 64
TRK = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
K1_STAGES = ["ydt.letterbox", "ydt.detector", "ydt.nms", "ydt.crops",
             "ydt.embed", "ydt.tracker"]


class Span(NamedTuple):
    name: str
    start: float
    end: float

    def holds(self, other: "Span") -> bool:
        return self.start <= other.start and other.end <= self.end


@pytest.fixture(scope="module")
def setup():
    load = bn_weights_and_frames("yolov3-tiny", IMG, K, S, HW, target=4,
                                 device="cpu")
    return dict(load=load, reid=reid_from_params(random_reid_params(0)))


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


def _spans(trace_dir) -> List[Span]:
    (path,) = list(trace_dir.iterdir())
    events = json.loads(path.read_text())["traceEvents"]
    spans = [Span(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("ydt.")]
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


@pytest.mark.parametrize("kind", ["k1", "chunk"])
def test_off_path_constructs_no_range(setup, kind, monkeypatch):
    def no_range(name):
        raise AssertionError(f"a range {name!r} was built while no "
                             "profiler recorded")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    states, outs = _run(kind, setup)
    assert int(states.next_id.sum()) > S  # tracks were started


@pytest.mark.parametrize("kind", ["k1", "chunk"])
def test_outputs_equal_with_the_profiler_on_and_off(setup, kind, tmp_path):
    off_states, off = _run(kind, setup, units=3)
    with P.device_trace(str(tmp_path)):
        on_states, on = _run(kind, setup, units=3)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    for f in dataclasses.fields(off_states):
        assert torch.equal(getattr(on_states, f.name),
                           getattr(off_states, f.name)), f.name
