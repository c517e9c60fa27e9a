"""A whole run of the harness on the CPU at a tiny size (yolov3-tiny at 64
px, 2 streams of 64 x 128, float32 so the limits can be tight): the
result line's schema, the run with the timed path broken underneath --
each fault a cell can have must come out as not correct --, and the
controls in the program's place (its int8 route, the reference's W8A8
detector, a bfloat16 tracker), each of which must fail its number. The
look for a card is skipped by calling ``cell.run_cell`` directly. The
card's own runs are ``python3 -m gpubench.run`` and ``python3 -m
gpubench.control``.

    python -m pytest -q gpubench/
"""

import copy
import dataclasses
import json
import time

import pytest
import torch

from gpubench import cell, compare, control, run

BASE = run.load_json(run.HERE / "configs" / "yolov3-416.json")
TINY = dict(copy.deepcopy(BASE), cfg="yolov3-tiny.cfg", img_size=64,
            buckets=[4, 8], windows=[[32, 32]], dtype="float32",
            box_prior={"heights": [600.0, 800.0, 1000.0], "aspect": 0.41})
TINY["tracker"].update(max_tracks=16, max_dets=8, nn_budget=4)
TRAFFIC = {
    "chunk": {"kind": "chunk", "streams": 2, "chunk": 2,
              "frame_hw": [64, 128], "variants": 2, "noise_sigma": 4.0,
              "target_dets": 4, "margin": 1, "warmup": 1, "samples": 1,
              "trace_units": 2},
    "k1": {"kind": "k1", "streams": 2, "frame_hw": [64, 128],
           "variants": 2, "noise_sigma": 4.0, "target_dets": 4,
           "margin": 0, "cap": 6, "crop_window": [32, 32], "warmup": 3,
           "samples": 2, "trace_units": 2},
}
METRICS = {
    "chunk": (["fps", "setup_s"],
              ["detect_stage_ms.chunk", "track_stage_ms.chunk",
               "detector_roofline.chunk", "reid_roofline.chunk",
               "mfu.chunk", "idle_share.chunk"]),
    "k1": (["k1_p50_ms", "k1_p95_ms", "setup_s"],
           ["k1_device_ms", "k1_enqueue_ms", "mfu.k1", "idle_share.k1"]),
}
# float32 against float32: rounding apart, the two sides agree
LIMITS = {"det_cos": 1e-6, "det_layer_cos": 1e-6, "det_replay": 0.0,
          "frame_copies": 0.0, "nms_miss": 0.0, "feat_cos": 1e-6,
          "track_rows": 0.0, "state_miss": 0.0, "kalman_px": 1e-3}


def _run(kind, fault=None, traced=False, seed=2 ** 31 + 5, controls=False,
         seconds=0.5):
    e2e, layer = METRICS[kind]
    return cell.run_cell(TINY, str(run.HERE / "configs" / TINY["cfg"]),
                         TRAFFIC[kind], LIMITS, seed, seconds, traced,
                         torch.device("cpu"), e2e, layer, time.time(),
                         read_metric=run.read_metric, fault=fault,
                         controls=controls)


class Faulty:
    """The program's step with one fault underneath; everything else
    passes through."""

    def __init__(self, step, kind, fault):
        self._step, self._k1, self._fault = step, kind == "k1", fault

    def __getattr__(self, name):
        return getattr(self._step, name)

    def _frames(self, frames):
        if self._fault != "half_batch":
            return frames
        frames = frames.clone()  # half the streams left out: black frames
        frames[..., frames.shape[-4] // 2:, :, :, :] = 0
        return frames

    def _result(self, states, new, out):
        rows, emit = out
        if self._fault == "unchanged":
            new = states
        if self._fault == "altered":
            rows = rows.clone()
            rows[..., 0, :, 4] += 1000  # stream 0's track ids
        return new, (rows, emit)

    def detect(self, frames):
        return self._step.detect(self._frames(frames))

    def track(self, states, handle):
        before = _clone(states)
        new, out = self._step.track(states, handle)
        return self._result(before, new, out)

    def __call__(self, states, frames):
        before = _clone(states)
        new, out = self._step(states, self._frames(frames))
        return self._result(before, new, out)


def _clone(st):
    return dataclasses.replace(st, **{f.name: getattr(st, f.name).clone()
                                      for f in dataclasses.fields(st)})


@pytest.mark.parametrize("kind", ["chunk", "k1"])
def test_result_line_schema(kind):
    res = _run(kind)
    line = res["line"]
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert res["numbers"]["det_replay"] == 0.0
    assert set(line["metrics"]) == set(METRICS[kind][0])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(LIMITS)
    json.dumps(line)


@pytest.mark.parametrize("kind", ["chunk", "k1"])
def test_traced_line_schema(kind):
    line = _run(kind, traced=True)["line"]
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert set(line["metrics"]) <= set(METRICS[kind][1])
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("kind", ["chunk", "k1"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_step_is_not_correct(kind, fault):
    # a window long enough to reach its samples on a loaded host: the
    # first unit, from an empty state, has no confirmed track to alter
    res = _run(kind, fault=lambda step: Faulty(step, kind, fault),
               seconds=2.0)
    assert res["line"]["correct"] is False, res["numbers"]


def test_a_chunk_that_reuses_one_frame_is_not_correct():
    """Every frame of a chunk given the first frame's work (the control
    program's ``Broadcast``): the frames differ, so its decoded rows copy
    another frame's."""
    res = _run("chunk", fault=control.Broadcast)
    assert res["line"]["correct"] is False, res["numbers"]
    assert res["numbers"]["frame_copies"] == 1.0


def test_the_int8_controls_fail():
    """The program's int8 route fails the embed's number and, judged
    layer by layer on its own capture, the detector's; the reference
    computed with W8A8 rounding in its place fails the detector's, whole
    and layer by layer."""
    e2e, layer = METRICS["chunk"]
    res = cell.run_cell(TINY, str(run.HERE / "configs" / TINY["cfg"]),
                        TRAFFIC["chunk"], LIMITS, 23, 0.5, False,
                        torch.device("cpu"), e2e, layer, time.time(),
                        route="int8")
    assert res["line"]["correct"] is False
    assert res["numbers"]["feat_cos"] > 10 * LIMITS["feat_cos"]
    assert res["numbers"]["det_layer_cos"] > 10 * LIMITS["det_layer_cos"]
    assert res["numbers"]["det_replay"] == 0.0
    res = _run("chunk", seed=23, controls=True)
    assert res["line"]["correct"] is True
    det = res["controls"]["detector_int8"]
    assert det["det_cos"] > 10 * LIMITS["det_cos"]
    assert det["det_layer_cos"] > 10 * LIMITS["det_layer_cos"]


def test_the_bf16_tracker_control_fails():
    res = _run("k1", seed=17, controls=True)
    assert res["line"]["correct"] is True
    numbers = res["controls"]["tracker_bf16"]
    assert not compare.verdict(numbers, LIMITS)[0]
    assert numbers["kalman_px"] > 10 * LIMITS["kalman_px"]
