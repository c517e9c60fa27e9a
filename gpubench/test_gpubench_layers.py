"""The detector judged layer by layer, on the CPU: yolov3-tiny and yolov4
cut to 64 px, in bfloat16 as the cells run, 2 streams of 64 x 128 through
the K=1 step. The reference forward is its modules composed, bit for bit;
a sound run reads inside the K=1 cell's limits of ``det_layer_cos`` and
``det_replay``; and each fault planted in the program reads outside them:
a letterbox one pixel off, one conv's output rounded to int8 codes, a
mish computed as leaky, a shortcut dropped, a route's parts swapped, a
head that ignores its ``scale_x_y``, and a step whose timed rows differ by
one float from its eager capture. The faults are planted in the program's own detector, so
the timed step and the capture after the window both carry them.

    python -m pytest -q gpubench/
"""

import copy
import dataclasses
import time

import pytest
import torch

from gpubench import cell, load, run, serve
from gpubench.reference import darknet as ref_darknet

CPU = torch.device("cpu")
CELL_LIMITS = run.load_json(run.HERE / "limits" / "yolov3-416.k1.s8.d32.json")
NEW = ("det_layer_cos", "det_replay")
# the other numbers are the other tests' (a random detector in bf16 moves
# its whole forward far: yolov4's det_cos reads ~0.3 here)
LIMITS = {k: CELL_LIMITS[k] if k in NEW else float("inf")
          for k in CELL_LIMITS}
BASE = run.load_json(run.HERE / "configs" / "yolov3-416.json")
CFG = dict(copy.deepcopy(BASE), img_size=64, buckets=[4, 8],
           windows=[[32, 32]],
           box_prior={"heights": [600.0, 800.0, 1000.0], "aspect": 0.41})
CFG["tracker"].update(max_tracks=16, max_dets=8, nn_budget=4)
TRAFFIC = {"kind": "k1", "streams": 2, "frame_hw": [64, 128], "variants": 1,
           "noise_sigma": 0.0, "target_dets": 4, "margin": 0, "cap": 6,
           "crop_window": [32, 32], "warmup": 2, "samples": 1,
           "trace_units": 2}
CFGS = ["yolov3-tiny.cfg", "yolov4.cfg"]


def _defs(name):
    return ref_darknet.parse_cfg((run.HERE / "configs" / name).read_text())[1:]


def _run(name, seed=2 ** 31 + 11, controls=False):
    cfg = dict(CFG, cfg=name)
    return cell.run_cell(cfg, str(run.HERE / "configs" / name), TRAFFIC,
                         LIMITS, seed, 0.3, False, CPU,
                         ["k1_p50_ms", "setup_s"], [], time.time(),
                         controls=controls)


def _weights(defs):
    """The letterbox of two frames and raw params drawn and BN-captured
    as a run makes them, at 64 px."""
    frames = load.frames(7, 2, (48, 80), CPU)[0]
    raw = load.detector_weights(defs, 64, frames, 7, CFG["box_prior"])
    return ref_darknet.letterbox(frames, 64), raw


@pytest.mark.parametrize("name", CFGS)
@pytest.mark.parametrize("int8", [False, True])
def test_forward_is_its_modules_composed(name, int8):
    defs = _defs(name)
    x, raw = _weights(defs)
    outs, decoded = [], []
    for i, d in enumerate(defs):
        ins = [x if j < 0 else outs[j]
               for j in ref_darknet.sources(defs, i)]
        out = ref_darknet.module(defs, raw, i, ins, 64, int8=int8)
        if d["type"] == "yolo":
            decoded.append(out)
            out = ins[0]
        outs.append(out)
    want = ref_darknet.forward(defs, raw, x, 64, int8=int8)
    assert torch.equal(torch.cat(decoded, 1), want)


@pytest.mark.parametrize("name", CFGS)
def test_a_sound_run_reads_inside(name):
    res = _run(name, controls=True)
    numbers = res["numbers"]
    assert res["line"]["correct"] is True, numbers
    assert numbers["det_replay"] == 0.0
    assert 0.0 < numbers["det_layer_cos"] <= LIMITS["det_layer_cos"]
    # the reference's W8A8 in the program's place reads outside
    control = res["controls"]["detector_int8"]["det_layer_cos"]
    assert control > LIMITS["det_layer_cos"], control


def _letterbox_shifted(det, monkeypatch):
    """The letterbox one pixel to the right, in the serving steps and in
    the capture alike."""
    from yolo_deepsort_tpu_torch.ops import letterbox_kernel
    from yolo_deepsort_tpu_torch.parallel import streams

    plain = letterbox_kernel.letterbox_batch_fused

    def shifted(*args, **kwargs):
        return torch.roll(plain(*args, **kwargs), 1, dims=2)

    monkeypatch.setattr(letterbox_kernel, "letterbox_batch_fused", shifted)
    monkeypatch.setattr(streams, "letterbox_batch_fused", shifted)


def _int8_conv(det, monkeypatch):
    """The first conv's output rounded to int8 codes (one scale for the
    tensor), where the program computes it."""
    from yolo_deepsort_tpu_torch.models import darknet

    plain = darknet.conv_layer_bf16
    target = det.convs["0"]

    def rounded(conv, x, act, *args, **kwargs):
        out = plain(conv, x, act, *args, **kwargs)
        if conv is not target:
            return out
        return ref_darknet.fake_int8(out.float(), None).to(out.dtype)

    monkeypatch.setattr(darknet, "conv_layer_bf16", rounded)


def _first(det, kind, **want):
    for i, d in enumerate(det._defs):
        if d["type"] == kind and all(d.get(k) == v for k, v in want.items()):
            return i
    raise LookupError(kind)


def _mish_as_leaky(det, monkeypatch):
    det._defs[_first(det, "convolutional", activation="mish")][
        "activation"] = "leaky"


def _shortcut_dropped(det, monkeypatch):
    i = _first(det, "shortcut")
    det._defs[i] = {"type": "route", "layers": "-1"}  # the previous output


def _route_swapped(det, monkeypatch):
    i = next(i for i, d in enumerate(det._defs)
             if d["type"] == "route" and "," in d["layers"])
    d = det._defs[i]
    d["layers"] = ",".join(reversed(d["layers"].split(",")))


def _scale_x_y_ignored(det, monkeypatch):
    i = min(h for h, spec in det._heads.items() if spec.scale_x_y != 1.0)
    det._heads[i] = dataclasses.replace(det._heads[i], scale_x_y=1.0)


def _replay_moved(det, monkeypatch):
    """The timed step's rows one float away from what its detector
    computed: the last class score of stream 0's last row."""
    from yolo_deepsort_tpu_torch.parallel import streams

    replay = streams.DetectorGraph.__call__

    def moved(self, xs):
        out = replay(self, xs).clone()
        out[0, -1, -1] = torch.nextafter(out[0, -1, -1],
                                         torch.tensor(2.0))
        return out

    monkeypatch.setattr(streams.DetectorGraph, "__call__", moved)


FAULTS = {
    "letterbox_shifted": _letterbox_shifted,
    "int8_conv": _int8_conv,
    "mish_as_leaky": _mish_as_leaky,
    "shortcut_dropped": _shortcut_dropped,
    "route_swapped": _route_swapped,
    "scale_x_y_ignored": _scale_x_y_ignored,
    "replay_moved": _replay_moved,
}
CASES = ([("yolov3-tiny.cfg", f) for f in (
    "letterbox_shifted", "int8_conv", "route_swapped", "replay_moved")]
         + [("yolov4.cfg", f) for f in FAULTS])


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_reads_outside(name, fault, monkeypatch):
    build = serve.build

    def planted(*args, **kwargs):
        built = build(*args, **kwargs)
        FAULTS[fault](built[1], monkeypatch)
        return built

    monkeypatch.setattr(serve, "build", planted)
    res = _run(name)
    numbers = res["numbers"]
    assert res["line"]["correct"] is False, numbers
    number = "det_replay" if fault == "replay_moved" else "det_layer_cos"
    assert numbers[number] > LIMITS[number], numbers
