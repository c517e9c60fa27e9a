"""The detector's split by module kind
(``yolo_deepsort_tpu_torch/tools/detector_kinds.py``), on the CPU:

* its attribution, from a synthetic chrome trace to per-kind device ms:
  each device operation to the innermost ``ydt.det.*`` range holding its
  launch (by correlation id), the others ``outside``;
* its conv arithmetic against the benchmark's ``gpubench/flops.py`` on
  yolov4 at 608: the same conv shapes, 128.39 GFLOP a frame and 1.70 ms of
  roofline at batch 8;
* one run of the tool at a tiny size, one JSON line with every kind.
"""

import json

import pytest

from gpubench import flops
from gpubench.reference import darknet as ref_darknet
from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
from yolo_deepsort_tpu_torch.models.darknet import build_network
from yolo_deepsort_tpu_torch.tools import detector_kinds as DK


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_attribution_of_a_synthetic_trace():
    # two forwards of a net of a mish conv, a route and a head; a launch
    # outside every module range, one whose launch is not in the trace
    events = [{"ph": "i", "name": "marker", "ts": 0}]
    corr = 0
    for t0 in (0.0, 1000.0):
        events.append(_x("user_annotation", "ydt.detector", t0, 500))
        for name, start, kernels in (
                ("ydt.det.conv.mish", t0 + 10, [40.0, 60.0]),
                ("ydt.det.route", t0 + 200, [8.0]),
                ("ydt.det.yolo", t0 + 300, [5.0, 5.0, 2.0])):
            events.append(_x("user_annotation", name, start, 80))
            for j, dur in enumerate(kernels):
                corr += 1
                events.append(_x("cuda_runtime", "cudaLaunchKernel",
                                 start + 5 + j, 2, corr))
                events.append(_x("kernel", "k", t0 + 600 + corr, dur, corr))
        corr += 1  # the input's cast, inside the detector, in no module
        events.append(_x("cuda_runtime", "cudaLaunchKernel", t0 + 2, 1, corr))
        events.append(_x("gpu_memcpy", "copy", t0 + 700, 3.0, corr))
    events.append(_x("kernel", "lost", 5000, 7.0, 999))
    found = DK.attribute(events)
    assert found["ydt.det.conv.mish"] == {"n": 2, "device_s": 200e-6,
                                          "ops": 4}
    assert found["ydt.det.route"] == {"n": 2, "device_s": 16e-6, "ops": 2}
    assert found["ydt.det.yolo"]["ops"] == 6
    assert found["ydt.det.yolo"]["device_s"] == pytest.approx(24e-6)
    assert found["outside"]["ops"] == 3
    assert found["outside"]["device_s"] == pytest.approx(13e-6)
    assert "ydt.detector" not in found

    defs = [{"type": "convolutional", "batch_normalize": "1", "filters": "18",
             "size": "3", "stride": "1", "pad": "1", "activation": "mish"},
            {"type": "route", "layers": "-1"},
            {"type": "yolo", "mask": "0,1,2", "anchors": "10,13,16,30,33,23",
             "classes": "1", "num": "3"}]
    table = DK.kind_table(defs, 8, 2, found, forwards=2)
    mish = table["kinds"]["ydt.det.conv.mish"]
    assert mish["modules"] == 1 and mish["ops"] == 2
    assert mish["device_ms"] == pytest.approx(0.1)
    assert mish["gflop"] == pytest.approx(2 * 2 * 8 * 8 * 18 * 3 * 9 / 1e9)
    assert mish["roofline_share"] == pytest.approx(
        100 * mish["roofline_ms"] / 0.1)
    assert mish["gbytes"] == pytest.approx(
        2 * (2 * (8 * 8 * 3 + 8 * 8 * 18) + 9 * 3 * 18) / 1e9)
    route = table["kinds"]["ydt.det.route"]
    assert route["gbytes"] == 0.0  # a view
    assert route["roofline_ms"] == 0.0 and route["roofline_share"] is None
    assert table["total"]["roofline_ms"] == pytest.approx(
        mish["roofline_ms"])  # the convs'
    assert table["total"]["device_ms"] == pytest.approx(0.1 + 0.008 + 0.012)
    assert table["total"]["modules"] == 3
    assert table["outside"] == {"device_ms": pytest.approx(0.0065),
                                "ops": 1.5}


def test_conv_arithmetic_matches_the_benchmarks_on_yolov4_608():
    defs = build_network(ARCHITECTURES["yolov4"](img_size=608)).defs()
    rows = DK.module_shapes(defs, 608)
    convs = [r["conv"] for r in rows if "conv" in r]
    cfg = (flops.__file__.rsplit("/", 1)[0] + "/configs/yolov4.cfg")
    want = flops.detector_convs(open(cfg).read(), 608)
    assert convs == want
    assert sum(DK.conv_ops(c) for c in convs) / 1e9 == pytest.approx(
        128.39, abs=0.01)
    roof = sum(DK.conv_roofline_s(c, 8) for c in convs)
    assert roof == pytest.approx(flops.roofline_s(want, 8))
    assert roof * 1e3 == pytest.approx(1.70, abs=0.005)
    # every module's output size, against the reference's walk
    shapes = {c["index"]: (c["co"], c["hout"], c["wout"])
              for c in ref_darknet.conv_shapes(defs, 608)}
    for i, r in enumerate(rows):
        if i in shapes:
            assert r["out"] == shapes[i], i
    assert [r["out"][1] for r in rows if r["span"] == "ydt.det.yolo"] == [
        76, 38, 19]


def test_tool_prints_one_line_with_every_kind(capsys):
    assert DK.main(["--model", "yolov3-tiny", "--img-size", "64", "--batch",
                    "2", "--forwards", "2", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    kinds = line["kinds"]
    # yolov3-tiny: 11 leaky and 2 linear convs, 6 max-pools, 2 routes, an
    # upsample, 2 heads
    assert {k: v["modules"] for k, v in kinds.items()} == {
        "ydt.det.conv.leaky": 11, "ydt.det.conv.linear": 2,
        "ydt.det.maxpool": 6, "ydt.det.route": 2, "ydt.det.upsample": 1,
        "ydt.det.yolo": 2}
    assert line["total"]["modules"] == 24
    assert line["total"]["gflop"] > 0 and line["device"] == "cpu"
