"""The benchmark's files: BENCHMARK.json keeps to its contract, every cell
finds its configuration, traffic mix, limits and metric readers by name,
each per-layer metric moves an end-to-end metric its cells report, the
conv counts of ``flops.py`` match a hand count, and the reference imports
nothing of the program, of JAX or of the JAX package.

    python -m pytest -q gpubench/
"""

import json
import re

import pytest

from gpubench import compare, flops, run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    bench, entry, cfg, cfg_path, traffic, limits = run.cell_files(cell)
    assert open(cfg_path).read().startswith("[net]")
    assert traffic["kind"] in ("chunk", "k1")
    assert set(limits) == set(compare.NUMBERS)
    # only the whole forward's number may go uncompared in a cell
    assert all(v is not None for k, v in limits.items() if k != "det_cos")
    e2e, layer = run.cell_metrics(bench, cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in bench["per_layer"]:
        if cell in m["workloads"]:
            assert m["moves"] in e2e, (m["name"], cell)
    for name in layer:
        assert (run.HERE / "metrics" / f"{name}.py").exists()


def test_config_files():
    for c in BENCH["configs"]:
        cfg = run.load_json(run.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == []
        assert cfg["dtype"] == "bfloat16"


def test_metric_readers_return_nothing_without_their_inputs():
    ctx = {"kind": "other", "trace": {"span_count": {}, "span_s": {}},
           "window": None}
    for m in BENCH["per_layer"]:
        assert run.read_metric(m["name"], ctx) is None


def test_flops_hand_count():
    # 3x3 stride 1, 32 -> 64 at 416 x 416 -> 416 x 416
    c = (32, 64, 3, 1, 416, 416, 416, 416)
    assert flops.conv_ops(c) == 2 * 416 * 416 * 64 * 32 * 9
    assert flops.conv_bytes(c, 2) == 2 * (2 * (416 * 416 * 32
                                               + 416 * 416 * 64)
                                          + 9 * 32 * 64)
    # 1x1 stride 2, 256 -> 512 at 16 x 8 -> 8 x 4
    d = (256, 512, 1, 2, 16, 8, 8, 4)
    assert flops.conv_ops(d, 3) == 3 * 2 * 8 * 4 * 512 * 256
    bound = max(flops.conv_ops(d, 3) / 989e12,
                flops.conv_bytes(d, 3) / 3.35e12)
    assert flops.roofline_s([d], 3) == pytest.approx(bound)
    # the published totals: 65.9 (yolov3-416) and 128.4 (yolov4-608)
    # GFLOP a frame, 2.24 GFLOP a ReID crop
    v3 = flops.detector_convs((run.HERE / "configs/yolov3.cfg").read_text(),
                              416)
    v4 = flops.detector_convs((run.HERE / "configs/yolov4.cfg").read_text(),
                              608)
    assert flops.total_ops(v3) / 1e9 == pytest.approx(65.86, abs=0.01)
    assert flops.total_ops(v4) / 1e9 == pytest.approx(128.39, abs=0.01)
    assert flops.total_ops(flops.reid_convs()) / 1e9 == pytest.approx(
        2.243, abs=0.001)


def test_a_null_limit_leaves_its_number_uncompared():
    numbers = {k: 0.0 for k in compare.NUMBERS}
    limits = dict(numbers, det_cos=None)
    numbers["det_cos"] = 0.5
    ok, checks = compare.verdict(numbers, limits)
    assert ok and "det_cos" not in checks
    numbers["det_layer_cos"] = 1e-3
    assert not compare.verdict(numbers, limits)[0]


def test_reference_imports_nothing_of_the_program():
    assert run.reference_imports() == []


def test_guard_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "yolo_deepsort_tpu_torch_x",
                        types.ModuleType("yolo_deepsort_tpu_torch_x"))
    assert "yolo_deepsort_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "yolo_deepsort_tpu.ops",
                        types.ModuleType("yolo_deepsort_tpu.ops"))
    assert "yolo_deepsort_tpu" in run.forbidden_modules()
