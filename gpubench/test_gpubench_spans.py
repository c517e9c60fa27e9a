"""The program's spans in the traced slice (``spans.py``) and the stage
metrics that read them: ``reduce_program`` on a hand-made trace against
hand-computed numbers, ``reduce_events`` blind to the program's spans,
the readers on that trace and on a CPU trace (no device operation: the
device numbers read nothing), and a traced CPU K=1 run of the harness
with the program's reduction beside its own.

    python -m pytest -q gpubench/
"""

import copy
import time

import pytest
import torch

from gpubench import cell, run, spans, trace
from gpubench.test_gpubench_run import LIMITS, TINY, TRAFFIC

CELL = "yolov3-416.k1.s8.d32"
NEW = spans.STAGE_METRICS


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    """One K=1 step in microseconds: the harness's ``k1_step`` [0, 100]
    holds ``ydt.k1_step`` [10, 88], which holds ``ydt.detector`` [12, 40]
    and ``ydt.embed`` [50, 70]; then ``read_out`` [100, 130]. Two kernels
    launched in the detector, a fill in the step's own code, a kernel in
    the embed, a copy in ``read_out``, one operation whose launch is not in
    the trace; a sync in the embed and one in ``read_out``."""
    return [
        _x("user_annotation", "k1_step", 0, 100),
        _x("user_annotation", "ydt.k1_step", 10, 78),
        _x("user_annotation", "ydt.detector", 12, 28),
        _x("user_annotation", "ydt.embed", 50, 20),
        _x("user_annotation", "read_out", 100, 30),
        _x("gpu_user_annotation", "ydt.k1_step", 20, 70),  # never an op
        _x("cpu_op", "aten::conv2d", 14, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2),
        _x("cuda_runtime", "cudaMemsetAsync", 45, 1, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 55, 1, corr=4),
        _x("cuda_runtime", "cudaStreamSynchronize", 60, 5),
        _x("cuda_runtime", "cudaMemcpyAsync", 105, 1, corr=5),
        _x("cuda_runtime", "cudaStreamSynchronize", 110, 10),
        _x("kernel", "conv_a", 20, 10, corr=1),
        _x("kernel", "conv_b", 30, 5, corr=2),
        _x("gpu_memset", "Memset", 45, 2, corr=3),
        _x("kernel", "embed", 80, 10, corr=4),
        _x("gpu_memcpy", "Memcpy DtoH", 120, 5, corr=5),
        _x("kernel", "unlaunched", 125, 1, corr=99),
    ]


US = 1e-6
WANT = {  # n, host, self host, device, self device, ops, syncs
    "k1_step": (1, 100, 22, 27, 0, 4, 1),
    "ydt.k1_step": (1, 78, 30, 27, 2, 4, 1),
    "ydt.detector": (1, 28, 28, 15, 15, 2, 0),
    "ydt.embed": (1, 20, 20, 10, 10, 1, 1),
    "read_out": (1, 30, 30, 5, 5, 1, 1),
}
KEYS = ("n", "host_s", "self_host_s", "device_s", "self_device_s", "ops",
        "syncs")


def test_reduce_program_by_hand():
    prog = spans.reduce_program(_events())
    assert set(prog["spans"]) == set(WANT)
    for name, want in WANT.items():
        got = prog["spans"][name]
        assert set(got) == set(KEYS)
        for key, w in zip(KEYS, want):
            scale = US if key.endswith("_s") else 1
            assert got[key] == pytest.approx(w * scale), (name, key)
    # gaps [35, 45] (the host in the detector), [47, 80] (in the step's
    # own code) and [90, 120] (back in the harness's span)
    assert prog["idle_by_span"] == {
        "k1_step/ydt.k1_step/ydt.detector": {"s": pytest.approx(10 * US),
                                             "n": 1},
        "k1_step/ydt.k1_step": {"s": pytest.approx(33 * US), "n": 1},
        "k1_step": {"s": pytest.approx(30 * US), "n": 1}}
    assert prog["n_device_ops"] == 6


def test_reduce_events_is_blind_to_the_program_spans():
    events = _events()
    harness_only = [e for e in events if not (
        e["cat"] == "user_annotation" and e["name"].startswith("ydt."))]
    assert len(harness_only) == len(events) - 3
    assert trace.reduce_events(events) == trace.reduce_events(harness_only)


def _ctx(program):
    return {"kind": "k1", "trace": {"span_count": {}, "span_s": {},
                                    "program": program}, "window": None}


def test_readers_on_the_hand_made_trace():
    ctx = _ctx(spans.reduce_program(_events()))
    got = {n: run.read_metric(n, ctx) for n in NEW}
    want = {"k1_host_ms.detector": 28e-3, "k1_host_ms.embed": 20e-3,
            "k1_device_ms.detector": 15e-3, "k1_device_ms.embed": 10e-3,
            "k1_launches": 4, "k1_syncs": 1, "k1_starved_ms": 43e-3}
    for name, value in want.items():
        assert got[name]["value"] == pytest.approx(value), name
    # no tracker span in this trace
    assert got["k1_host_ms.tracker"] is None
    assert got["k1_device_ms.tracker"] is None


def test_device_readers_read_nothing_without_device_operations():
    events = [e for e in _events() if e["cat"] in ("user_annotation",
                                                   "cpu_op")]
    ctx = _ctx(spans.reduce_program(events))
    for name in NEW:  # no tracker span in this trace
        v = run.read_metric(name, ctx)
        assert (v is not None) == (name in ("k1_host_ms.detector",
                                            "k1_host_ms.embed")), name
    ctx["kind"] = "chunk"
    assert all(run.read_metric(n, ctx) is None for n in NEW)
    # the parent program: no span of its own
    harness = [e for e in _events() if not e["name"].startswith("ydt.")]
    ctx = _ctx(spans.reduce_program(harness))
    assert all(run.read_metric(n, ctx) is None for n in NEW)


def test_traced_cpu_k1_run_reports_the_host_stages():
    """As ``python3 -m gpubench.spans`` runs a cell, on the CPU: the
    cell's metrics and the stage metrics, the slice reduced both ways."""
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    e2e, layer = run.cell_metrics(bench, CELL)
    plain = trace.reduce_events
    with spans.program_reduced() as got:
        res = cell.run_cell(TINY, str(run.HERE / "configs" / TINY["cfg"]),
                            copy.deepcopy(TRAFFIC["k1"]), LIMITS,
                            2 ** 31 + 9, 0.5, True, torch.device("cpu"), e2e,
                            layer + list(NEW), time.time(),
                            read_metric=run.read_metric)
    assert trace.reduce_events is plain  # restored
    assert res["line"]["correct"] is True
    metrics = res["line"]["metrics"]
    host = [m for m in NEW if m.startswith("k1_host_ms.")]
    assert set(NEW) & set(metrics) == set(host)
    assert set(layer) & set(metrics)  # the cell's own, as before
    prog = got["program"]
    units = TRAFFIC["k1"]["trace_units"]
    root = prog["spans"]["ydt.k1_step"]
    assert root["n"] == units
    for name in ("ydt.letterbox", "ydt.detector", "ydt.nms", "ydt.crops",
                 "ydt.embed", "ydt.tracker"):
        assert prog["spans"][name]["n"] == units, name
    total = sum(metrics[m]["value"] for m in host)
    assert 0 < total <= root["host_s"] / units * 1e3
