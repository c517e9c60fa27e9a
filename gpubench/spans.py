"""The program's own stage spans in a traced slice: ``ydt.*`` ranges that
``yolo_deepsort_tpu_torch`` opens at its stage boundaries
(``utils/profiling.span``, live only while a torch profiler records),
nested inside the harness's spans of ``trace.py``.

    python3 -m gpubench.spans --workload <cell> --seed <n> --seconds <s>

runs one traced run of a K=1 cell as ``gpubench.run --trace 1`` does, with
the slice's events also reduced here, and prints the program's table
(``{"program": ...}``, totals over the slice) and the stage metrics of
``STAGE_METRICS`` (``metrics/<name>.py``, per step) on lines of their own
before the result line. ``trace.profiled`` does not keep this reduction
yet, so ``gpubench.run`` reports none of them.

The matching rules are ``trace.py``'s: a device operation (kernel, copy or
fill) belongs to the innermost span whose host interval holds the runtime
call that launched it, matched by the profiler's correlation id. Spans
nest, so an operation also counts toward every span around that one. A
host sync is a runtime call that blocks the host on the device
(``SYNCS``); a blocking copy to the card shows up as a
``cudaMemcpyAsync`` followed by a ``cudaStreamSynchronize``, and counts
through the latter. An idle gap of the device union is keyed by the full
path of spans the host was in when the gap began (``host`` outside every
span)."""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

from . import trace

PREFIX = "ydt."
STAGE_METRICS = ("k1_host_ms.detector", "k1_host_ms.embed",
                 "k1_host_ms.tracker", "k1_device_ms.detector",
                 "k1_device_ms.embed", "k1_device_ms.tracker", "k1_launches",
                 "k1_syncs", "k1_starved_ms")
SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize",
         "cudaDeviceSynchronize", "cudaMemcpy")


class _Span(NamedTuple):
    start: float
    end: float
    name: str
    parent: Optional[int]


def reduce_program(events: List[Dict]) -> Dict:
    """Chrome-trace events -> {"spans": {name: {"n", "host_s",
    "self_host_s", "device_s", "self_device_s", "ops", "syncs"}} for every
    harness and ``ydt.*`` span name, "idle_by_span": {path: {"s", "n"}},
    "n_device_ops"}. ``device_s``, ``ops`` and ``syncs`` count what was
    launched or called anywhere inside the span, ``self_device_s`` only
    what no child span holds; ``self_host_s`` is the span's duration less
    its child spans'."""
    device, launch, calls, raw = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in trace.DEVICE_CATS:
            device.append((float(e["ts"]), float(e["dur"]),
                           (e.get("args") or {}).get("correlation")))
        elif cat in trace.LAUNCH_CATS:
            ts = float(e["ts"])
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = ts
            if e["name"] in SYNCS:
                calls.append(ts)
        elif cat == "user_annotation" and (e["name"] in trace.SPANS or
                                           e["name"].startswith(PREFIX)):
            ts = float(e["ts"])
            raw.append((ts, -(ts + float(e["dur"])), e["name"]))
    spans = _nest(sorted(raw))
    starts = [s.start for s in spans]

    def innermost(t: float) -> Optional[int]:
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return None
        while i is not None and spans[i].end < t:  # ended before t
            i = spans[i].parent
        return i

    def around(i: Optional[int]) -> List[int]:
        out = []
        while i is not None:
            out.append(i)
            i = spans[i].parent
        return out

    stats: Dict[str, Dict] = defaultdict(lambda: dict.fromkeys(
        ("n", "host_s", "self_host_s", "device_s", "self_device_s", "ops",
         "syncs"), 0))
    for s in spans:
        st = stats[s.name]
        st["n"] += 1
        st["host_s"] += (s.end - s.start) / 1e6
        st["self_host_s"] += (s.end - s.start) / 1e6
        if s.parent is not None:
            p = spans[s.parent]
            stats[p.name]["self_host_s"] -= (s.end - s.start) / 1e6
    for ts, dur, corr in device:
        t = launch.get(corr)
        if t is None:
            continue
        chain = around(innermost(t))
        if chain:
            stats[spans[chain[0]].name]["self_device_s"] += dur / 1e6
        for name in {spans[i].name for i in chain}:
            stats[name]["device_s"] += dur / 1e6
            stats[name]["ops"] += 1
    for t in calls:
        for name in {spans[i].name for i in around(innermost(t))}:
            stats[name]["syncs"] += 1

    idle: Dict[str, Dict] = defaultdict(lambda: {"s": 0.0, "n": 0})
    for began, secs in _gaps(device):
        chain = around(innermost(began))
        path = "/".join(spans[i].name for i in reversed(chain)) or "host"
        idle[path]["s"] += secs
        idle[path]["n"] += 1
    return {"spans": dict(stats), "idle_by_span": dict(idle),
            "n_device_ops": len(device)}


def _nest(raw) -> List[_Span]:
    """Spans sorted by start (the outer first on a tie), each with the
    index of the innermost span that holds it."""
    spans: List[_Span] = []
    stack: List[int] = []
    for start, neg_end, name in raw:
        end = -neg_end
        while stack and spans[stack[-1]].end < end:
            stack.pop()
        spans.append(_Span(start, end, name, stack[-1] if stack else None))
        stack.append(len(spans) - 1)
    return spans


def _gaps(device) -> List:
    """[(microsecond the gap began, its seconds)] of each hole in the
    union of the device operations' intervals."""
    iv = sorted((ts, ts + dur) for ts, dur, _ in device)
    gaps = []
    cur_e = None
    for s, e in iv:
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, (s - cur_e) / 1e6))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps



def _program(ctx: Dict):
    """(the program's reduced spans, the count of ``ydt.k1_step`` spans),
    or None outside a K=1 cell or without them."""
    prog = ctx["trace"].get("program") if ctx["kind"] == "k1" else None
    steps = prog and prog["spans"].get("ydt.k1_step", {}).get("n")
    return (prog, steps) if steps else None


def per_step(ctx: Dict, name: str, key: str) -> Optional[float]:
    """The slice's total of ``key`` over the program's ``name`` spans, a
    K=1 step, for the metric readers. None outside a K=1 cell, without the
    program's spans, and for a device number (``device_s``, ``ops``,
    ``syncs``) when the trace holds no device operation (a CPU run, where
    it would read 0)."""
    found = _program(ctx)
    if found is None:
        return None
    prog, steps = found
    st = prog["spans"].get(name)
    if st is None or (key != "host_s" and not prog["n_device_ops"]):
        return None
    return st[key] / steps


def starved_per_step(ctx: Dict) -> Optional[float]:
    """Idle device seconds a K=1 step whose gap began while the host was
    inside ``ydt.k1_step``: the device waiting on the step's own enqueue,
    not on the harness's read-out. None as for ``per_step``'s device
    numbers."""
    found = _program(ctx)
    if found is None or not found[0]["n_device_ops"]:
        return None
    prog, steps = found
    return sum(g["s"] for path, g in prog["idle_by_span"].items()
               if "ydt.k1_step" in path.split("/")) / steps


@contextlib.contextmanager
def program_reduced():
    """While active, ``trace.profiled`` also stores this module's reduction
    of the slice under ``program`` (so the stage metrics' readers find it
    in ``ctx["trace"]``); yields that dict, filled once a slice is
    reduced."""
    plain = trace.reduce_events
    got: Dict = {}

    def reduce(events):
        got["program"] = reduce_program(events)
        return dict(plain(events), program=got["program"])

    trace.reduce_events = reduce
    try:
        yield got
    finally:
        trace.reduce_events = plain


def main(argv=None) -> int:
    from . import run

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    run.set_environment()
    bench, cell, cfg, cfg_path, traffic, limits = run.cell_files(
        args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the stage spans are read on the card",
              file=sys.stderr)
        return 1
    from .cell import run_cell

    e2e, layer = run.cell_metrics(bench, args.workload)
    layer += [m for m in STAGE_METRICS if m not in layer]
    with program_reduced() as got:
        res = run_cell(cfg, cfg_path, traffic, limits, args.seed,
                       args.seconds, True, torch.device("cuda"), e2e, layer,
                       t_start=run.T_START, read_metric=run.read_metric)
    found = run.forbidden_modules()
    if found:
        print("loaded in this process: " + ", ".join(found), file=sys.stderr)
        return 3
    for line in res["detail"]:
        print(json.dumps(line))
    print(json.dumps({"program": got.get("program")}))
    print(json.dumps({"stages": {m: res["line"]["metrics"].get(m)
                                 for m in STAGE_METRICS}}))
    print(json.dumps(res["line"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
