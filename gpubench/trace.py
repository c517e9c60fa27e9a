"""The traced slice of a run: ``torch.profiler`` (CUPTI) over a few chunks
or steps, reduced to what the per-layer metrics and the breakdown read.

Spans are ``record_function`` ranges the harness puts around its calls
into the program (``detect``, ``readback``, ``track``, ``read_out``,
``k1_step``). A device operation (kernel, copy or fill) belongs to the
span whose host interval holds the runtime call that launched it, matched
by the profiler's correlation id; one whose launch is not in the trace is
counted as unattributed. Busy time is the union of the device
operations' intervals; an idle gap is a hole in that union, named by the
span the host was in when the gap began ("host" outside every span)."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

SPANS = ("detect", "readback", "track", "read_out", "k1_step")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 160


def span(name: str, on: bool):
    """A profiler range around a call into the program, when tracing."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiled(out: Dict):
    """Profile the block; afterwards ``out`` holds the reduced trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            yield
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out.update(reduce_events(events))


def reduce_events(events: List[Dict]) -> Dict:
    """Chrome-trace events -> per-span device seconds and counts, busy
    seconds, idle gaps, device seconds by operation name."""
    device, launch, spans = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((float(e["ts"]), float(e["dur"]), e["name"], corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launch[corr] = float(e["ts"])
        elif cat == "user_annotation" and e["name"] in SPANS:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          e["name"]))
    spans.sort()
    starts = [s[0] for s in spans]

    def span_at(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in (i, i - 1):  # the harness's spans do not nest
            if j >= 0 and spans[j][0] <= t <= spans[j][1]:
                return spans[j][2]
        return "host"

    span_us: Dict[str, float] = defaultdict(float)
    op_us: Dict[str, float] = defaultdict(float)
    unattributed = 0.0
    for ts, dur, name, corr in device:
        op_us[name[:NAME_CHARS]] += dur
        t = launch.get(corr)
        if t is None:
            unattributed += dur
        else:
            span_us[span_at(t)] += dur
    busy, gaps = _union(device, span_at)
    counts: Dict[str, int] = defaultdict(int)
    for _, _, name in spans:
        counts[name] += 1
    return {
        "span_s": {k: v / 1e6 for k, v in span_us.items()},
        "span_count": dict(counts),
        "busy_s": busy / 1e6,
        "unattributed_s": unattributed / 1e6,
        "device_ops": sorted(((k, v / 1e6) for k, v in op_us.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10],
        "n_device_ops": len(device),
    }


def _union(device, span_at) -> Tuple[float, List]:
    """Busy microseconds and [(span, seconds)] of each idle gap."""
    iv = sorted((ts, ts + dur) for ts, dur, _, _ in device)
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in iv:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append([span_at(cur_e), (s - cur_e) / 1e6])
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps
