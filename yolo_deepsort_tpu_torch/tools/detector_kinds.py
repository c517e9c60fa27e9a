"""The detector's device time split by module kind.

The K=1 step replays its detector from one CUDA graph, so a trace of the
step sees one launch and no module inside it. This tool runs the same
forward eagerly -- the named architecture at the given input size and
batch, BN-consistent weights seeded on noise frames of 1080p, bf16 (every
conv on kernel 7, as the serving steps run it) -- under the torch profiler,
and
gives each device operation to the innermost ``ydt.det.*`` range that
``Darknet.forward`` opens around the module which launched it (matched by
the profiler's correlation id). Per kind (``ydt.det.conv.mish`` /
``.leaky`` / ``.linear``, ``.maxpool``, ``.route``, ``.upsample``,
``.shortcut``, ``.yolo``, ``.block``) it prints the modules a forward, the
device ms and operations a forward, the conv GFLOP, the GB the modules
move, the roofline ms of the convs and the share of it that the device
time reaches.

    python -m yolo_deepsort_tpu_torch.tools.detector_kinds
        [--model yolov4] [--img-size 608] [--batch 8] [--forwards 5]
        [--device cuda]

One JSON line: ``kinds`` (by span name), ``total`` (every kind) and
``outside`` (device operations of the forwards that no module range
holds). The roofline of a conv at batch N is the larger of its operations,
2 N Ho Wo Co Ci k k, over the H100 SXM's dense bf16 peak and its bytes
(input, weights and output once, 2 bytes an element) over the HBM
bandwidth, as the benchmark counts it; the other modules have none (their
inputs were mostly just written and are read from L2, so bytes over the
HBM bandwidth bound nothing), only the bytes they move: inputs and output
once, 2 bytes an element, a head's decoded rows at 4, a route of one input
0 (a view). Without a card, e.g. ``--model yolov3-tiny --img-size 64
--batch 2 --device cpu``, the device columns read 0: nothing is launched
on a device.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

PREFIX = "ydt.det."
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM, dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# (ci, co, k, stride, hin, win, hout, wout) of a conv, one image
Conv = Tuple[int, int, int, int, int, int, int, int]


def module_shapes(defs: Sequence[Dict[str, str]], img_size: int,
                  in_channels: int = 3) -> List[Dict]:
    """Per module: its kind's span name, its inputs' (C, H, W) and its
    output's, and for a conv its ``Conv`` tuple (``conv``)."""
    from ..models.darknet import module_span

    outs: List[Tuple[int, int, int]] = []
    prev = (in_channels, img_size, img_size)
    rows = []
    for i, d in enumerate(defs):
        t = d["type"]
        ins = [prev]
        row: Dict = {"span": module_span(d)}
        c, h, w = prev
        if t == "convolutional":
            k, s = int(d["size"]), int(d.get("stride", 1))
            p = (k - 1) // 2 if int(d.get("pad", 0)) else 0
            ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            out = (int(d["filters"]), ho, wo)
            row["conv"] = (c, out[0], k, s, h, w, ho, wo)
        elif t == "maxpool":
            k, s = int(d["size"]), int(d["stride"])
            if k == 2 and s == 1:
                out = prev
            else:
                p = (k - 1) // 2
                out = (c, (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1)
        elif t == "upsample":
            s = int(d["stride"])
            out = (c, h * s, w * s)
        elif t == "route":
            ins = [outs[int(l) if int(l) >= 0 else i + int(l)]
                   for l in str(d["layers"]).split(",")]
            groups = int(d.get("groups", 1))
            out = (sum(x[0] for x in ins) // groups, ins[0][1], ins[0][2])
        elif t == "shortcut":
            frm = int(d["from"])
            ins = [prev, outs[frm if frm >= 0 else i + frm]]
            out = prev
        elif t == "yolo":
            out = prev
        else:
            raise ValueError(f"unknown module type {t!r}")
        row.update(ins=ins, out=out)
        rows.append(row)
        outs.append(out)
        prev = out
    return rows


def conv_ops(c: Conv, n: int = 1) -> float:
    ci, co, k, _, _, _, ho, wo = c
    return 2.0 * n * ho * wo * co * ci * k * k


def conv_bytes(c: Conv, n: int = 1) -> float:
    ci, co, k, _, hi, wi, ho, wo = c
    return 2.0 * (n * (hi * wi * ci + ho * wo * co) + k * k * ci * co)


def conv_roofline_s(c: Conv, n: int) -> float:
    """Least seconds the card could take for one conv at batch n."""
    return max(conv_ops(c, n) / PEAK_BF16_OPS_PER_S,
               conv_bytes(c, n) / HBM_BYTES_PER_S)


def module_bytes(row: Dict, n: int, defs_row: Dict) -> float:
    """Bytes one module moves at batch n."""
    if "conv" in row:
        return conv_bytes(row["conv"], n)
    elems = sum(int(np.prod(x)) for x in row["ins"])
    out = int(np.prod(row["out"]))
    if defs_row["type"] == "yolo":  # bf16 head in, float32 decoded rows out
        anchors = len(str(defs_row["mask"]).split(","))
        rows = anchors * row["out"][1] * row["out"][2]
        return n * (2.0 * elems + 4.0 * rows * (5 + int(defs_row["classes"])))
    if defs_row["type"] == "route" and len(row["ins"]) == 1:
        return 0.0  # a view of its input: no work
    return n * 2.0 * (elems + out)


def attribute(events: List[Dict]) -> Dict[str, Dict]:
    """Chrome-trace events -> {span name: {"n", "device_s", "ops"}} of every
    ``ydt.det.*`` range: ``n`` ranges, and the device operations whose
    launch lies innermost in one of them (by correlation id); key
    ``"outside"`` the operations launched outside every such range."""
    device, launch, raw = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((float(e["dur"]), corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launch[corr] = float(e["ts"])
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            ts = float(e["ts"])
            raw.append((ts, -(ts + float(e["dur"])), e["name"]))
    raw.sort()
    spans, parent, stack = [], [], []  # (start, end, name), holder's index
    for start, neg_end, name in raw:
        while stack and spans[stack[-1]][1] < -neg_end:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        spans.append((start, -neg_end, name))
        stack.append(len(spans) - 1)
    starts = [s[0] for s in spans]
    out: Dict[str, Dict] = defaultdict(
        lambda: {"n": 0, "device_s": 0.0, "ops": 0})
    for _, _, name in spans:
        out[name]["n"] += 1
    for dur, corr in device:
        t = launch.get(corr)
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        while i is not None and i >= 0 and spans[i][1] < t:
            i = parent[i]
        key = spans[i][2] if i is not None and i >= 0 else "outside"
        out[key]["device_s"] += dur / 1e6
        out[key]["ops"] += 1
    return dict(out)


def kind_table(defs: Sequence[Dict[str, str]], img_size: int, batch: int,
               found: Dict[str, Dict], forwards: int,
               in_channels: int = 3) -> Dict:
    """The printed table: per kind the modules, device ms, operations (a
    forward), conv GFLOP, GB moved, the convs' roofline ms and the share of
    it that the device time reaches (%; None without a roofline or without
    device time), from the attributed ranges of ``forwards`` forwards at
    ``batch``. A span that a block route claimed is counted under
    ``ydt.det.block``, its convs' work under their own kinds."""
    rows = module_shapes(defs, img_size, in_channels)
    work = defaultdict(lambda: {"gflop": 0.0, "gbytes": 0.0,
                                "roofline_ms": 0.0})
    for row, d in zip(rows, defs):
        w = work[row["span"]]
        w["gbytes"] += module_bytes(row, batch, d) / 1e9
        if "conv" in row:
            w["gflop"] += conv_ops(row["conv"], batch) / 1e9
            w["roofline_ms"] += conv_roofline_s(row["conv"], batch) * 1e3
    kinds = {}
    for name in sorted(set(found) - {"outside"} | set(work)):
        f = found.get(name, {"n": 0, "device_s": 0.0, "ops": 0})
        ms = f["device_s"] * 1e3 / forwards
        w = work.get(name, {"gflop": 0.0, "gbytes": 0.0, "roofline_ms": 0.0})
        kinds[name] = {"modules": f["n"] / forwards, "device_ms": ms,
                       "ops": f["ops"] / forwards, **w,
                       "roofline_share": _share(w["roofline_ms"], ms)}
    total = {key: sum(k[key] for k in kinds.values()) for key in (
        "modules", "device_ms", "ops", "gflop", "gbytes", "roofline_ms")}
    total["roofline_share"] = _share(total["roofline_ms"],
                                     total["device_ms"])
    outside = found.get("outside", {"device_s": 0.0, "ops": 0})
    return {"kinds": kinds, "total": total,
            "outside": {"device_ms": outside["device_s"] * 1e3 / forwards,
                        "ops": outside["ops"] / forwards}}


def _share(roofline_ms: float, device_ms: float):
    if roofline_ms and device_ms:
        return 100.0 * roofline_ms / device_ms
    return None


@torch.no_grad()
def profile_forwards(detector, xs: torch.Tensor, forwards: int) -> List:
    """Chrome-trace events of ``forwards`` eager forwards of ``detector``
    on ``xs`` (after two unrecorded ones that build and warm its
    kernels)."""
    from torch.profiler import ProfilerActivity, profile

    dev = xs.device
    for _ in range(2):
        detector(xs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            for _ in range(forwards):
                detector(xs)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def main(argv=None) -> int:
    from ..cfg.architectures import ARCHITECTURES
    from ..device import resolve_device
    from ..models.darknet import build_network
    from ..ops.letterbox import letterbox_batch
    from ..weights import darknet_from_raw
    from .honest_load import bn_consistent_raw

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="yolov4", choices=sorted(ARCHITECTURES))
    p.add_argument("--img-size", type=int, default=608)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--forwards", type=int, default=5)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    plan = build_network(ARCHITECTURES[args.model](img_size=args.img_size))
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (args.batch, 1080, 1920, 3), dtype=np.uint8)).to(dev)
    raw = bn_consistent_raw(plan, frames)
    detector = darknet_from_raw(plan, raw).to(
        dev, torch.bfloat16, memory_format=torch.channels_last)
    xs = letterbox_batch(frames, args.img_size).to(torch.bfloat16)
    del frames
    events = profile_forwards(detector, xs, args.forwards)
    table = kind_table(plan.defs(), args.img_size, args.batch,
                       attribute(events), args.forwards, plan.in_channels)
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    print(json.dumps({"model": args.model, "img_size": args.img_size,
                      "batch": args.batch, "device": card,
                      "forwards": args.forwards, **table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
