"""Sweep the tile plans of the two implicit-GEMM conv kernels on this card.

    python3 -m yolo_deepsort_tpu_torch.tools.conv_plan_sweep \\
        --out sweep.json --table yolo_deepsort_tpu_torch/ops/conv_plan_table.py

For every conv shape class the serving paths route -- kernel 7 at the
eligible shapes of yolov3-416 at batch 8 (bf16 mode and int8 mode with bf16
activations), kernel 8 at the nine classes of one int8-resident ReID embed of
320 and of 512 crops -- and for kernel 10, the int8 probe's product at its
default shape (a 1x1 conv of the same main loop, bf16 and int8, the tiles it
instantiates), it times every plan the kernels take (each tile, each
split of the depth that divides the steps, the ring as deep as the planner
makes it) as device time -- the launches replayed from a CUDA graph between
two events -- and prints, per class, the planner's choice (``ops/conv_plan.py``
``plan_conv_tiles``) beside the fastest plan found, the fastest plan without
a split, and one JSON record with every time. ``--table`` writes the fastest
tile and split of every class as the module the planner reads
(``ops/conv_plan_table.py``); it holds for the card it was timed on. Needs
the card; the kernels have no CPU mode.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..ops import conv_int8_kernel, conv_kernel
from ..ops import conv_plan as CP

# (map, Ci, Co, k, stride): the eligible conv shapes of yolov3-416
BACKBONE_CLASSES = (
    (52, 256, 128, 1, 1), (52, 128, 256, 3, 1), (52, 256, 512, 3, 2),
    (26, 512, 256, 1, 1), (26, 256, 512, 3, 1), (26, 512, 1024, 3, 2),
    (13, 1024, 512, 1, 1), (13, 512, 1024, 3, 1), (13, 1024, 255, 1, 1),
    (13, 512, 256, 1, 1), (26, 768, 256, 1, 1), (26, 512, 255, 1, 1),
    (26, 256, 128, 1, 1), (52, 384, 128, 1, 1), (52, 256, 255, 1, 1),
)
# (k, stride, h, w, Ci, Co): the int8-resident ReID embed's conv classes
REID_CLASSES = (
    (3, 2, 64, 32, 64, 128), (1, 2, 64, 32, 64, 128),
    (3, 1, 32, 16, 128, 128), (3, 2, 32, 16, 128, 256),
    (1, 2, 32, 16, 128, 256), (3, 1, 16, 8, 256, 256),
    (3, 2, 16, 8, 256, 512), (1, 2, 16, 8, 256, 512),
    (3, 1, 8, 4, 512, 512),
)


def _ms(fn, reps: int) -> float:
    """Device time per call with the host out of the way: ``reps`` launches
    captured into one CUDA graph, the graph replayed between two events (a
    wrapper call costs the host more than a small conv costs the card)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ms_eager(fn, reps: int) -> float:
    """Time per call as a serving path pays it: wrapper and launch from
    Python, back to back, between two events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# (m, k, n): kernel 10's (m, k) x (k, n) at the int8 probe's default shape
PROBE_CLASSES = ((32768, 256, 256),)


def candidate_plans(depth: int, elem_bytes: int):
    """Every tile and split, with the ring the planner gives them."""
    steps = CP.depth_steps(depth, elem_bytes)
    for bm, bn in CP.TILES:
        for split in CP.SPLITS:
            if steps % split:
                continue
            st = CP.max_stages(bm, bn, CP.blocks_per_sm(bm, bn))
            yield CP.ConvPlan(bm, bn, max(2, min(st, steps // split)), split)


def table_source(device_name: str, reps: int, records) -> str:
    """The text of ``ops/conv_plan_table.py``: each class's fastest tile and
    split among the plans timed."""
    lines = [
        '"""Tile plans of the conv kernels at the served shape classes, timed',
        "on the card: written by ``tools/conv_plan_sweep.py --table``, not by",
        "hand.",
        "",
        f"Timed on: {device_name} (132 SMs), device time of {reps} launches",
        "replayed from a CUDA graph. ``ops/conv_plan.py`` ``plan_conv_tiles``",
        "takes an entry only on a card of as many SMs.",
        '"""',
        "",
        "# (m, co, depth, elem_bytes, quantizing) -> (bm, bn, split)",
        "TUNED_132_SMS = {",
    ]
    # classes of one matrix shape (a stride-2 conv and a stride-1 conv on the
    # next map) share an entry: the plan with the least time over all of them
    groups = {}
    for r in records:
        key = (r["m"], r["co"], r["depth"], r["elem_bytes"], r["quantizing"])
        groups.setdefault(key, []).append(r)
    for key, group in groups.items():
        total = {}
        for r in group:
            for p in r["plans"]:
                bm, bn, _, split = p["plan"]
                total[bm, bn, split] = total.get((bm, bn, split), 0) + p["ms"]
        full = [t for t, ms in total.items() if all(
            any(tuple(p["plan"][:2] + p["plan"][3:]) == t
                for p in r["plans"]) for r in group)]
        bm, bn, split = min(full, key=total.get)
        lines += [f"    # {r['class']}" for r in group]
        lines.append(f"    {key}: ({bm}, {bn}, {split}),")
    return "\n".join(lines + ["}", ""])


def sweep_one(name, launch, device, m, co, depth, elem_bytes, reps,
              quantizing=False, only="", tiles=CP.TILES):
    """Time ``launch(plan)`` under every candidate plan of the ``tiles``
    the kernel takes; None for a class that ``only`` leaves out."""
    if only not in name:
        return None
    chosen = CP.plan_for(device, m, co, depth, elem_bytes, quantizing)
    times = {}
    for plan in candidate_plans(depth, elem_bytes):
        if ((plan.bn > 64 and plan.bn // 2 >= co) or plan in times
                or (plan.bm, plan.bn) not in tiles):
            continue
        times[plan] = _ms(lambda: launch(plan), reps)
    chosen_ms = _ms(lambda: launch(chosen), reps)
    eager_ms = _ms_eager(lambda: launch(chosen), reps)
    best = min(times, key=times.get)
    unsplit = min((p for p in times if p.split == 1), key=times.get)
    rec = {
        "class": name, "m": m, "co": co, "depth": depth,
        "elem_bytes": elem_bytes, "quantizing": quantizing,
        "chosen": list(chosen), "chosen_ms": chosen_ms,
        "chosen_eager_ms": eager_ms, "best": list(best),
        "best_ms": times[best], "chosen_over_best": chosen_ms / times[best],
        "best_unsplit": list(unsplit), "best_unsplit_ms": times[unsplit],
        "plans": [{"plan": list(p), "ms": t} for p, t in times.items()],
    }
    print(f"{name}: planner {tuple(chosen)} {chosen_ms:.4f} ms ({eager_ms:.4f} "
          f"called from Python); best {tuple(best)} {times[best]:.4f} ms "
          f"(x{rec['chosen_over_best']:.2f}); best without a split "
          f"{tuple(unsplit)} {times[unsplit]:.4f} ms", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--crops", type=int, nargs="*", default=[320, 512])
    ap.add_argument("--only", default="",
                    help="sweep only the classes whose name contains this")
    ap.add_argument("--out", default=None, help="write the JSON record here")
    ap.add_argument("--table", default=None,
                    help="write the planner's table module here")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    rng = np.random.default_rng(0)
    records = []
    n = args.batch
    for hi, ci, co, k, stride in BACKBONE_CLASSES:
        x = torch.from_numpy(rng.standard_normal(
            (n, hi, hi, ci), np.float32)).to(device, torch.bfloat16)
        w = torch.from_numpy(rng.standard_normal(
            (k, k, ci, co), np.float32) / np.sqrt(k * k * ci)).to(device)
        wq = CP.pack_conv_weights((w * 100).clamp(-127, 127).to(torch.int8))
        wp = CP.pack_conv_weights(w.to(torch.bfloat16))
        b = torch.zeros((co,), device=device)
        scale = torch.full((co,), 1e-3, device=device)
        kw = dict(stride=stride, pad=(k - 1) // 2, act="leaky")
        m = n * (hi // stride) ** 2
        name = f"k7 {k}x{k} s{stride} {hi} {ci}->{co} N={n}"
        records.append(sweep_one(
            name + " bf16",
            lambda plan: conv_kernel.conv_bf16_cuda(x, wp, b, plan=plan,
                                                    **kw),
            device, m, co, k * k * ci, 2, args.reps, only=args.only))
        records.append(sweep_one(
            name + " int8",
            lambda plan: conv_kernel.conv_int8_cuda(x, wq, b, scale, 30.0,
                                                    plan=plan, **kw),
            device, m, co, k * k * ci, 1, args.reps, quantizing=True,
            only=args.only))
    for crops in args.crops:
        for k, stride, h, w_, ci, co in REID_CLASSES:
            xq = torch.from_numpy(rng.integers(
                -127, 128, (crops, h, w_, ci)).astype(np.int8)).to(device)
            wq = CP.pack_conv_weights(torch.from_numpy(rng.integers(
                -127, 128, (k, k, ci, co)).astype(np.int8)).to(device))
            scale = torch.full((co,), 1e-4, device=device)
            b = torch.zeros((co,), device=device)
            kw = dict(stride=stride, pad=(k - 1) // 2)
            m = crops * (h // stride) * (w_ // stride)
            records.append(sweep_one(
                f"k8 {k}x{k} s{stride} {h}x{w_} {ci}->{co} N={crops}",
                lambda plan: conv_int8_kernel.conv_int8_cuda(
                    xq, wq, scale, b, 20.0, plan=plan, **kw),
                device, m, co, k * k * ci, 1, args.reps, only=args.only))
    from . import int8_probe  # it imports this module's timing helper

    for m, k, co in PROBE_CLASSES:
        xb, wb, xi, wi = int8_probe.probe_operands(m, k, co, device)
        for mode, x, w, es in (("bf16", xb, wb, 2), ("int8", xi, wi, 1)):
            wp = int8_probe.pack_probe_weight(w)
            records.append(sweep_one(
                f"k10 probe {m}x{k}x{co} {mode}",
                lambda plan: int8_probe.matmul_probe_cuda(x, wp, plan=plan),
                device, m, co, k, es, args.reps, only=args.only,
                tiles=int8_probe.PROBE_TILES))
    out = {"device": torch.cuda.get_device_name(device), "reps": args.reps,
           "classes": [r for r in records if r is not None]}
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    if args.table:
        if torch.cuda.get_device_properties(
                device).multi_processor_count != CP.H100_SM_COUNT:
            raise SystemExit("--table: the planner's table is for a card "
                             f"of {CP.H100_SM_COUNT} SMs")
        with open(args.table, "w") as f:
            f.write(table_source(out["device"], args.reps, out["classes"]))
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
