"""Where the training mesh's time goes on one card: the full-width train
steps (yolov3-416 at batch 8, the 512-d ReID net with a 751-class head at
batch 64) through ``mesh=None``, a mesh without a group and a one-rank
NCCL mesh (``parallel/mesh.py`` ``make_train_mesh``), each timed in
alternated blocks, then profiled. A fourth run, "NCCL unchecked", is the
NCCL step with its shard-size check (``collectives.check_equal_shards``:
one tiny all-reduce and a host read a step) skipped, to attribute that
read's cost; the steps themselves have no such mode.

  python -m yolo_deepsort_tpu_torch.tools.train_mesh_clocks [--blocks 2]
      [--steps 5] [--out train_mesh_clocks.json]

Needs the card (NCCL); cuDNN runs deterministic, as in ``chip_smoke.py``
``run_parallel_training``. Per net and mesh: ms per step by CUDA events
(the median of every timed step) and by the host clock around a
synchronized block; under ``torch.profiler`` (2 steps): device busy ms a
step (the union of kernel intervals), the NCCL kernels' count and device
ms, the count of the step's collectives and the host ms spent in them
(the ``c10d::`` ops). One JSON line, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import socket
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import make_train_mesh
from ..train.trees import shard_train_tree, to_torch

MESHES = ("none", "no group", "NCCL", "NCCL unchecked")


def _unchecked(once):
    """``once`` with the steps' shard-size check skipped while it runs."""
    from ..train import reid_train, yolo_cli

    def run():
        saved = reid_train.check_equal_shards, yolo_cli.check_equal_shards
        reid_train.check_equal_shards = yolo_cli.check_equal_shards = (
            lambda *args: None)
        try:
            return once()
        finally:
            reid_train.check_equal_shards, yolo_cli.check_equal_shards = saved
    return run


def _yolo(dev):
    """-> start(mesh) for yolov3-416 at batch 8 (the smoke's load)."""
    from ..cfg.architectures import ARCHITECTURES
    from ..models.darknet import build_network
    from ..train import yolo_cli as TC
    from ..weights import random_raw_params

    rng = np.random.default_rng(3)
    defs = ARCHITECTURES["yolov3"](img_size=416)
    plan = build_network(defs)
    p0, s0 = TC.raw_params_to_train(random_raw_params(plan.defs()),
                                    plan.defs())
    imgs = torch.from_numpy(rng.uniform(0, 1, (8, 416, 416, 3)).astype(
        np.float32)).to(dev)
    t = np.zeros((64, 6), np.float32)
    t[:32, 0] = np.arange(32) // 4
    t[:32, 1] = rng.integers(0, 80, 32)
    t[:32, 2:4] = rng.uniform(0.2, 0.8, (32, 2))
    t[:32, 4:6] = rng.uniform(0.05, 0.4, (32, 2))
    t = torch.from_numpy(t).to(dev)
    mask = (torch.arange(64) < 32).to(dev)

    def start(mesh):
        params = (to_torch(p0, dev, True) if mesh is None
                  else shard_train_tree(p0, mesh, trainable=True))
        stats = [to_torch(s0, dev) if mesh is None
                 else shard_train_tree(s0, mesh)]
        opt = TC.build_optimizer(dict(defs[0], burn_in="0"), params)
        step = TC.make_detection_train_step(plan, mesh=mesh)

        def once():
            stats[0], loss, _ = step(params, opt, stats[0], imgs, t, mask)
            return loss
        return once
    return start


def _reid(dev):
    """-> start(mesh) for the 512-d ReID net, 751 classes, batch 64."""
    from ..train import reid_train as RT

    rng = np.random.default_rng(4)
    p0, s0 = RT.init_train_params(num_classes=751)
    x = torch.from_numpy(rng.normal(0, 1, (64, 128, 64, 3)).astype(
        np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 751, 64)).to(dev)

    def start(mesh):
        params = (to_torch(p0, dev, True) if mesh is None
                  else shard_train_tree(p0, mesh, trainable=True))
        stats = [to_torch(s0, dev) if mesh is None
                 else shard_train_tree(s0, mesh)]
        init, step = RT.make_train_step(mesh=mesh)
        opt = init(params)

        def once():
            stats[0], loss, _ = step(params, opt, stats[0], x, labels)
            return loss
        return once
    return start


def _block(once, steps):
    """-> (CUDA-event ms of each step, host ms per step of the block)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        once()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / steps
    return [a.elapsed_time(b) for a, b in events], host


def _busy_ms(intervals):
    """The union of (start, end) intervals, in ms (profiler us)."""
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def _profile(once, steps=2):
    """Device busy ms, NCCL kernels and device ms, the collectives' count
    and host ms, each per step, over ``steps`` profiled steps."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            once()
        torch.cuda.synchronize()
    kernels, nccl, comm_us, comm_n = [], [], 0.0, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            span = (ev.time_range.start, ev.time_range.end)
            kernels.append(span)
            if "nccl" in ev.name.lower():
                nccl.append(span)
        elif ev.name.startswith("c10d::"):
            comm_us += ev.cpu_time_total
            comm_n += 1
    return {"device_busy_ms": _busy_ms(kernels) / steps,
            "nccl_kernels": len(nccl) / steps,
            "nccl_device_ms": _busy_ms(nccl) / steps,
            "host_collectives": comm_n / steps,
            "host_collectives_ms": comm_us / 1e3 / steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("train_mesh_clocks needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.deterministic = True
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", store=dist.TCPStore(
        "127.0.0.1", port, 1, True), world_size=1, rank=0, device_id=dev)
    rec = {"card": card, "steps": args.steps, "blocks": args.blocks}
    try:
        nccl = make_train_mesh(device=dev)
        meshes = {"none": None, "no group": make_train_mesh(1, 1, device=dev),
                  "NCCL": nccl, "NCCL unchecked": nccl}
        # alternated: the four in order, then in reverse, ...
        order = [m for b in range(args.blocks)
                 for m in (MESHES if b % 2 == 0 else MESHES[::-1])]
        for net, setup in (("yolov3-416", _yolo), ("ReID 512-d", _reid)):
            start = setup(dev)
            steps = {name: start(meshes[name]) for name in MESHES}
            steps["NCCL unchecked"] = _unchecked(steps["NCCL unchecked"])
            for once in steps.values():
                once()  # cuDNN's first-call set-up
            ms = {name: [] for name in MESHES}
            host = {name: [] for name in MESHES}
            for name in order:
                dev_ms, host_ms = _block(steps[name], args.steps)
                ms[name] += dev_ms
                host[name].append(host_ms)
            rec[net] = {name: {"ms_median": statistics.median(ms[name]),
                               "ms": ms[name], "host_ms_blocks": host[name],
                               **_profile(steps[name])}
                        for name in MESHES}
            del steps, start
    finally:
        dist.destroy_process_group()
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
