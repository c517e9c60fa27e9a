"""One run of one benchmark cell of ``yolo_deepsort_tpu_torch`` on the card.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Loads the cell's configuration (``configs/<config>.json``), traffic mix
(``traffic/<mix>.json``) and limits (``limits/<cell>.json``), named in
``BENCHMARK.json``; makes the inputs from the seed (``load.py``); builds
the program's serving step; warms up the cell's own shapes; measures for
``--seconds``; then checks sampled outputs against the plain reference
(``compare.py``). With ``--trace 1`` it also profiles a short slice and
reads the cell's per-layer metrics (``metrics/<metric>.py``).

The last line of standard output is the result, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` (traced runs) and ``checks`` (each number compared beside
its limit). Detail goes on earlier lines. Exits 1 without a CUDA card (or
fewer than the cell asks for), and 3 if JAX or the JAX package was loaded
or the reference imports the program."""

from __future__ import annotations

import argparse
import ast
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "yolo_deepsort_tpu")
PROGRAM = "yolo_deepsort_tpu_torch"


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str, bench_path: Path = ROOT / "BENCHMARK.json"):
    """-> (BENCHMARK.json, cell entry, configuration, cfg path, traffic,
    limits), every file found by the names in BENCHMARK.json."""
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT / conf["file"])
    return (bench, cell, cfg, str(HERE / "configs" / cfg["cfg"]),
            load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            load_json(HERE / "limits" / f"{workload}.json"))


def cell_metrics(bench, workload: str):
    """Names of the cell's end-to-end and per-layer metrics: those that
    list it, or list no cells and move a metric it reports."""
    def listed(m):
        return workload in m.get("workloads", [workload])

    e2e = [m["name"] for m in bench["end_to_end"] if listed(m)]
    layer = [m["name"] for m in bench["per_layer"]
             if listed(m) and m["moves"] in e2e]
    return e2e, layer


def read_metric(name: str, ctx: dict):
    """Run ``metrics/<name>.py``'s ``read(ctx)``; None: nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def reference_imports() -> list:
    """Top-level modules the reference's sources import that it must
    not: the program, JAX, the JAX package."""
    bad = []
    for path in sorted((HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN + (PROGRAM,)]
    return bad


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_environment() -> None:
    """Before torch and numpy load: every build and kernel cache of a run
    at a fixed path inside the checkout (the program's own kernel library
    builds into its package directory, keyed by its sources), and one
    thread for every CPU thread pool (the reference tracker's small solves
    run 25 times slower with a pool spinning over them, and the serving
    steps are bound by the one thread that launches their kernels: a pool
    spinning beside it takes cores from it)."""
    cache = HERE / ".cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    for var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    set_environment()
    bench, cell, cfg, cfg_path, traffic, limits = cell_files(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    bad = reference_imports()
    from . import compare  # the reference, before the program is loaded
    if PROGRAM in sys.modules:
        bad.append(f"loading the reference loaded {PROGRAM}")
    if bad:
        print("the reference imports what it must not: " + "; ".join(bad),
              file=sys.stderr)
        return 3
    del compare
    from .cell import run_cell

    e2e, layer = cell_metrics(bench, args.workload)
    res = run_cell(cfg, cfg_path, traffic, limits, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda"), e2e, layer,
                   t_start=T_START, read_metric=read_metric)
    found = forbidden_modules()
    if found:
        print("loaded in this process: " + ", ".join(found), file=sys.stderr)
        return 3
    for line in res["detail"]:
        print(json.dumps(line))
    for name, c in res["line"]["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res["line"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
