"""The readings that set a cell's limits: the numbers ``compare.py``
compares, from sound runs of the program on many seeds (the lower reading
of each number is the largest of them) and from its lower-precision
controls on a few (the upper reading is the smallest):

* "int8": the program with its own int8 paths switched on -- W8A8
  backbone convs through kernel 7's int8 mode and the int8-resident ReID
  embed through kernel 8 -- in place of the bfloat16 configuration (its
  ``det_layer_cos`` judged on its own capture);
* "detector_int8": the reference detector computed with W8A8 rounding on
  every conv, in the program's place (judged on each sound run's samples):
  the whole forward for ``det_cos``, and each conv on the program's own
  inputs of it for ``det_layer_cos``;
* "tracker_bf16": the reference tracker with its Kalman state rounded to
  bfloat16 after every operation, in the program's place, whose tracker
  keeps float32 (judged on each sound run's samples);
* "broadcast" (chunk cells, read for the record): the program with the
  first frame of every stream put in place of each frame of a chunk, the
  work of one frame copied to the others.

All seeds run in one process, each with the cell's own load and a short
window.

    python3 -m gpubench.control --workload <cell> --seeds 1 2 ...
        --control-seeds 101 102 103 [--fault-seeds 201] [--seconds 3]

One JSON line per run, then one with both readings of every number."""

from __future__ import annotations

import argparse
import json
import sys
import time

from .run import T_START, cell_files, cell_metrics, set_environment

CONTROLS = ("int8", "detector_int8", "tracker_bf16", "broadcast")


class Broadcast:
    """A chunk step whose detect stage gets the first frame of every
    stream in place of each of the chunk's frames (and so does the track
    stage, which crops from what the detect stage was given)."""

    def __init__(self, step):
        self._step = step

    def __getattr__(self, name):
        return getattr(self._step, name)

    def detect(self, frames):
        return self._step.detect(frames[:1].expand_as(frames).contiguous())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    set_environment()
    import torch

    from .cell import run_cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    bench, cell, cfg, cfg_path, traffic, limits = cell_files(args.workload)
    e2e, _ = cell_metrics(bench, args.workload)
    readings = {c: [] for c in ("stated",) + CONTROLS}
    runs = ([(s, "stated") for s in args.seeds]
            + [(s, "int8") for s in args.control_seeds]
            + [(s, "broadcast") for s in args.fault_seeds])
    for seed, kind in runs:
        res = run_cell(cfg, cfg_path, traffic, limits, seed, args.seconds,
                       False, torch.device("cuda"), e2e, [],
                       t_start=time.time(),
                       route="int8" if kind == "int8" else "stated",
                       fault=Broadcast if kind == "broadcast" else None,
                       controls=kind == "stated")
        readings[kind].append(res["numbers"])
        for c, numbers in res.get("controls", {}).items():
            readings[c].append(numbers)
        print(json.dumps({"seed": seed, "run": kind,
                          "numbers": res["numbers"],
                          "controls": res.get("controls"),
                          "samples": res["samples"],
                          "metrics": res["line"]["metrics"],
                          "detail": res["detail"][0]["window"],
                          "judge_s": res["detail"][1]["judge_s"],
                          "capture_peak_bytes":
                              res["detail"][1]["capture_peak_bytes"],
                          "layers": res["detail"][1]["layers"],
                          "error": res["detail"][1]["error"]}),
              flush=True)
        del res
        torch.cuda.empty_cache()
    names = sorted({k for r in readings["stated"] for k in r})
    print(json.dumps({"workload": args.workload, "since_start_s":
                      time.time() - T_START, "readings": {
        k: {"lower": max((r[k] for r in readings["stated"]), default=None),
            "upper": {c: min((r[k] for r in readings[c] if k in r),
                             default=None) for c in CONTROLS}}
        for k in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
