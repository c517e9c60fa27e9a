"""Where a block of the crop kernels spends its time: clock64 stamps.

    python3 yolo_deepsort_tpu_torch/tools/crops_phases.py [--strip-rows N]
                                                          [--out phases.json]

Builds ``csrc/crops.cu`` with ``CROPS_STAMPS`` defined (``build.
load_variants``), so that thread 0 of every block of the staged main loop
(``csrc/crops_stage.cuh``) records the SM clock at each phase boundary;
runs the three entries (kernel 2, kernel 6, the dense crops) on
``chip_smoke.py``'s ``crops_case`` (8 x 40 boxes, window (320, 192), seeded
0) and prints, per entry, the mean cycles of a block's phases: the taps (to
the first barrier), the row list and the per-thread set-up (to the second
barrier), the first copies, then per sub-strip the wait for its rows and
the values computed and stored, and the blocks an SM ran at once on
average (the sum of the blocks' lives over the span the SM was busy). The
stamps cost a few cycles each; read the phases' shares, not the kernel's
time. Needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]

SLOTS = 38  # stamps per block: kStampSlots, 6 fixed and 2 per sub-strip


def phases(st: np.ndarray, nsub: int) -> dict:
    """Mean cycles per block of each phase, from the (blocks, SLOTS)
    stamps."""
    t0 = st[:, 0]
    ready = st[:, 6:6 + 2 * nsub:2]
    done = st[:, 7:7 + 2 * nsub:2]
    before = np.concatenate([st[:, 3:4], done[:, :-1]], 1)
    sm = st[:, 5].astype(int)
    lives = st[:, 4] - t0
    busy = [st[sm == k, 4].max() - st[sm == k, 0].min() for k in np.unique(sm)]
    return {
        "life": float(lives.mean()),
        "taps": float((st[:, 1] - t0).mean()),
        "row_list_and_setup": float((st[:, 2] - st[:, 1]).mean()),
        "first_copies": float((st[:, 3] - st[:, 2]).mean()),
        "wait_first_substrip": float((ready[:, 0] - before[:, 0]).mean()),
        "wait_per_substrip": float((ready - before).mean()),
        "compute_per_substrip": float((done - ready).mean()),
        "substrips": nsub,
        "blocks_at_once_per_sm": float(lives.sum() / np.sum(busy)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--strip-rows", type=int, default=None,
                    help="one strip height for all three entries (default: "
                         "each entry's own)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import ctypes

    import torch

    from yolo_deepsort_tpu_torch.kernels import build
    from yolo_deepsort_tpu_torch.ops import crops_kernel as CK

    if not torch.cuda.is_available():
        raise SystemExit("crops_phases: needs the card")
    spec = importlib.util.spec_from_file_location("_ydt_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    frames, boxes = smoke.crops_case(np.random.default_rng(0), dev)
    b, d = boxes.shape[:2]
    win = smoke.K1_WINDOW
    defines = {"CROPS_STAMPS": 1}
    if args.strip_rows:
        defines.update(CK.strip_defines(args.strip_rows))
    (lib,) = build.load_variants("crops", [defines])
    lib.ydt_crops_stamps.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.ydt_crops_stamps.restype = ctypes.c_int
    record = {"card": smoke.card_line()}
    for name, entry, launch in (
            ("ydt_crops", "planar",
             lambda: CK.crops_cuda(frames, boxes, *win, lib=lib)),
            ("ydt_crops_interleaved", "interleaved",
             lambda: CK.crops_cuda(frames, boxes, *win, interleaved=True,
                                   lib=lib)),
            ("ydt_crops_dense", "dense",
             lambda: CK.crops_dense_cuda(frames, boxes, lib=lib))):
        rows = args.strip_rows or CK.STRIP_ROWS[entry]
        n_blocks = b * d * (128 // rows)
        for _ in range(3):  # the last launch's stamps are read
            launch()
        torch.cuda.synchronize()
        buf = torch.zeros(n_blocks * SLOTS, dtype=torch.int64, device=dev)
        if lib.ydt_crops_stamps(buf.data_ptr(), n_blocks * SLOTS) != 0:
            raise RuntimeError("crops_phases: stamps not read")
        st = buf.view(n_blocks, SLOTS).cpu().numpy().astype(np.float64)
        record[name] = dict(phases(st, rows // 8), strip_rows=rows)
        print(f"{name} (strip {rows}, {n_blocks} blocks): " + ", ".join(
            f"{k} {v:.0f}" if k != "blocks_at_once_per_sm" else
            f"{k} {v:.2f}" for k, v in record[name].items()), flush=True)
    print(record["card"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
