"""Per-layer weight-compatibility harness (port of
``tools/verify_weights.py``).

Darknet layout, BN-folding and transposition bugs are silent accuracy
killers, so this loads a cfg (and optionally a real ``.weights`` file;
random weights otherwise), runs the same input through the port's
``Darknet`` and the pure-numpy oracle (``specs/model_np.py``) on the same
raw params, and reports the max abs / rel deviation per module: a layout
or fold bug shows up at the exact layer where it occurs.

    python3 -m yolo_deepsort_tpu_torch.tools.verify_weights
        --cfg config/yolov3.cfg [--weights weights/yolov3.weights]
        [--img-size 416] [--batch 1] [--device cuda|cpu]

Prints the reference's table, its worst layer and exit code: 1 when a
layer's max abs difference exceeds ``--threshold``. The forward is float32
with TF32 off. ``verify`` returns the rows of any compute dtype (the
bfloat16 module's forward runs kernel 7 on every conv on the card), which
``parity_real`` and ``chip_smoke.py`` read; the threshold gates float32
only. ``--device`` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import copy
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
THRESHOLD = 1e-2  # the reference tool's default --threshold


def load_raw(defs: Sequence[dict], weights: Optional[str], seed: int,
             log=print) -> Dict:
    """Raw darknet params: from ``weights`` (a cutoff file filled with
    seeded random params for the modules it lacks) or seeded random."""
    from ..models.darknet import conv_layer_shapes
    from ..weights import load_darknet_weights, random_raw_params

    if weights:
        _, raw = load_darknet_weights(weights, defs)
        missing = [i for i, *_ in conv_layer_shapes(defs) if i not in raw]
        if missing:
            log(f"note: cutoff load; random-init for modules {missing}")
            raw = {**random_raw_params(defs, seed=seed), **raw}
        return raw
    log("no --weights given: using random weights (layout check only)")
    return random_raw_params(defs, seed=seed)


def layer_rows(defs: Sequence[dict], oracle_layers, layers) -> List[dict]:
    """One row per module: its type, the oracle's shape, the max abs and
    max rel difference, and how many matched non-finite values (NaN and
    NaN, or infinities of one sign) were compared equal. ``layers`` are
    the port's (NHWC feature maps, decoded rows at yolo modules)."""
    rows = []
    for i, (mdef, o, j) in enumerate(zip(defs, oracle_layers, layers)):
        j = np.asarray(j)
        if mdef["type"] != "yolo" and j.ndim == 4:
            j = j.transpose(0, 3, 1, 2)  # NHWC -> the oracle's NCHW
        j64, o = j.astype(np.float64), np.asarray(o, np.float64)
        same_special = (np.isnan(j64) & np.isnan(o)) | (
            np.isinf(j64) & np.isinf(o) & (np.sign(j64) == np.sign(o)))
        d = np.where(same_special, 0.0, np.abs(j64 - o))
        rel = d / (np.abs(o) + 1e-6)
        rows.append({"idx": i, "type": mdef["type"], "shape": o.shape,
                     "max_abs": float(d.max()), "max_rel": float(rel.max()),
                     "n_special": int(same_special.sum())})
    return rows


def worst_of(rows: Sequence[dict]) -> Tuple[float, int]:
    """(max abs difference, module index) of the worst row; (0.0, -1) when
    every row is exact."""
    worst = (0.0, -1)
    for r in rows:
        if r["max_abs"] > worst[0]:
            worst = (r["max_abs"], r["idx"])
    return worst


def format_table(rows: Sequence[dict], threshold: float) -> List[str]:
    """The reference tool's table lines, flags included."""
    lines = [f"{'idx':>4} {'type':<14} {'shape':<22} {'max abs':>10} "
             f"{'max rel':>10}"]
    for r in rows:
        flag = " <-- DIVERGES" if r["max_abs"] > threshold else ""
        # matched non-finites compare equal but make the layer unverifiable
        # (both sides overflowing identically proves nothing) -- say so
        if r["n_special"]:
            flag += (f" [non-finite at layer {r['idx']}: {r['n_special']} "
                     "matched values compared equal -- unverifiable]")
        lines.append(f"{r['idx']:>4} {r['type']:<14} {str(r['shape']):<22} "
                     f"{r['max_abs']:>10.2e} {r['max_rel']:>10.2e}{flag}")
    return lines


def worst_line(rows: Sequence[dict]) -> str:
    value, idx = worst_of(rows)
    return f"worst layer: {idx} (max abs diff {value:.3e})"


def verify(cfg: str, weights: Optional[str] = None,
           img_size: Optional[int] = None, batch: int = 1, seed: int = 0,
           device=None, dtypes: Sequence[str] = ("f32",),
           log=print) -> Dict[str, List[dict]]:
    """The per-layer rows of the port's forward against the numpy oracle,
    one list per compute dtype in ``dtypes`` ("f32", "bf16"), on the same
    raw params and the same seeded input. The modules are the facade's:
    the folded float32 ``Darknet`` (channels_last on the card) and a
    bfloat16 copy of it (``api.Darknet.module_for``)."""
    from specs import model_np

    from ..api import _memory_format
    from ..cfg import parse_model_config
    from ..models.darknet import build_network
    from ..train.trees import full_f32
    from ..weights import darknet_from_raw

    dev = resolve_device(device)
    plan = build_network(parse_model_config(cfg), img_size=img_size)
    defs = plan.defs()
    raw = load_raw(defs, weights, seed, log)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (batch, 3, plan.img_size, plan.img_size))
    x = x.astype(np.float32)
    # the oracle sees float32 input like the port: random weights can
    # overflow the yolo exp() decode, and a float64-finite against
    # float32-inf would flag a fake divergence
    _, oracle_layers = model_np.forward(defs, raw, x, img_dim=plan.img_size)
    f32 = darknet_from_raw(plan, raw).to(dev, memory_format=_memory_format(dev))
    x_dev = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
    x_dev = x_dev.to(dev)
    out = {}
    for name in dtypes:
        dtype = DTYPES[name]
        module = f32 if dtype == torch.float32 else copy.deepcopy(f32).to(dtype)
        with torch.no_grad(), full_f32():
            _, layers = module(x_dev, capture_all_layers=True)
        layers = [t.float().cpu().numpy() for t in layers]
        out[name] = layer_rows(defs, oracle_layers, layers)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threshold", type=float, default=THRESHOLD,
                   help="flag layers whose max abs diff exceeds this")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    rows = verify(args.cfg, args.weights, args.img_size, args.batch,
                  args.seed, args.device)["f32"]
    print("\n".join(format_table(rows, args.threshold)))
    print("\n" + worst_line(rows))
    if worst_of(rows)[0] > args.threshold:
        return 1
    print("OK: all layers within tolerance")
    return 0


if __name__ == "__main__":
    sys.exit(main())
