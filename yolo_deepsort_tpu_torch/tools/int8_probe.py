"""Capability probe: is an int8 matrix product faster than the bf16 one on
this card? (Port of ``tools/int8_probe.py``.)

    python3 -m yolo_deepsort_tpu_torch.tools.int8_probe --m 32768 --k 256 --n 256

Times four variants of the (M, K) x (K, N) product the reference probes --
the ReID embed's implicit GEMM at the serving batch, one 3x3 tap -- and
prints one JSON record:

  library_bf16  ``torch.matmul`` on bf16 operands (f32 sums, bf16 out)
  library_int8  ``torch._int_mm`` (int32 out), where this PyTorch has it;
                else null with the reason
  kernel_bf16   kernel 10 (CUDA ``csrc/matmul_probe.cu``), bf16 -> f32 sums
                -> bf16
  kernel_int8   kernel 10, int8 -> int32 sums -> clip(acc // (8 K), +-127)
                -> int8, the reference's renormalisation (floor division)

with ``int8_speedup_vs_bf16`` = library_bf16 ms over the faster int8
variant's ms, as the reference computes it. Times are CUDA-event means over
repeated launches on two clocks: ``*_ms`` the calls made from Python back to
back, ``*_device_ms`` (kernel and library) the same calls captured into one
CUDA graph and replayed, the card's time with the host out of the way.

Kernel 10 replaces the TPU kernel ``pl_kernel`` of the reference tool. It is
a 1x1 conv of the main loop the conv kernels share (``csrc/conv_mainloop.cuh``)
with the probe's epilogue; that loop reads its weights K-major, so the tool
packs its fixed (K, N) weight ONCE, before anything is timed, to (N, ldw)
rows (``pack_probe_weight``, ``ops/conv_plan.py`` ``pack_conv_weights`` on
the (1, 1, K, N) HWIO view) -- the TPU kernel, too, holds ``w`` resident
across its 50 chained calls. ``torch.matmul``, ``torch._int_mm`` and the
plain version take (K, N) as it is. ``matmul_probe_plain`` is the plain
PyTorch version (f32 sums for bf16; the int8 product in float64, exact,
then floor division), to which the kernel is held before it is timed: int8
exactly equal, bf16 within 1 bf16 ulp (f32 sums of K products in another
order). ``matmul_probe`` takes the weight raw (packed per call) or packed;
it takes the plain version for CPU tensors only, and a CUDA tensor launches
the kernel or raises. The tile plan is the conv planner's for a 1x1 conv of
M pixels, N output channels and depth K (``ops/conv_plan.py``
``plan_conv_tiles``); ``tools/conv_plan_sweep.py`` times every plan the
kernel takes at the default shape (its ``k10`` classes).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import build
from ..ops import conv_plan as CP
from .conv_plan_sweep import _ms as graph_ms

launches = 0  # kernel launches; only the launch below adds to it

# The tiles csrc/matmul_probe.cu instantiates: those the planner's rule gives
# (no probe shape is in its table, and the rule never gives 128 x 256).
PROBE_TILES = ((64, 64), (64, 128), (128, 128))


def pack_probe_weight(w: torch.Tensor) -> CP.PackedWeights:
    """(K, N) weights as kernel 10 reads them: (N, ldw) K-major rows, the
    pack of the (1, 1, K, N) HWIO view. Plain torch; run it once per
    weight."""
    if w.dim() != 2:
        raise ValueError(f"matmul probe: expected (K, N) weights, got "
                         f"{tuple(w.shape)}")
    return CP.pack_conv_weights(w[None, None])


def _kn(w):
    """(K, N, dtype) of raw or packed weights."""
    if isinstance(w, CP.PackedWeights):
        return w.ci, w.co, w.data.dtype
    if w.dim() != 2:
        raise ValueError(f"matmul probe: expected (K, N) weights, got "
                         f"{tuple(w.shape)}")
    return int(w.shape[0]), int(w.shape[1]), w.dtype


def _check(x, w):
    k, _, wdt = _kn(w)
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"matmul probe: expected (M, K) x (K, N), got "
                         f"{tuple(x.shape)} and {k} rows of weights")
    if x.dtype != wdt or x.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"matmul probe: expected bfloat16 or int8 operands "
                         f"of one dtype, got {x.dtype} and {wdt}")


def matmul_probe_plain(x: torch.Tensor, w) -> torch.Tensor:
    """Plain version: bf16 operands -> exact products, f32 sums -> bf16;
    int8 operands -> the product in float64 (exact), floor division by 8 K,
    clip to +-127 -> int8. ``w`` raw (K, N) or packed."""
    _check(x, w)
    if isinstance(w, CP.PackedWeights):
        w = CP.unpack_conv_weights(w)[0, 0]
    if x.dtype == torch.bfloat16:
        return (x.float() @ w.float()).to(torch.bfloat16)
    acc = (x.double() @ w.double()).to(torch.int64)
    q = torch.div(acc, 8 * x.shape[1], rounding_mode="floor")
    return q.clamp(-127, 127).to(torch.int8)


def matmul_probe_cuda(x: torch.Tensor, w,
                      plan: "CP.ConvPlan | None" = None) -> torch.Tensor:
    """Launch kernel 10 on CUDA operands: ``x`` (M, K) contiguous, ``w`` the
    packed weights (``pack_probe_weight``) or raw (K, N), packed here, per
    call. K and N must be multiples of 16, M * K below 2^31 and K below
    131000 (the int8 sums' floor division); ``plan`` forces a tile plan (one
    of ``PROBE_TILES``) in place of the planner's, as the conv kernels'
    wrappers take one (the plan sweep). Anything else raises."""
    _check(x, w)
    build.require_cuda("matmul probe", x)
    build.require_cuda("matmul probe", CP.weight_tensor(w), contiguous=False)
    lib = build.load()  # raises before anything asks the card
    p = w if isinstance(w, CP.PackedWeights) else pack_probe_weight(w)
    m, k = (int(v) for v in x.shape)
    n = p.co
    if k % 16 or n % 16 or m * k >= 2 ** 31 or 16392 * k >= 2 ** 31:
        raise ValueError(f"matmul probe kernel: K and N must be multiples "
                         f"of 16, M * K below 2^31 and K below 131000, got "
                         f"M={m}, K={k}, N={n}")
    if not p.data.is_contiguous():
        raise ValueError("matmul probe kernel: expected contiguous packed "
                         "weights")
    es = x.element_size()
    plan = CP.check_plan(plan or CP.plan_for(x.device, m, n, k, es), k, es)
    if (plan.bm, plan.bn) not in PROBE_TILES:
        raise ValueError(f"matmul probe kernel: tile {plan.bm} x {plan.bn} "
                         f"is not one of {PROBE_TILES}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = lib.ydt_matmul_probe(
        x.data_ptr(), p.data.data_ptr(), out.data_ptr(), m, k, n,
        p.data.shape[1], int(x.dtype == torch.int8), plan.bm, plan.bn,
        plan.stages, plan.split,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("matmul probe", err)
    global launches
    launches += 1
    return out


def matmul_probe(x: torch.Tensor, w) -> torch.Tensor:
    """The probe's product: the kernel for CUDA tensors, the plain version
    for CPU tensors. ``w`` raw (K, N) or packed."""
    if x.device.type == "cpu":
        return matmul_probe_plain(x, w)
    return matmul_probe_cuda(x, w)


def probe_operands(m: int, k: int, n: int, device, seed: int = 0):
    """The reference tool's operands: N(0, 1) as bf16 and uniform int8
    codes in [-127, 127], from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    xb = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
    wb = torch.from_numpy(rng.normal(0, 1, (k, n)).astype(np.float32))
    xi = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    wi = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    return (xb.to(device, torch.bfloat16), wb.to(device, torch.bfloat16),
            xi.to(device), wi.to(device))


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in bf16 ulps of |want| (floor 2^-6), in f32."""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp(min=2.0 ** -6))) - 7)
    return float(((got - want).abs() / ulp).max())


def _event_ms(fn, reps: int) -> float:
    """Time per call, the calls made from Python back to back."""
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


def run_probe(m: int = 32768, k: int = 256, n: int = 256, device=None,
              reps: int = 50) -> dict:
    """Hold kernel 10 to its plain version at (m, k) x (k, n), then time the
    four variants; returns the probe's record (see the module docstring),
    with the errors and the plain version's times beside it. Raises when
    the kernel disagrees; needs a CUDA device."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the int8 probe times the card: it needs a CUDA "
                           "device")
    xb, wb, xi, wi = probe_operands(m, k, n, device)
    # the fixed weights packed once, outside every timed loop
    wbp, wip = pack_probe_weight(wb), pack_probe_weight(wi)
    got_b, want_b = matmul_probe(xb, wbp), matmul_probe_plain(xb, wb)
    got_i, want_i = matmul_probe(xi, wip), matmul_probe_plain(xi, wi)
    torch.cuda.synchronize()
    ulps = bf16_ulps(got_b, want_b)
    if not ulps <= 1:
        raise AssertionError(f"matmul probe kernel, bf16: {ulps} bf16 ulps "
                             "from its plain version")
    if not torch.equal(got_i, want_i) or int(want_i.abs().max()) == 0:
        raise AssertionError("matmul probe kernel, int8: differs from its "
                             "plain version")
    ops = 2.0 * m * k * n
    rec = {"probe": "int8-matmul", "m": m, "k": k, "n": n,
           "device": torch.cuda.get_device_name(device)}

    def timed(name, fn):
        ms = _event_ms(fn, reps)
        rec[name + "_ms"] = ms
        rec[name + "_tops"] = ops / (ms / 1e3) / 1e12
        rec[name + "_device_ms"] = graph_ms(fn, reps)

    timed("library_bf16", lambda: torch.matmul(xb, wb))
    if hasattr(torch, "_int_mm"):
        try:
            timed("library_int8", lambda: torch._int_mm(xi, wi))
        except RuntimeError as e:  # shapes this PyTorch's _int_mm refuses
            rec["library_int8_ms"] = rec["library_int8_device_ms"] = None
            rec["library_int8_err"] = str(e).splitlines()[0][:160]
    else:
        rec["library_int8_ms"] = rec["library_int8_device_ms"] = None
        rec["library_int8_err"] = "this PyTorch has no torch._int_mm"
    timed("kernel_bf16", lambda: matmul_probe(xb, wbp))
    timed("kernel_int8", lambda: matmul_probe(xi, wip))
    rec["plan_bf16"] = list(CP.plan_for(device, m, n, k, 2))
    rec["plan_int8"] = list(CP.plan_for(device, m, n, k, 1))
    rec["int8_speedup_vs_bf16"] = rec["library_bf16_ms"] / min(
        v for v in (rec["kernel_int8_ms"], rec["library_int8_ms"]) if v)
    rec["plain_bf16_ms"] = _event_ms(lambda: matmul_probe_plain(xb, wb), 5)
    rec["plain_int8_ms"] = _event_ms(lambda: matmul_probe_plain(xi, wi), 5)
    rec["kernel_bf16_ulps"] = ulps
    rec["kernel_bf16_max_abs_err"] = float(
        (got_b.float() - want_b.float()).abs().max())
    rec["kernel_int8_max_abs_err"] = 0.0
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--m", type=int, default=32768)
    p.add_argument("--k", type=int, default=256)
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--reps", type=int, default=50,
                   help="timed launches per variant")
    args = p.parse_args(argv)
    print(json.dumps(run_probe(args.m, args.k, args.n, reps=args.reps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
