"""Kernel 9: chains of darknet residual blocks (CUDA ``csrc/resblock.cu``),
in bf16 and in W8A8 int8.

Replaces the TPU kernel ``yolo_deepsort_tpu/ops/pallas_resblock.py``
(``_chain_kernel`` via ``resblock_chain_bf16`` / ``resblock_chain_int8``),
with its span discovery (``find_residual_spans``), its planner
(``plan_chain_schedule``) and its ``block_impl`` hook
(``make_resblock_impl``). A chain is B consecutive blocks

    x -> conv1x1 (Ci -> Cm) + b1 -> act -> conv3x3 (Cm -> Ci, pad 1) + b2
      -> act -> + x

The TPU kernel keeps whole frames and ``mid`` in VMEM; an SM has 227 KB of
shared memory, so here each block is two launches of the implicit-GEMM main
loop that kernels 7 and 8 share (``csrc/conv_mainloop.cuh``), both from ONE
C entry per chain on the caller's stream: the 1x1 conv writes ``mid`` to
device memory (it stays in the L2 cache), the 3x3 conv's epilogue adds the
shortcut. In W8A8 mode the 1x1 conv's epilogue writes ``mid`` as the int8
codes the 3x3 conv reads. The chain state lives in two device buffers used
in turn. Each layer's tile plan is ``ops/conv_plan.py``
``plan_conv_tiles``' for its shape (``plan_chain_schedule``).

Layouts are the reference's: ``x`` (N, H, W, Ci) bf16 NHWC; ``w1``
(B, Ci, Cm) and ``w2`` (B, 3, 3, Cm, Ci) HWIO per block, bf16 or int8, or
both packed once to the K-major rows the kernel reads (``pack_chain_weights``:
the route packs when it first meets a chain, the public wrappers pack per
call); ``b1`` (B, Cm), ``b2`` (B, Ci) f32; int8 mode adds ``scale1``
(B, Cm), ``scale2`` (B, Ci) f32 = xscale * wscale per channel and ``xinv``
(B, 2) f32 = [1 / xscale1, 1 / xscale2], which the kernel path takes from
HOST memory (a CPU tensor or a numpy array; the kernels take it by value, and
reading it back from the card would synchronize the stream). The result is
bf16 NHWC.

``resblock_chain_plain_bf16`` / ``resblock_chain_plain_int8`` are the plain
PyTorch versions, the kernel's arithmetic op for op: bf16 operands, f32
sums, + bias, activation in f32, rounded to bf16 (``mid``), the same for the
3x3 conv, then the shortcut add in bf16. int8: the chain state stays bf16,
conv1 quantizes its input ``clip(rint(f32(x) * xinv1), -127, 127)``, int32
sums, ``f32(acc) * s1 + b1``, activation, bf16, and ``mid`` is quantized
once with ``xinv2`` (the kernel does that in the 1x1 conv's epilogue: the
same codes). int32 sums are exact, so the kernel's int8 mode with a leaky
activation is held exactly equal; its bf16 mode sums in another order (one
block within 4 bf16 ulps, a chain to rtol = atol = 3e-2). The wrappers take
the plain version for CPU tensors only; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import build
from ..models.darknet import BLOCK_SPAN
from ..utils.profiling import span
from .conv_kernel import (
    _ACT_CODES,
    conv_plain_bf16,
    conv_plain_int8,
    int8_package_to_torch,
)
from .conv_plan import (
    H100_SM_COUNT,
    SMEM_PER_BLOCK,
    ConvPlan,
    PackedWeights,
    _sm_count,
    max_stages,
    pack_conv_weights,
    plan_conv_tiles,
    plan_smem_bytes,
    unpack_conv_weights,
)

launches = 0  # calls of the C entry, one per chain; only the launch adds
device_kernels = 0  # kernels those calls launched, as the C entry counts

_CHANNELS = 128  # Ci and Cm must be multiples of this (the route's rule)
_MAX_ELEMS = 2 ** 31  # the main loop's gather offsets are 32-bit

# What the kernel's bf16 mode is held to against its plain version, on the
# operands of ``seeded_chain_case`` (chain state of order 1). A whole chain:
# every element inside rtol = atol = CHAIN_TOL (the reference's own bound).
# One block: the 3x3 conv's result y is within the conv kernel's 2 bf16 ulps
# of ITS magnitude, and |y| <= |x| + |out|, so the block's output is held to
# CHAIN_BLOCK_ULPS bf16 ulps of max(|x|, |out|, CHAIN_ULP_FLOOR) (where the
# shortcut add cancels, the ulp of |out| itself says nothing). int8 mode with
# a leaky activation is held exactly equal; the kernel's mish is another
# form than the plain version's and is held to the bf16 bounds in both modes.
CHAIN_TOL = 3e-2
CHAIN_BLOCK_ULPS = 4.0
CHAIN_ULP_FLOOR = 2.0 ** -3


class ChainSchedule(NamedTuple):
    """How one chain runs: the tile plans of its 1x1 conv (``conv1``, Ci ->
    Cm, quantizing in int8 mode) and of its 3x3 conv (``conv2``, Cm -> Ci),
    the same for every block, and the kernels one call launches
    (``kernel_launches``, two per block)."""

    conv1: ConvPlan
    conv2: ConvPlan
    kernel_launches: int


def _fit_budget(plan: ConvPlan, budget: int) -> Optional[ConvPlan]:
    """The plan with its ring cut to ``budget`` bytes of shared memory, or
    None when not even two stages fit."""
    stages = min(plan.stages, max_stages(plan.bm, plan.bn))
    while stages > 2 and plan_smem_bytes(plan.bm, plan.bn, stages) > budget:
        stages -= 1
    if plan_smem_bytes(plan.bm, plan.bn, stages) > budget:
        return None
    return plan._replace(stages=stages)


def plan_chain_schedule(n: int, h: int, w: int, ci: int, cm: int, nblk: int,
                        int8_mode: bool,
                        budget: Optional[int] = None
                        ) -> Optional[ChainSchedule]:
    """The schedule of a chain at (n, h, w, ci, cm) of ``nblk`` blocks, or
    None when the kernel does not take it; the caller then runs the chain
    layer by layer. None when a size is below 1, when Ci or Cm is not a
    multiple of 128 (the route's rule: every chain of the served models
    fills its tiles), when the state's elements, n * h * w * max(Ci, Cm),
    pass the main loop's 32-bit offsets, or when a layer's tile does not fit
    ``budget`` bytes of shared memory (227 KB unless given) with even a
    two-stage ring.

    Each block is two launches of the shared main loop, so each layer takes
    ``plan_conv_tiles``' plan for its shape: the 1x1 conv as m = n * h * w
    pixels, Cm columns, depth Ci (quantizing
    in int8 mode: the producers quantize the bf16 state); the 3x3 conv as m
    pixels, Ci columns, depth 9 * Cm (int8 codes by cp.async in int8 mode:
    nothing to quantize). At yolov3-416 and batch 8 those shapes are kernel
    7's timed classes. The plans are those of the card the planner's table
    was timed on (132 SMs); the kernel path plans for its own card."""
    return _schedule(n, h, w, ci, cm, nblk, int8_mode,
                     SMEM_PER_BLOCK if budget is None else budget,
                     H100_SM_COUNT)


@functools.lru_cache(maxsize=None)
def _schedule(n, h, w, ci, cm, nblk, int8_mode, budget, sm_count):
    if min(n, h, w, nblk) < 1 or ci % _CHANNELS or cm % _CHANNELS \
            or ci < _CHANNELS or cm < _CHANNELS \
            or n * h * w * max(ci, cm) >= _MAX_ELEMS:
        return None
    m, es = n * h * w, 1 if int8_mode else 2
    conv1 = _fit_budget(plan_conv_tiles(m, cm, ci, es, sm_count,
                                        quantizing=int8_mode), budget)
    conv2 = _fit_budget(plan_conv_tiles(m, ci, 9 * cm, es, sm_count),
                        budget)
    if conv1 is None or conv2 is None:
        return None
    return ChainSchedule(conv1, conv2, 2 * nblk)


def pack_chain_weights(w) -> PackedWeights:
    """Stacked weights, (B, Ci, Cm) for the 1x1 convs or (B, 3, 3, Cm, Ci)
    for the 3x3 convs, bf16 or int8, packed per block: ``PackedWeights``
    whose ``data`` (B, Co, ldw) stacks block b's ``pack_conv_weights`` rows
    (the same K-major format with a block axis in front); a pack is returned
    as it is. Plain torch; the route runs it once per chain."""
    if isinstance(w, PackedWeights):
        return w
    if w.dim() == 3:
        hwio = w[:, None, None]
    elif w.dim() == 5:
        hwio = w
    else:
        raise ValueError(f"pack_chain_weights: expected (B, Ci, Cm) or (B, "
                         f"3, 3, Cm, Ci) weights, got {tuple(w.shape)}")
    packs = [pack_conv_weights(hwio[b]) for b in range(hwio.shape[0])]
    return packs[0]._replace(data=torch.stack([p.data for p in packs]))


def unpack_chain_weights(p) -> torch.Tensor:
    """The stacked weights a pack came from ((B, Ci, Cm) or (B, 3, 3, Cm,
    Ci)), each block by ``unpack_conv_weights``; raw weights as they are."""
    if not isinstance(p, PackedWeights):
        return p
    w = torch.stack([unpack_conv_weights(p._replace(data=d)) for d in p.data])
    return w[:, 0, 0] if p.k == 1 else w


def pack_chain_args(args):
    """``resblock_chain_*`` arguments with ``w1`` and ``w2`` packed."""
    x, w1, b1, w2, *rest = args
    return (x, pack_chain_weights(w1), b1, pack_chain_weights(w2), *rest)


def block_args(args, b: int):
    """The ``resblock_chain_*`` arguments after ``x`` (weights raw or
    packed, biases, scales, ``xinv``) cut to block ``b`` alone."""
    return tuple(a._replace(data=a.data[b:b + 1])
                 if isinstance(a, PackedWeights) else a[b:b + 1]
                 for a in args)


def _chain_geometry(w, k: int):
    """(nblk, k, in, out) of raw or packed weights of a ``k`` x ``k`` conv
    ((B, Ci, Cm) raw for k = 1, (B, 3, 3, Cm, Ci) for k = 3); None for a
    shape that is neither."""
    if isinstance(w, PackedWeights):
        return ((w.data.shape[0], w.k, w.ci, w.co)
                if w.data.dim() == 3 and w.k == k else None)
    if k == 1:
        return (w.shape[0], 1, w.shape[1], w.shape[2]) if w.dim() == 3 \
            else None
    return ((w.shape[0], w.shape[1], w.shape[3], w.shape[4])
            if w.dim() == 5 and w.shape[1] == w.shape[2] else None)


def _check_chain(x, w1, b1, w2, b2, scale1, scale2, xinv):
    g1, g2 = _chain_geometry(w1, 1), _chain_geometry(w2, 3)
    if x.dim() != 4 or g1 is None or g2 is None:
        raise ValueError(f"resblock chain: expected x (N, H, W, Ci), w1 (B, "
                         f"Ci, Cm), w2 (B, 3, 3, Cm, Ci), got "
                         f"{tuple(x.shape)}, {g1}, {g2}")
    n, h, w, ci = x.shape
    nblk, _, wci, cm = g1
    if wci != ci or g2 != (nblk, 3, cm, ci):
        raise ValueError(f"resblock chain: w1 {g1} / w2 {g2} (B, k, in, out) "
                         f"do not fit x {tuple(x.shape)}")
    if tuple(b1.shape) != (nblk, cm) or tuple(b2.shape) != (nblk, ci):
        raise ValueError("resblock chain: b1 must be (B, Cm), b2 (B, Ci)")
    if scale1 is not None and (
            tuple(scale1.shape) != (nblk, cm)
            or tuple(scale2.shape) != (nblk, ci)
            or tuple(xinv.shape) != (nblk, 2)):
        raise ValueError("resblock chain: scale1 must be (B, Cm), scale2 "
                         "(B, Ci), xinv (B, 2)")
    return n, h, w, ci, cm, nblk


def _host_xinv(xinv) -> np.ndarray:
    """The (B, 2) ``xinv`` table as contiguous float32 in host memory, from
    a CPU tensor or an array. A CUDA tensor raises: the kernels take the
    values by value, and reading them back would synchronize the stream."""
    if isinstance(xinv, torch.Tensor):
        if xinv.device.type != "cpu":
            raise ValueError(
                "resblock chain kernel: xinv must lie in host memory (a CPU "
                "tensor or a numpy array), got a tensor on "
                f"{xinv.device}: the kernels take its values by value, and "
                "reading them back from the card would synchronize the "
                "stream")
        xinv = xinv.detach().numpy()
    return np.ascontiguousarray(np.asarray(xinv, np.float32))


def resblock_chain_plain_bf16(x, w1, b1, w2, b2, *,
                              act: str = "leaky") -> torch.Tensor:
    """Plain version of the bf16 mode (see the module docstring)."""
    *_, nblk = _check_chain(x, w1, b1, w2, b2, None, None, None)
    w1, w2 = unpack_chain_weights(w1), unpack_chain_weights(w2)
    out = x.to(torch.bfloat16)
    for b in range(nblk):
        mid = conv_plain_bf16(out, w1[b][None, None], b1[b], stride=1, pad=0,
                              act=act)
        y = conv_plain_bf16(mid, w2[b], b2[b], stride=1, pad=1, act=act)
        out = y + out  # a bf16 add
    return out.contiguous()


def resblock_chain_plain_int8(x, w1q, b1, w2q, b2, scale1, scale2, xinv, *,
                              act: str = "leaky") -> torch.Tensor:
    """Plain version of the int8 mode (see the module docstring): each conv
    is ``conv_plain_int8`` (the codes convolved in float64: the sums pass
    2^24), ``mid`` stays bf16 between them and is quantized by the second.
    ``xinv`` a tensor (read back here) or an array."""
    *_, nblk = _check_chain(x, w1q, b1, w2q, b2, scale1, scale2, xinv)
    w1q, w2q = unpack_chain_weights(w1q), unpack_chain_weights(w2q)
    xi = (xinv.detach().cpu().tolist() if isinstance(xinv, torch.Tensor)
          else np.asarray(xinv, np.float32).tolist())
    out = x.to(torch.bfloat16)
    for b in range(nblk):
        mid = conv_plain_int8(out, w1q[b][None, None], b1[b], scale1[b],
                              xi[b][0], stride=1, pad=0, act=act)
        y = conv_plain_int8(mid, w2q[b], b2[b], scale2[b], xi[b][1],
                            stride=1, pad=1, act=act)
        out = y + out
    return out.contiguous()


def resblock_chain_cuda(x, w1, b1, w2, b2, scale1=None, scale2=None,
                        xinv=None, *, act: str = "leaky") -> torch.Tensor:
    """Launch the kernel: contiguous tensors on the card, ``x`` bf16, the
    weights bf16 (no scales) or int8 (with ``scale1``, ``scale2``, ``xinv``
    in host memory), raw (packed here, per call) or packed
    (``pack_chain_weights``), the biases and scales f32. Ci and Cm must be
    multiples of 128 (``plan_chain_schedule``); anything else raises."""
    n, h, w, ci, cm, nblk = _check_chain(x, w1, b1, w2, b2, scale1, scale2,
                                         xinv)
    int8_mode = scale1 is not None
    f32 = (b1, b2) + ((scale1, scale2) if int8_mode else ())
    build.require_cuda("resblock chain", x, *f32)
    build.require_cuda(
        "resblock chain", *(p.data if isinstance(p, PackedWeights) else p
                             for p in (w1, w2)), contiguous=False)
    lib = build.load()  # raises before anything asks the card
    xinv_h = _host_xinv(xinv) if int8_mode else None
    w1p, w2p = pack_chain_weights(w1), pack_chain_weights(w2)
    wdt = torch.int8 if int8_mode else torch.bfloat16
    if x.dtype != torch.bfloat16 or w1p.data.dtype != wdt \
            or w2p.data.dtype != wdt:
        raise ValueError(f"resblock chain kernel: expected bfloat16 x and "
                         f"{wdt} weights, got {x.dtype}, {w1p.data.dtype}, "
                         f"{w2p.data.dtype}")
    if not (w1p.data.is_contiguous() and w2p.data.is_contiguous()):
        raise ValueError("resblock chain kernel: expected contiguous packed "
                         "weights")
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError("resblock chain kernel: biases and scales must be "
                         "float32")
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    index = (x.device.index if x.device.index is not None
             else torch.cuda.current_device())
    sched = _schedule(n, h, w, ci, cm, nblk, int8_mode, SMEM_PER_BLOCK,
                      _sm_count(index))
    if sched is None:
        raise ValueError(f"resblock chain kernel: no schedule for x "
                         f"{tuple(x.shape)} with Cm {cm} (Ci and Cm must be "
                         f"multiples of 128 and the state below 2^31 "
                         f"elements)")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if nblk > 1 else None
    mid = torch.empty((n, h, w, cm), dtype=wdt, device=x.device)
    p1, p2 = sched.conv1, sched.conv2
    launched = ctypes.c_int(0)
    err = lib.ydt_resblock_chain(
        x.data_ptr(), out.data_ptr(),
        None if tmp is None else tmp.data_ptr(), mid.data_ptr(),
        w1p.data.data_ptr(), w2p.data.data_ptr(), b1.data_ptr(),
        b2.data_ptr(), scale1.data_ptr() if int8_mode else None,
        scale2.data_ptr() if int8_mode else None,
        xinv_h.ctypes.data if int8_mode else None,
        n, h, w, ci, cm, nblk, _ACT_CODES[act], w1p.data.shape[2],
        w2p.data.shape[2], p1.bm, p1.bn, p1.stages, p1.split, p2.bm, p2.bn,
        p2.stages, p2.split, int(int8_mode), ctypes.addressof(launched),
        stream)
    build.check_launch("resblock chain", err)
    global launches, device_kernels
    launches += 1
    device_kernels += launched.value
    return out


def resblock_chain_bf16(x, w1, b1, w2, b2, *,
                        act: str = "leaky") -> torch.Tensor:
    """B residual blocks, bf16 products and f32 sums; bf16 NHWC. The
    kernel for CUDA tensors, ``resblock_chain_plain_bf16`` for CPU
    tensors."""
    if x.device.type == "cpu":
        return resblock_chain_plain_bf16(x, w1, b1, w2, b2, act=act)
    return resblock_chain_cuda(x, w1, b1, w2, b2, act=act)


def resblock_chain_int8(x, w1q, b1, w2q, b2, scale1, scale2, xinv, *,
                        act: str = "leaky") -> torch.Tensor:
    """W8A8 residual blocks (bf16 chain state, ``mid`` quantized once). The
    kernel for CUDA tensors (``xinv`` in host memory),
    ``resblock_chain_plain_int8`` for CPU tensors."""
    if x.device.type == "cpu":
        return resblock_chain_plain_int8(x, w1q, b1, w2q, b2, scale1, scale2,
                                         xinv, act=act)
    return resblock_chain_cuda(x, w1q, b1, w2q, b2, scale1, scale2, xinv,
                               act=act)


# ---------------------------------------------------------------------------
# span discovery and the Darknet.forward hook


def find_residual_spans(plan) -> List[Tuple[int, ...]]:
    """Fusable residual-block chains of a ``NetworkPlan``.

    A span starts at module index i when defs[i..i+2] is the darknet
    residual pattern -- conv1x1 (stride 1) -> conv3x3 (stride 1, pad 1, same
    activation) -> shortcut (from=-3, linear) -- and nothing outside the
    span references the two conv outputs. Consecutive spans with the same
    activation and the same Cm merge into a chain, unless something outside
    the chain references the earlier span's shortcut output (the hook caches
    only a chain's last output). Returns a list of chains, each a tuple of
    span-start indices. Spatial size and channel minima are checked by the
    hook at call time (the plan does not know layer resolutions)."""
    defs = plan.defs()

    def res(ref, cur):
        return ref if ref >= 0 else cur + ref

    # which module indices consume layer L's output through a route or a
    # shortcut (the flow to the next module is not counted)
    refs: Dict[int, List[int]] = {}
    for i, d in enumerate(defs):
        if d["type"] == "route":
            for l in str(d["layers"]).split(","):
                refs.setdefault(res(int(l), i), []).append(i)
        elif d["type"] == "shortcut":
            refs.setdefault(res(int(d["from"]), i), []).append(i)
            refs.setdefault(i - 1, []).append(i)

    spans = []
    i = 0
    while i + 2 < len(defs):
        d0, d1, d2 = defs[i], defs[i + 1], defs[i + 2]
        ok = (
            d0["type"] == "convolutional"
            and int(d0["size"]) == 1 and int(d0.get("stride", 1)) == 1
            and d0.get("activation") in ("leaky", "mish")
            and d1["type"] == "convolutional"
            and int(d1["size"]) == 3 and int(d1.get("stride", 1)) == 1
            and int(d1.get("pad", 0)) == 1
            and d1.get("activation") == d0.get("activation")
            and d2["type"] == "shortcut"
            and res(int(d2["from"]), i + 2) == i - 1
            and d2.get("activation", "linear") in ("linear", "")
            # the conv outputs are referenced only by this span's shortcut
            and refs.get(i, []) == []
            and refs.get(i + 1, []) == [i + 2]
        )
        if ok:
            spans.append(i)
            i += 3
        else:
            i += 1

    chains: List[Tuple[int, ...]] = []
    for s in spans:
        last = chains[-1][-1] if chains else None
        if (last is not None and last + 3 == s
                and defs[last].get("activation") == defs[s].get("activation")
                and int(defs[last]["filters"]) == int(defs[s]["filters"])
                # the earlier shortcut's output feeds this span's shortcut
                # and nothing else
                and refs.get(last + 2, []) == [s + 2]):
            chains[-1] = chains[-1] + (s,)
        else:
            chains.append((s,))
    return chains


def make_resblock_impl(plan, *, int8_pkg=None, max_hw: int = 64,
                       min_ci: int = 128, chain_whitelist=None):
    """``block_impl`` hook for ``Darknet.forward``.

    At module index i, ``impl(x, convs, i)`` returns ``(out, consumed)``
    when i starts a fusable chain whose geometry the kernel takes (maps up
    to ``max_hw``, Ci and Cm at least ``min_ci`` and multiples of 128, a
    schedule from ``plan_chain_schedule``), else None and the chain runs
    layer by layer. ``x`` is the NHWC view of the module's input, ``convs`` the
    detector's conv layers by module index. ``int8_pkg`` (the package of
    ``models/quantize_darknet.py``) switches a chain to W8A8 when it holds
    BOTH convs of every block of the chain. ``chain_whitelist`` restricts
    the route to chains whose start index is listed.

    A chain's weights are packed once, on the chain's first call -- bf16
    from the detector's convs, or the package's int8 tensors, each block's
    two convs packed K-major (``pack_chain_weights``; on the CPU, where the
    plain version runs, they stay HWIO) -- with the package's (B, 2)
    ``xinv`` table kept in host memory, and kept: the route serves one
    detector whose inference weights are frozen; load new weights, build a
    new route. A claimed chain's work is one ``BLOCK_SPAN`` profiler range
    (while a profiler records)."""
    chains = {c[0]: c for c in find_residual_spans(plan)}
    if chain_whitelist is not None:
        chains = {s: c for s, c in chains.items() if s in chain_whitelist}
    defs = plan.defs()
    packed: Dict[int, tuple] = {}

    def pack(chain, convs, device, use_int8):
        def packed_form(w1, b1, w2, *rest):
            if device.type != "cuda":
                return (w1, b1, w2, *rest)
            return (pack_chain_weights(w1), b1, pack_chain_weights(w2),
                    *rest)

        if use_int8:
            layers = {l: int8_pkg[l] for s in chain for l in (s, s + 1)}
            dev = int8_package_to_torch(layers, device)
            first, second = ([dev[s + o] for s in chain] for o in (0, 1))
            ci, cm = first[0]["wq"].shape[2:]
            # the table stays in host memory: the kernel takes it by value
            xinv = torch.tensor(
                [[p["xinv"], q["xinv"]] for p, q in zip(first, second)],
                dtype=torch.float32)
            return packed_form(
                torch.stack([p["wq"].reshape(ci, cm) for p in first]),
                torch.stack([p["b"] for p in first]),
                torch.stack([q["wq"] for q in second]),
                torch.stack([q["b"] for q in second]),
                torch.stack([p["scale"] for p in first]),
                torch.stack([q["scale"] for q in second]), xinv)
        first, second = ([convs[str(s + o)] for s in chain] for o in (0, 1))
        # OIHW -> (Ci, Cm) and HWIO
        return packed_form(
            torch.stack([c.weight.detach()[:, :, 0, 0].t()
                         for c in first]).to(torch.bfloat16).contiguous(),
            torch.stack([c.bias.detach().float() for c in first]),
            torch.stack([c.weight.detach().permute(2, 3, 1, 0)
                         for c in second]).to(torch.bfloat16).contiguous(),
            torch.stack([c.bias.detach().float() for c in second]))

    def impl(x, convs, i):
        chain = chains.get(i)
        if chain is None:
            return None
        h, w, ci = int(x.shape[1]), int(x.shape[2]), int(x.shape[3])
        cm = convs[str(i)].out_channels
        if max(h, w) > max_hw or ci < min_ci or cm < min_ci:
            return None
        if ci % 128 or cm % 128:
            return None
        use_int8 = int8_pkg is not None and all(
            s in int8_pkg and s + 1 in int8_pkg for s in chain)
        if plan_chain_schedule(int(x.shape[0]), h, w, ci, cm, len(chain),
                               use_int8) is None:
            return None
        if i not in packed:
            packed[i] = pack(chain, convs, x.device, use_int8)
        fn = resblock_chain_int8 if use_int8 else resblock_chain_bf16
        with span(BLOCK_SPAN):
            out = fn(x.to(torch.bfloat16), *packed[i],
                     act=defs[i].get("activation"))
        return out, chain[-1] + 3 - i

    return impl


# ---------------------------------------------------------------------------
# seeded operands and error measures for holding the kernel to its plain
# version (the smoke script and the tests that run on the card)


def seeded_chain_case(rng, device, n: int, h: int, ci: int, cm: int,
                      nblk: int, act: str = "leaky",
                      branch_gain: float = 0.25) -> dict:
    """Operands of one chain from a numpy ``Generator``: x ~ N(0, 1) bf16,
    w1 ~ N(0, 1 / fan-in), b1 ~ N(0, 1); the residual branch's w2 and b2 are
    those scaled by ``branch_gain``, so that the chain state stays of order
    1 over a long chain (at gain 1 its rms grows tenfold over 8 blocks and
    an elementwise bound says little). ``bf16``: (x, w1, b1, w2, b2);
    ``int8``: the W8A8 arguments of ``resblock_chain_int8`` (absmax weight
    scales per output channel; activation scales from the absmax of each
    conv's input along a pass of the plain bf16 version over two frames;
    their (B, 2) ``xinv`` table a CPU tensor, as the kernel takes it);
    ``xinv``: the table as a numpy array."""
    x = torch.from_numpy(rng.standard_normal((n, h, h, ci), np.float32)).to(
        device, torch.bfloat16)
    w1 = rng.standard_normal((nblk, ci, cm), np.float32) / np.sqrt(ci)
    w2 = (rng.standard_normal((nblk, 3, 3, cm, ci), np.float32)
          * np.float32(branch_gain / np.sqrt(9 * cm)))
    b1 = torch.from_numpy(rng.standard_normal((nblk, cm), np.float32)).to(
        device)
    b2 = torch.from_numpy(rng.standard_normal((nblk, ci), np.float32)
                          * np.float32(branch_gain)).to(device)
    w1b = torch.from_numpy(w1).to(device, torch.bfloat16)
    w2b = torch.from_numpy(w2).to(device, torch.bfloat16)
    ws1 = np.abs(w1).max(1) / 127.0                        # (B, Cm)
    ws2 = np.abs(w2).reshape(nblk, -1, ci).max(1) / 127.0  # (B, Ci)
    w1q = np.clip(np.rint(w1 / ws1[:, None]), -127, 127).astype(np.int8)
    w2q = np.clip(np.rint(w2 / ws2[:, None, None, None]), -127, 127).astype(
        np.int8)
    xs = np.zeros((nblk, 2), np.float32)
    cur = x[:2]
    for b in range(nblk):
        xs[b, 0] = float(cur.float().abs().max()) / 127.0
        mid = conv_plain_bf16(cur, w1b[b][None, None], b1[b], pad=0, act=act)
        xs[b, 1] = float(mid.float().abs().max()) / 127.0
        cur = resblock_chain_plain_bf16(cur, w1b[b:b + 1], b1[b:b + 1],
                                        w2b[b:b + 1], b2[b:b + 1], act=act)
    xinv = (1.0 / xs).astype(np.float32)
    return dict(
        bf16=(x, w1b, b1, w2b, b2),
        int8=(x, torch.from_numpy(w1q).to(device), b1,
              torch.from_numpy(w2q).to(device), b2,
              torch.from_numpy((xs[:, :1] * ws1).astype(np.float32)).to(
                  device),
              torch.from_numpy((xs[:, 1:] * ws2).astype(np.float32)).to(
                  device),
              torch.from_numpy(xinv)),
        xinv=xinv)


def chain_outside_tol(got, want) -> int:
    """How many elements of ``got`` lie outside rtol = atol = CHAIN_TOL of
    ``want``."""
    got, want = got.float(), want.float()
    return int(((got - want).abs() > CHAIN_TOL * (1 + want.abs())).sum())


def chain_block_ulps(got, want, x) -> float:
    """Largest distance of one block's output from its plain version in bf16
    ulps of max(|x|, |want|, CHAIN_ULP_FLOOR)."""
    got, want = got.float(), want.float()
    scale = torch.maximum(want.abs(), x.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(
        scale.clamp(min=CHAIN_ULP_FLOOR))) - 7)
    return float(((got - want).abs() / ulp).max())
