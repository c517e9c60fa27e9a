"""Kernel 7: backbone conv + bias + activation on the tensor cores (CUDA
``csrc/conv.cu``), in bf16 and in W8A8 int8.

Replaces the TPU kernel ``yolo_deepsort_tpu/ops/pallas_conv.py``
(``_conv_kernel`` via ``conv_mxu_bf16`` / ``conv_mxu_int8``), with its
routing policy (``backbone_conv_eligible``, ``make_backbone_conv_impl``,
``load_conv_whitelist``). In bf16 it is also the default conv of every bf16
net of the port (``models/layers.conv_layer_bf16``): its f32 sums, f32 bias
and activation and one rounding are where the reference's bf16 forward
rounds, so every conv layer of a bf16 ``Darknet`` and ReID net runs here on
the card, whatever ``backbone_conv_eligible`` (the route's speed policy)
says. Activations: linear, leaky, mish (as y n / (n + 2), n = e^y (e^y +
2): one exponential and one division, within 8 f32 ulps of float64 mish),
and the ReID nets' ReLU and ELU;
``out_dtype=torch.float32`` gives the f32-output form (no rounding, for a
residual sum that rounds after its add), and ``residual=`` a residual
block's whole tail in the epilogue: act((sum + bias) + shortcut) in f32,
rounded once, the shortcut (bf16 or f32, the output's shape) read there
(modes 4 and 5, counted in ``launches_residual`` as well). Bound on the
H100 by operations (hundreds to thousands per byte moved at the backbone's 3x3 shapes; by bytes
at the 1x1 ones). The design is an implicit GEMM -- rows N*Ho*Wo, columns Co,
depth k*k*Ci flat over taps and channels -- one output tile per block (or per
cluster of blocks that share its depth), with the padding, the ragged edges
and stride 2 handled by index and zero fill in the gather. The main loop is
``csrc/conv_mainloop.cuh``, shared with kernel 8: producer warps keep a
multi-stage ring of swizzled tiles in shared memory full with asynchronous
copies, consumer warpgroups run ``wgmma`` on what has arrived, ``mbarrier``s
hand stages back and forth, and no block-wide barrier sits in the loop. Bias
and activation are fused into the bf16 NHWC store (see the notes at the top
of both files). The tile plan of a shape comes from ``ops/conv_plan.py``
``plan_conv_tiles``.

Layouts are the reference's: ``x`` (N, Hi, Wi, Ci) NHWC, ``w`` (k, k, Ci, Co)
HWIO; ``b`` (Co,) f32; int8 mode adds ``scale`` (Co,) f32 = xscale * wscale
and the host scalar ``xinv`` = 1 / xscale. The result is bf16 NHWC. The
kernel reads the weights K-major, (Co, k*k*Ci): ``wgmma`` takes no other
layout for int8. The route packs each layer's weights once
(``conv_plan.pack_conv_weights``, plain torch, outside every timed loop) and
passes the ``PackedWeights`` wherever ``w`` goes, the plain versions
included; raw HWIO weights are packed on the fly through a small cache
(``conv_plan.packed_weights``).

``conv_plain_bf16`` and ``conv_plain_int8`` are the plain PyTorch versions:
the same values (bf16-rounded operands, or int8 codes quantized with
ties-to-even) and the kernel's f32 epilogue, op for op. bf16 products are
exact in f32 and only the order of the f32 sums differs, so the kernel is
held to within 2 bf16 ulps of the plain version; int32 sums are exact, so
int8 mode is held exactly equal. ``conv_bf16`` / ``conv_int8`` take the
plain version for CPU tensors only; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels import build
from .conv_plan import (ConvPlan, as_hwio, kernel_weights,
                        pack_conv_weights, weight_geometry, weight_tensor)

launches = 0  # kernel launches; only the launch below adds to it
launches_residual = 0  # of them, those with a shortcut in the epilogue
launches_mish = 0  # of them, those whose epilogue runs mish (any mode)

# relu and elu are the ReID nets' (their stems and each block's first conv)
_ACT_CODES = {"linear": 0, "": 0, "leaky": 1, "mish": 2, "relu": 3, "elu": 4}


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "leaky":
        return torch.where(y > 0, y, 0.1 * y)
    if act == "mish":
        return y * torch.tanh(torch.logaddexp(torch.zeros_like(y), y))
    if act == "relu":
        return torch.relu(y)
    if act == "elu":  # jax.nn.elu's form, as the kernel's expm1f
        return torch.where(y > 0, y, torch.expm1(y))
    if act in ("linear", ""):
        return y
    raise ValueError(f"unknown activation {act!r}")


def _geometry(x, w, stride: int, pad: int):
    if x.dim() != 4:
        raise ValueError(f"conv: expected NHWC x, got {tuple(x.shape)}")
    n, hi, wi, ci = x.shape
    k, k2, wci, co = weight_geometry(w)
    if k != k2 or k not in (1, 3) or wci != ci:
        raise ValueError(f"conv: w {(k, k2, wci, co)} does not fit x "
                         f"{tuple(x.shape)} (k must be 1 or 3)")
    if pad != (k - 1) // 2 or stride not in (1, 2):
        raise ValueError(f"conv: k={k} needs pad {(k - 1) // 2} and stride 1 "
                         f"or 2, got pad {pad}, stride {stride}")
    if stride == 2 and (hi % 2 or wi % 2):
        raise ValueError(f"conv: stride 2 needs even spatial dims, got "
                         f"{hi}x{wi}")
    ho = (hi + 2 * pad - k) // stride + 1
    wo = (wi + 2 * pad - k) // stride + 1
    return n, hi, wi, ci, ho, wo, co, k


def _conv_nhwc(x, w_hwio, stride, pad):
    """NHWC x, HWIO w (both of one float dtype) -> NHWC product."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def conv_plain_bf16(x, w, b, *, stride: int = 1, pad: int = 1,
                    act: str = "leaky",
                    out_dtype: torch.dtype = torch.bfloat16,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the bf16 mode: operands rounded to bf16, products
    and sums in f32, + bias, activation, rounded to bf16 (``out_dtype``
    float32: not rounded, the f32-output form). ``residual``: + the
    shortcut in f32 after the bias, before the activation."""
    n, _, _, _, ho, wo, co, _ = _geometry(x, w, stride, pad)
    _check_out_dtype(out_dtype, residual)
    _check_residual(residual, (n, ho, wo, co), x.device)
    y = _conv_nhwc(x.to(torch.bfloat16).float(),
                   as_hwio(w).to(torch.bfloat16).float(), stride, pad)
    y = y + b.float()
    if residual is not None:
        y = y + residual.float()
    return apply_act(y, act).to(out_dtype).contiguous()


def _check_out_dtype(out_dtype, residual=None):
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv (bf16 mode): out_dtype must be bfloat16 or "
                         f"float32, got {out_dtype}")
    if residual is not None and out_dtype != torch.bfloat16:
        raise ValueError("conv (bf16 mode): a residual's tail rounds to "
                         "bfloat16; out_dtype float32 takes none")


def _check_residual(residual, shape, device):
    """A shortcut the epilogue can read: the conv's output shape, bf16 or
    f32, contiguous NHWC, on the conv's device."""
    if residual is None:
        return
    if tuple(residual.shape) != tuple(shape):
        raise ValueError(f"conv residual: expected shape {tuple(shape)}, got "
                         f"{tuple(residual.shape)}")
    if residual.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv residual: expected bfloat16 or float32, got "
                         f"{residual.dtype}")
    if not residual.is_contiguous():
        raise ValueError("conv residual: must be contiguous NHWC")
    if residual.device != device:
        raise ValueError(f"conv residual: on {residual.device}, the conv on "
                         f"{device}")


def quantize_activations(x: torch.Tensor, xinv: float) -> torch.Tensor:
    """clip(rint(f32(x) * xinv), -127, 127) as integer-valued f32 (ties to
    even, as ``jnp.round`` and the kernel's ``rintf``)."""
    # a Python scalar, exactly the f32 value: no tensor is built from host
    # data (that would synchronize a CUDA stream)
    return torch.round(x.float() * float(np.float32(xinv))).clamp(-127, 127)


def conv_plain_int8(x, wq, b, scale, xinv, *, stride: int = 1, pad: int = 1,
                    act: str = "leaky", return_acc: bool = False):
    """Plain version of the int8 mode. PyTorch has no int8 conv, and the
    sums pass 2^24, so the integer codes are convolved in float64 (exact
    below 2^53) and cast to int32; then the kernel's f32 epilogue
    f32(acc) * scale + b, activation, bf16. ``return_acc`` returns the
    int32 sums instead."""
    _geometry(x, wq, stride, pad)
    xq = quantize_activations(x, xinv).double()
    acc = _conv_nhwc(xq, as_hwio(wq).double(), stride, pad).to(torch.int32)
    if return_acc:
        return acc.contiguous()
    y = acc.float() * scale.float() + b.float()
    return apply_act(y, act).to(torch.bfloat16).contiguous()


def _launch(x, w, b, scale, xinv, stride, pad, act, mode, plan,
            residual=None):
    """``mode``: 0 bf16, 1 int8 with bf16 x, 2 int8 with f32 x, 3 bf16 with
    an f32 output, 4 and 5 bf16 with a bf16 or f32 ``residual``."""
    n, hi, wi, ci, ho, wo, co, k = _geometry(x, w, stride, pad)
    if residual is not None:
        _check_residual(residual, (n, ho, wo, co), x.device)
        if co % 8:
            raise ValueError(f"conv kernel: a residual needs Co a multiple "
                             f"of 8, got {co}")
    tensors = (x, b) + (() if scale is None else (scale,))
    build.require_cuda("conv", *tensors)
    build.require_cuda("conv", weight_tensor(w),
                       contiguous=False)  # packing takes any layout
    lib = build.load()  # raises before anything asks the card
    bf16 = mode not in (1, 2)
    packed, plan = kernel_weights(
        w, torch.bfloat16 if bf16 else torch.int8, plan, x.device,
        n * ho * wo, quantizing=not bf16)
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if ci % 8:
        raise ValueError(f"conv kernel: Ci must be a multiple of 8 (16-byte "
                         f"gathers of activation rows), got {ci}")
    if b.dtype != torch.float32 or tuple(b.shape) != (co,):
        raise ValueError("conv kernel: b must be (Co,) float32")
    if scale is not None and (scale.dtype != torch.float32
                              or tuple(scale.shape) != (co,)):
        raise ValueError("conv kernel: scale must be (Co,) float32")
    out = torch.empty((n, ho, wo, co), device=x.device,
                      dtype=torch.float32 if mode == 3 else torch.bfloat16)
    err = lib.ydt_conv(
        x.data_ptr(), packed.data.data_ptr(), b.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if residual is None else residual.data_ptr(), float(xinv),
        out.data_ptr(), n, hi, wi, ci, ho, wo, co, k, stride, pad,
        _ACT_CODES[act], mode, packed.data.shape[1], plan.bm, plan.bn,
        plan.stages, plan.split,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("conv", err)
    global launches, launches_residual, launches_mish
    launches += 1
    launches_residual += residual is not None
    launches_mish += act == "mish"
    return out


def conv_bf16_cuda(x, w, b, *, stride=1, pad=1, act="leaky",
                   plan: Optional[ConvPlan] = None,
                   out_dtype: torch.dtype = torch.bfloat16,
                   residual: Optional[torch.Tensor] = None):
    """Launch the kernel in bf16 mode: contiguous bf16 NHWC ``x`` and bf16
    weights (HWIO or packed) on the card (a ``torch.cat`` result must be
    contiguous in channels_last; anything else raises). ``plan`` forces a
    tile plan in place of the planner's; ``out_dtype`` float32 takes the
    f32-output form (mode 3); ``residual`` (bf16 or f32, the output's
    shape, contiguous, on the card) is added in the epilogue before the
    activation, from the same sums as mode 3 (the planner's plan does not
    depend on the mode)."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"conv kernel (bf16): expected bfloat16 x, got "
                         f"{x.dtype}")
    _check_out_dtype(out_dtype, residual)
    mode = 3 if out_dtype == torch.float32 else 0
    if residual is not None:
        mode = 4 if residual.dtype == torch.bfloat16 else 5
    return _launch(x, w, b, None, 0.0, stride, pad, act, mode, plan,
                   residual)


def conv_int8_cuda(x, wq, b, scale, xinv, *, stride=1, pad=1, act="leaky",
                   plan: Optional[ConvPlan] = None):
    """Launch the kernel in int8 mode: ``x`` bf16 or f32 (quantized on the
    way into shared memory), ``wq`` int8 (HWIO or packed), ``xinv`` a host
    scalar. ``plan`` forces a tile plan in place of the planner's."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv kernel (int8): expected bfloat16 or float32 "
                         f"x, got {x.dtype}")
    mode = 1 if x.dtype == torch.bfloat16 else 2
    return _launch(x, wq, b, scale, xinv, stride, pad, act, mode, plan)


def conv_bf16(x, w, b, *, stride: int = 1, pad: int = 1,
              act: str = "leaky",
              out_dtype: torch.dtype = torch.bfloat16,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bf16 conv + bias (+ ``residual``) + activation, f32 accumulation;
    bf16 NHWC (or the unrounded f32 with ``out_dtype=torch.float32``). The
    kernel for CUDA tensors, ``conv_plain_bf16`` for CPU tensors."""
    if x.device.type == "cpu":
        return conv_plain_bf16(x, w, b, stride=stride, pad=pad, act=act,
                               out_dtype=out_dtype, residual=residual)
    return conv_bf16_cuda(x, w, b, stride=stride, pad=pad, act=act,
                          out_dtype=out_dtype, residual=residual)


def conv_int8(x, wq, b, scale, xinv, *, stride: int = 1, pad: int = 1,
              act: str = "leaky") -> torch.Tensor:
    """W8A8 conv with bf16 glue: quantize in, int8 products, int32 sums,
    per-channel dequant + bias + activation out (bf16 NHWC). The kernel for
    CUDA tensors, ``conv_plain_int8`` for CPU tensors."""
    if x.device.type == "cpu":
        return conv_plain_int8(x, wq, b, scale, xinv, stride=stride, pad=pad,
                               act=act)
    return conv_int8_cuda(x, wq, b, scale, xinv, stride=stride, pad=pad,
                          act=act)


def int8_package_to_torch(pkg: Dict[int, Dict],
                          device=None) -> Dict[int, Dict]:
    """The numpy package of ``models/quantize_darknet.py`` (either
    package's) as the tensors the kernel reads, on ``device`` (the CUDA
    card unless another is named): ``wq`` int8 HWIO contiguous, on a CUDA
    device also ``wq_packed`` (the K-major form the kernel reads), ``scale``
    and ``b`` f32, ``xinv`` kept as a host float (the kernel takes it by
    value). The conv routes accept either form; converting up front keeps
    the first routed call free of uploads and of packing."""
    device = resolve_device(device)

    def tensor(v, np_dtype):
        if isinstance(v, torch.Tensor):  # already converted: move only
            return v.to(device).contiguous()
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(v, np_dtype))).to(device)

    def layer(qp):
        out = {
            "wq": tensor(qp["wq"], np.int8),
            "scale": tensor(qp["scale"], np.float32),
            "b": tensor(qp["b"], np.float32),
            "xinv": float(np.float32(qp["xinv"])),
        }
        if device.type == "cuda":
            out["wq_packed"] = pack_conv_weights(out["wq"])
        return out

    return {int(idx): layer(qp) for idx, qp in pkg.items()}


def backbone_conv_eligible(hi: int, wi: int, ci: int, co: int, k: int,
                           stride: int, act: str, max_hw: int = 64) -> bool:
    """Routing policy of the conv hook, the reference's: deep backbone and
    head convs (Ci, Co >= 128, spatial <= ``max_hw``), k 1 or 3, stride 2
    only on even maps; the spatially large early layers stay on the library
    conv."""
    if k not in (1, 3) or act not in ("leaky", "linear", "mish"):
        return False
    if stride == 2 and (hi % 2 or wi % 2):
        return False
    if max(hi, wi) > max_hw:
        return False
    return ci >= 128 and co >= 128


def make_backbone_conv_impl(*, max_hw: int = 64,
                            layer_whitelist: Optional[frozenset] = None,
                            int8_pkg: Optional[Dict[int, Dict]] = None):
    """``conv_impl`` hook for ``Darknet.forward``: route eligible convs
    through ``conv_bf16`` and the layers of ``int8_pkg`` (the package of
    ``models/quantize_darknet.py``) through ``conv_int8``; return None (the
    library conv) for every other layer. ``layer_whitelist`` restricts the
    route to those module indices.

    The hook receives the module's weights as an HWIO view. Each routed
    layer's weights are packed once, on the layer's first call -- bf16, or
    the package's int8 tensors on the device; on a CUDA device in the
    kernel's K-major form (``pack_conv_weights``), on the CPU as contiguous
    HWIO for the plain version -- and kept: the route serves one detector
    whose inference weights are frozen; load new weights, build a new
    route."""
    packed: Dict[int, tuple] = {}   # layer -> (w bf16, b f32)
    int8_dev: Dict[int, Dict] = {}

    def impl(x, w, b, stride, pad, act, layer_idx):
        hi, wi, ci = int(x.shape[1]), int(x.shape[2]), int(x.shape[3])
        co, k = int(w.shape[3]), int(w.shape[0])
        if layer_whitelist is not None and layer_idx not in layer_whitelist:
            return None
        if pad != (k - 1) // 2:  # unpadded k=3 convs (rare cfg) are not routed
            return None
        if not backbone_conv_eligible(hi, wi, ci, co, k, stride, act,
                                      max_hw=max_hw):
            return None
        if int8_pkg is not None and layer_idx in int8_pkg:
            if layer_idx not in int8_dev:
                int8_dev[layer_idx] = int8_package_to_torch(
                    {layer_idx: int8_pkg[layer_idx]}, x.device)[layer_idx]
            qp = int8_dev[layer_idx]
            return conv_int8(x, qp.get("wq_packed", qp["wq"]), qp["b"],
                             qp["scale"], qp["xinv"], stride=stride, pad=pad,
                             act=act)
        if layer_idx not in packed:
            wp = w.detach().to(torch.bfloat16).contiguous()
            packed[layer_idx] = (
                pack_conv_weights(wp) if wp.is_cuda else wp,
                b.detach().float().contiguous())
        wp, bp = packed[layer_idx]
        return conv_bf16(x.to(torch.bfloat16), wp, bp, stride=stride,
                         pad=pad, act=act)

    return impl


def load_conv_whitelist(model: str, img_size: int, batch: int,
                        tuned_dir: Optional[str] = None):
    """Load a per-layer routing whitelist ``conv_whitelist_<model>_<size>_
    b<batch>.json``: {"bf16": frozenset(layer), "int8": frozenset(layer)}
    for the serving steps' ``use_pallas_conv=`` argument, or None when there
    is no file for this (model, img_size, batch) or its ``backend`` field is
    not ``"cuda"``: per-shape winners belong to the chip they were timed
    on, so a file tuned on a TPU (or one that does not say) is refused."""
    if tuned_dir is None:
        tuned_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "tuned")
    path = os.path.join(
        tuned_dir, f"conv_whitelist_{model}_{img_size}_b{batch}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    if d.get("backend") != "cuda":
        return None
    return {"bf16": frozenset(d.get("bf16", ())),
            "int8": frozenset(d.get("int8", ()))}
