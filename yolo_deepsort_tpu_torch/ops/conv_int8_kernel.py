"""Kernel 8: fused W8A8 conv of the int8-resident ReID embed (CUDA
``csrc/conv_int8.cu``).

Replaces the TPU kernels ``yolo_deepsort_tpu/ops/pallas_conv_int8.py``
``_conv_kernel_3x3`` and ``_conv_kernel_1x1`` (via ``conv_int8``). int8
activations in, int8 x int8 -> int32 on the tensor cores, and the epilogue
that keeps activations int8 between convs:

    y = f32(acc) * scale[co] + b[co]
    y = y + f32(residual) * res_scale      (where there is a residual)
    y = max(y, 0)                          (where relu)
    out = int8(clip(rint(y * oinv), -127, 127))   or   y as f32

each step rounded to f32, ties to even, no fused multiply-add. Bound on the
H100 by operations at the 3x3 layers (290-2300 per byte moved) and by bytes
at the 1x1 shortcuts. The design is an implicit GEMM -- rows N*Ho*Wo,
columns Co, depth k*k*Ci flat over taps and channels in 128-byte steps --
with the halo, stride 2 and the padding handled by index and zero fill in
the gather (no padded copy, no parity planes, no pre-decimated input), one
launch per conv. The main loop is ``csrc/conv_mainloop.cuh``, shared with
kernel 7: a multi-stage ring of swizzled tiles in shared memory filled by
asynchronous copies, ``wgmma`` m64nNk32 on what has arrived, ``mbarrier``s in
place of block-wide barriers; see the notes at the top of both files. The
tile plan of a shape comes from ``ops/conv_plan.py`` ``plan_conv_tiles``.

Layouts are the reference's: ``xq`` (N, Hi, Wi, Ci) int8 NHWC, ``wq`` (k, k,
Ci, Co) int8 HWIO; ``scale`` and ``b`` (Co,) f32; ``oinv`` and ``res_scale``
host floats; ``residual`` (N, Ho, Wo, Co) int8. The kernel reads the weights
K-major, (Co, k*k*Ci): integer ``wgmma`` takes no other layout. The embed's
package holds each conv's packed form (``conv_plan.pack_conv_weights``, plain
torch, once per layer, outside every timed loop) and passes the
``PackedWeights`` wherever ``wq`` goes, the plain version included; raw HWIO
weights are packed on the fly through a small cache
(``conv_plan.packed_weights``).

``conv_int8_plain`` is the plain PyTorch version: the codes convolved in
float64 (exact: PyTorch has no int8 conv, and the sums pass 2^24), cast to
int32, then the same f32 epilogue op for op. int32 sums are exact on the
card too, so the kernel is held exactly equal in its int8 codes, and to 1e-5
relative in its f32 output. ``conv_int8`` takes the plain version for CPU
tensors only; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import build
from .conv_plan import (ConvPlan, as_hwio, kernel_weights, weight_geometry,
                        weight_tensor)

launches = 0  # kernel launches; only the launch below adds to it


def _geometry(xq, wq, stride: int, pad: int):
    if xq.dim() != 4:
        raise ValueError(f"conv_int8: expected NHWC xq, got "
                         f"{tuple(xq.shape)}")
    wdtype = weight_tensor(wq).dtype  # HWIO or PackedWeights
    if xq.dtype != torch.int8 or wdtype != torch.int8:
        raise ValueError(f"conv_int8: expected int8 xq and wq, got "
                         f"{xq.dtype} and {wdtype}")
    n, hi, wi, ci = xq.shape
    k, k2, wci, co = weight_geometry(wq)
    if k != k2 or k not in (1, 3) or wci != ci:
        raise ValueError(f"conv_int8: wq {(k, k2, wci, co)} does not fit xq "
                         f"{tuple(xq.shape)} (k must be 1 or 3)")
    if pad != (k - 1) // 2 or stride not in (1, 2):
        raise ValueError(f"conv_int8: k={k} needs pad {(k - 1) // 2} and "
                         f"stride 1 or 2, got pad {pad}, stride {stride}")
    if stride == 2 and (hi % 2 or wi % 2):
        raise ValueError(f"conv_int8: stride 2 needs even spatial dims, got "
                         f"{hi}x{wi}")
    ho = (hi + 2 * pad - k) // stride + 1
    wo = (wi + 2 * pad - k) // stride + 1
    return n, hi, wi, ci, ho, wo, co, k


def int_conv_nhwc(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                  pad: int) -> torch.Tensor:
    """Exact integer conv of int8 codes: NHWC ``xq``, HWIO ``wq`` -> int32
    NHWC sums. Convolved in float64, where every sum is exact (below
    2^53)."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                 wq.permute(3, 2, 0, 1).double(), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def _scalar(v) -> float:
    """A host scalar as the Python float of its f32 value: no tensor is
    built from host data (that would synchronize a CUDA stream)."""
    return float(np.float32(v))


def conv_int8_plain(xq, wq, scale, b, oinv, residual=None, res_scale=None,
                    *, stride: int = 1, pad: int = 1, relu: bool = True,
                    out_int8: bool = True) -> torch.Tensor:
    """Plain version of kernel 8 (the counterpart of the reference's
    ``_xla_conv_int8_resident``): (N, Ho, Wo, Co) int8, or f32 with
    ``out_int8=False`` (``oinv`` is ignored then)."""
    _geometry(xq, wq, stride, pad)
    y = int_conv_nhwc(xq, as_hwio(wq), stride, pad).float() * scale.float() \
        + b.float()
    if residual is not None:
        y = y + residual.float() * _scalar(res_scale)
    if relu:
        y = y.clamp(min=0.0)
    if not out_int8:
        return y.contiguous()
    q = torch.round(y * _scalar(oinv)).clamp(-127, 127)
    return q.to(torch.int8).contiguous()


def conv_int8_cuda(xq, wq, scale, b, oinv, residual=None, res_scale=None,
                   *, stride: int = 1, pad: int = 1, relu: bool = True,
                   out_int8: bool = True,
                   plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """Launch the kernel: contiguous int8 NHWC ``xq`` and int8 weights (HWIO
    or packed) on the card, Ci and Co multiples of 16 (16-byte gathers of
    activation rows, 16-byte stores of output rows); anything else raises.
    ``plan`` forces a tile plan in place of the planner's."""
    n, hi, wi, ci, ho, wo, co, k = _geometry(xq, wq, stride, pad)
    tensors = (xq, scale, b) + (() if residual is None else (residual,))
    build.require_cuda("conv_int8", *tensors)
    build.require_cuda("conv_int8", weight_tensor(wq),
                       contiguous=False)  # packing takes any layout
    lib = build.load()  # raises before anything asks the card
    packed, plan = kernel_weights(wq, torch.int8, plan, xq.device,
                                  n * ho * wo)
    if ci % 16 or co % 16:
        raise ValueError(f"conv_int8 kernel: Ci and Co must be multiples of "
                         f"16, got {ci} and {co}")
    for name, t in (("scale", scale), ("b", b)):
        if t.dtype != torch.float32 or tuple(t.shape) != (co,):
            raise ValueError(f"conv_int8 kernel: {name} must be (Co,) "
                             "float32")
    if residual is not None:
        if k != 3:
            raise ValueError("conv_int8 kernel: a residual needs k = 3")
        if (residual.dtype != torch.int8
                or tuple(residual.shape) != (n, ho, wo, co)):
            raise ValueError(f"conv_int8 kernel: residual must be int8 "
                             f"{(n, ho, wo, co)}, got {residual.dtype} "
                             f"{tuple(residual.shape)}")
        if res_scale is None:
            raise ValueError("conv_int8 kernel: residual without res_scale")
    out = torch.empty((n, ho, wo, co), device=xq.device,
                      dtype=torch.int8 if out_int8 else torch.float32)
    err = lib.ydt_conv_int8(
        xq.data_ptr(), packed.data.data_ptr(), scale.data_ptr(),
        b.data_ptr(),
        None if residual is None else residual.data_ptr(),
        _scalar(0.0 if res_scale is None else res_scale), _scalar(oinv),
        out.data_ptr(), n, hi, wi, ci, ho, wo, co, k, stride, pad,
        int(bool(relu)), int(bool(out_int8)), packed.data.shape[1], plan.bm,
        plan.bn, plan.stages, plan.split,
        torch.cuda.current_stream(xq.device).cuda_stream)
    build.check_launch("conv_int8", err)
    global launches
    launches += 1
    return out


def conv_int8(xq, wq, scale, b, oinv, residual: Optional[torch.Tensor] = None,
              res_scale=None, *, stride: int = 1, pad: int = 1,
              relu: bool = True, out_int8: bool = True) -> torch.Tensor:
    """Fused int8 conv + dequant + bias (+ residual) (+ ReLU) (+ requant):
    the kernel for CUDA tensors, ``conv_int8_plain`` for CPU tensors."""
    fn = conv_int8_plain if xq.device.type == "cpu" else conv_int8_cuda
    return fn(xq, wq, scale, b, oinv, residual, res_scale, stride=stride,
              pad=pad, relu=relu, out_int8=out_int8)
