"""The conv layer of the port's nets and its bf16 forward.

The reference computes a conv in bf16 as bf16 operands with f32 sums
(``preferred_element_type=jnp.float32``), adds its f32 bias, activates in
f32 and rounds to bf16 once (``yolo_deepsort_tpu/models/darknet.py``
``_conv`` / ``_activate``, ``models/reid.py`` ``_conv``). The library's
bf16 conv rounds its output, and a bf16 bias add and activation round
again, so the port's nets run every bf16 conv through ``conv_layer_bf16``:
``ops/conv_kernel.conv_bf16``, kernel 7 on the card (its epilogue applies
the bias and the activation in f32 and rounds once) and its plain version
on the CPU.

``Conv2d`` is ``nn.Conv2d`` whose bias stays float32 when the module is
cast to another dtype: the reference's bias is the f32 folded value
whatever its compute dtype. ``Linear`` keeps weight and bias float32: the
reference's dense ReID heads compute in f32 in a bf16 net.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv_kernel import conv_bf16, conv_bf16_cuda
from ..ops.conv_plan import PackedWeights, pack_conv_weights


class KeepsF32:
    """A module whose parameters named in ``F32`` stay float32 through
    ``.to(dtype)`` (a move to another device still moves them)."""

    F32 = ()

    def _apply(self, fn, recurse=True):
        keep = {}
        for name in self.F32:
            p = getattr(self, name)
            if p is not None and p.dtype == torch.float32:
                keep[name] = p.detach().clone()
        super()._apply(fn, recurse)
        for name, v in keep.items():
            p = getattr(self, name)
            if p.dtype != torch.float32:
                p.data = v.to(p.device)
        return self


class Conv2d(KeepsF32, nn.Conv2d):
    """``nn.Conv2d`` with a float32 bias through ``.to(dtype)``."""

    F32 = ("bias",)


class Linear(KeepsF32, nn.Linear):
    """``nn.Linear`` that stays float32 through ``.to(dtype)``."""

    F32 = ("weight", "bias")


def kernel_weights(conv: nn.Conv2d) -> PackedWeights:
    """The layer's weights as kernel 7 reads them on the card: bf16, input
    channels zero-padded to a multiple of 8 (exact: the padded input
    channels are zero too), packed K-major. Packed at the first call and
    kept on the module until its weights change (keyed on their memory and
    version counter; the entry holds the memory, so it cannot be reused)."""
    w = conv.weight
    hit = conv.__dict__.get("_packed_bf16")
    if (hit is not None and hit[0].data_ptr() == w.data_ptr()
            and hit[1] == w._version and hit[0].device == w.device):
        return hit[2]
    hwio = w.detach().permute(2, 3, 1, 0).to(torch.bfloat16)
    ci = hwio.shape[2]
    if ci % 8:
        hwio = F.pad(hwio, (0, 0, 0, 8 - ci % 8))
    packed = pack_conv_weights(hwio.contiguous())
    conv.__dict__["_packed_bf16"] = (w.detach(), w._version, packed)
    return packed


def conv_layer_bf16(conv: nn.Conv2d, x: torch.Tensor, act: str,
                    out_dtype: torch.dtype = torch.bfloat16,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conv layer in bf16 as the reference computes it: ``x`` (N, H, W,
    Ci) NHWC -> act(conv(x, w) + b) NHWC, summed, biased and activated in
    f32 and rounded once to bf16 (``out_dtype`` float32: not rounded, for
    a residual sum that rounds after its add). ``residual`` (the output's
    shape, bf16 or f32) is that sum: act((conv(x, w) + b) + residual) in
    f32, rounded once, in the kernel's epilogue on the card."""
    stride, pad = conv.stride[0], conv.padding[0]
    b = conv.bias.detach().float()
    x = x.to(torch.bfloat16)
    if x.device.type == "cpu":
        return conv_bf16(x, conv.weight.detach().permute(2, 3, 1, 0), b,
                         stride=stride, pad=pad, act=act, out_dtype=out_dtype,
                         residual=residual)
    packed = kernel_weights(conv)
    if packed.ci != x.shape[3]:
        x = F.pad(x, (0, packed.ci - x.shape[3]))
    return conv_bf16_cuda(x.contiguous(), packed, b.contiguous(),
                          stride=stride, pad=pad, act=act,
                          out_dtype=out_dtype, residual=residual)
