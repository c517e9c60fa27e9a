"""Kernel 1: the fused letterbox (CUDA ``csrc/letterbox.cu``).

Replaces the TPU kernel ``yolo_deepsort_tpu/ops/pallas_letterbox.py``
(``pallas_letterbox_batch``). Bound on the H100 by bytes: it reads the
uint8 frame taps and writes the (B, S, S, 3) backbone input once, in the
compute dtype, with no padded square, planar copy or separate cast pass in
between (see the note at the top of the .cu file).

``letterbox_batch_fused`` takes the plain PyTorch version
(``ops/letterbox.py letterbox_batch``) for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..kernels import build
from ..utils.profiling import span
from .letterbox import _pad_amounts, letterbox_batch

launches = 0  # kernel launches; only the launch below adds to it


def letterbox_batch_fused(frames: torch.Tensor, size: int,
                          out_dtype: torch.dtype = torch.float32):
    """(B, H, W, 3) uint8 -> (B, size, size, 3) ``out_dtype`` in [0, 1].

    The NHWC result is the same memory as a channels_last (B, 3, S, S)
    tensor: ``out.permute(0, 3, 1, 2)`` feeds the backbone directly."""
    with span("ydt.letterbox"):
        if frames.device.type == "cpu":
            return letterbox_batch(frames, size, out_dtype)
        return letterbox_cuda(frames, size, out_dtype)


def letterbox_cuda(frames: torch.Tensor, size: int,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    build.require_cuda("letterbox", frames)
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError("letterbox: expected (B, H, W, 3) uint8 frames, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"letterbox: unsupported out_dtype {out_dtype}")
    b, h, w, _ = frames.shape
    top, _, left, _ = _pad_amounts(h, w)
    out = torch.empty((b, size, size, 3), dtype=out_dtype,
                      device=frames.device)
    lib = build.load()
    err = lib.ydt_letterbox(
        frames.data_ptr(), out.data_ptr(), b, h, w, size, top, left,
        max(h, w), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(frames.device).cuda_stream)
    build.check_launch("letterbox", err)
    global launches
    launches += 1
    return out
