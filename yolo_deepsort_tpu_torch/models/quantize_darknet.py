"""int8 (W8A8) quantization of the detector backbone's deep convs (port of
yolo_deepsort_tpu/models/quantize_darknet.py).

Scheme, the reference's:
  * weights: per-output-channel symmetric int8, absmax / 127 over (kh, kw, ci);
  * activations: per-conv-input per-tensor symmetric int8, calibrated as
    absmax / 127 (or a percentile) over a calibration batch; the quantize is
    fused into the conv kernel's tile load, so the network keeps its float
    activations between layers and routes, shortcuts and non-eligible layers
    are untouched;
  * int32 accumulation, per-channel dequant + bias + activation in the
    kernel's epilogue (``ops/conv_kernel.py`` ``conv_int8``).

Only convs passing ``backbone_conv_eligible`` are quantized. The package is
numpy, as in the reference -- {layer: {"wq" HWIO int8, "scale" (Co,) f32 =
xscale * wscale, "b" (Co,) f32, "xinv" f32 = 1 / xscale}} -- so the two
packages can be held against each other: the same folded f32 weights give
the same ``wq`` byte for byte. The detector handed in is the float32
``Darknet`` module (its conv weights are the folded f32 weights);
calibration runs on the device that module lies on -- a detector on the card
calibrates on the card, and the CPU is taken only by handing in a CPU
detector. Only the per-layer scalars and, for packaging, the routed layers'
weights come back to the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.conv_kernel import (
    backbone_conv_eligible,
    conv_plain_int8,
    int8_package_to_torch,
)
from ..ops.letterbox import letterbox_batch
from .darknet import Darknet


def _layer_geometry(x, w, stride, pad, act) -> bool:
    hi, wi, ci = int(x.shape[1]), int(x.shape[2]), int(x.shape[3])
    co, k = int(w.shape[3]), int(w.shape[0])
    return pad == (k - 1) // 2 and backbone_conv_eligible(
        hi, wi, ci, co, k, stride, act)


def _f32_device(detector: Darknet) -> torch.device:
    """The device of the float32 detector; any other dtype raises."""
    param = next(detector.parameters())
    if param.dtype != torch.float32:
        raise ValueError("quantization needs the float32 detector (its "
                         f"weights are the folded f32 weights), got "
                         f"{param.dtype}")
    return param.device


def _abs_percentile(x: torch.Tensor, pct: float) -> float:
    """``np.percentile(|x|, pct)`` (linear interpolation; 100 is the
    absmax) of a tensor, computed on its device: one scalar comes back."""
    ax = x.float().abs()
    if pct >= 100:
        return float(ax.max())
    v = torch.sort(ax.reshape(-1)).values
    pos = pct / 100.0 * (v.numel() - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, v.numel() - 1)
    a, b = (float(t) for t in v[[lo, hi]].tolist())
    return a + (b - a) * (pos - lo)


@torch.no_grad()
def calibrate_darknet_act_scales(detector: Darknet, calib_x,
                                 pct: float = 100.0) -> Dict[int, float]:
    """Per-eligible-conv input activation scales from one f32 forward over a
    calibration batch ``calib_x`` (N, S, S, 3) in [0, 1] (letterboxed frames
    of the content the step will see), on the detector's own device.
    ``pct`` is the percentile of |x| mapped to code 127 (100: absmax, the
    reference's default)."""
    scales: Dict[int, float] = {}

    def recording_impl(x, w, b, stride, pad, act, layer_idx):
        if _layer_geometry(x, w, stride, pad, act):
            scales[layer_idx] = max(_abs_percentile(x, pct) / 127.0, 1e-12)
        return None  # always the library conv

    dev = _f32_device(detector)
    if not isinstance(calib_x, torch.Tensor):
        calib_x = torch.from_numpy(np.asarray(calib_x, np.float32))
    detector(calib_x.to(dev, torch.float32), conv_impl=recording_impl)
    return scales


def quantize_darknet_convs(detector: Darknet, calib_x, pct: float = 100.0,
                           k3_only: bool = False, layers=None
                           ) -> Dict[int, Dict[str, np.ndarray]]:
    """The float32 detector -> int8 packages for every eligible conv (see
    the module docstring); layers not in the returned dict stay on the bf16
    path. ``k3_only`` keeps the 1x1 convs in bf16; ``layers`` packages only
    those module indices (a routing whitelist's int8 set)."""
    act = calibrate_darknet_act_scales(detector, calib_x, pct=pct)
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for idx, xscale in act.items():
        if layers is not None and idx not in layers:
            continue
        conv = detector.convs[str(idx)]
        # OIHW -> HWIO, the reference's layout of the same folded weights
        w = np.ascontiguousarray(
            conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0),
            np.float32)
        if k3_only and w.shape[0] != 3:
            continue
        co = w.shape[3]
        wscale = np.abs(w).reshape(-1, co).max(0) / 127.0
        wscale = np.maximum(wscale, 1e-12).astype(np.float32)
        wq = np.clip(np.rint(w / wscale), -127, 127).astype(np.int8)
        out[idx] = {
            "wq": wq,
            "scale": (np.float32(xscale) * wscale).astype(np.float32),
            "b": conv.bias.detach().cpu().numpy().astype(np.float32),
            "xinv": np.float32(1.0 / xscale),
        }
    return out


def quantize_darknet_from_frames(detector: Darknet, frames,
                                 img_size: int, max_frames: int = 2,
                                 pct: float = 100.0, k3_only: bool = False,
                                 layers=None
                                 ) -> Dict[int, Dict[str, np.ndarray]]:
    """Calibrate and package from raw frames (N, H, W, 3) uint8 (numpy or
    a tensor on any device): letterbox the first ``max_frames`` to the
    detect stage's geometry and calibrate, both on the detector's device."""
    fr = frames[:max_frames]
    if not isinstance(fr, torch.Tensor):
        fr = torch.from_numpy(np.ascontiguousarray(np.asarray(fr, np.uint8)))
    xs = letterbox_batch(fr.to(_f32_device(detector)), img_size)
    return quantize_darknet_convs(detector, xs, pct=pct, k3_only=k3_only,
                                  layers=layers)


def make_plain_int8_conv_impl(int8_pkg: Dict[int, Dict]):
    """Plain PyTorch twin of the int8 kernel route (the reference's
    ``make_xla_int8_conv_impl``): identical arithmetic -- quantize in, exact
    integer sums, per-channel dequant + bias + activation -- through
    ``conv_plain_int8`` on whatever device the tensors lie; used by accuracy
    gates and the semantics tests. Non-packaged layers take the library
    conv."""
    dev_pkg: Dict[int, Dict] = {}

    def impl(x, w, b, stride, pad, act, layer_idx):
        if layer_idx not in int8_pkg:
            return None
        if layer_idx not in dev_pkg:
            dev_pkg[layer_idx] = int8_package_to_torch(
                {layer_idx: int8_pkg[layer_idx]}, x.device)[layer_idx]
        qp = dev_pkg[layer_idx]
        return conv_plain_int8(x, qp["wq"], qp["b"], qp["scale"], qp["xinv"],
                               stride=stride, pad=pad, act=act)

    return impl
