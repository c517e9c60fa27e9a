"""int8 (W8A8) quantization of the ReID embed net (port of
yolo_deepsort_tpu/models/quantize.py).

Scheme, the reference's:
  * weights: per-output-channel symmetric int8, scale = absmax / 127 over
    (kh, kw, ci);
  * activations: per-conv-input per-tensor symmetric int8, scale calibrated
    as absmax / 127 over a calibration batch;
  * int32 accumulation, then the product scale and the f32 bias.

Two dataflows:
  * per layer (``quantize_reid_params`` / ``reid_apply_int8``): every conv
    quantizes its f32 input, the nonlinearity, residual add and pooling stay
    f32;
  * int8-resident (``quantize_reid_params_resident`` /
    ``reid_apply_int8_resident``): stem and stage 1 run in floating point
    (the "front", bf16 in production), stages 2-4 keep int8 activations
    between convs, the requantization fused into each conv's epilogue
    (``ops/conv_int8_kernel.py``: kernel 8 for CUDA tensors with
    ``use_pallas``, its plain version otherwise). Down-block shortcuts are
    quantized before the residual add, identity shortcuts reuse the block
    input's codes.

Packages are numpy dicts with the reference's keys, so either package's
output can be fed to either side: the same folded f32 weights give the same
``wq`` byte for byte. Calibration runs where its input lies: a tensor's own
device, or for a numpy batch ``device`` (the CUDA card unless named); only
the per-conv scalars come back to the host.
``weights.reid_int8_package_to_torch`` turns a package into device tensors
once; the forward functions take that converted form only.

Layouts are the reference's: NHWC activations, HWIO weights.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.conv_int8_kernel import conv_int8, conv_int8_plain, int_conv_nhwc


def _conv_nhwc(x, w_oihw, stride, pad):
    """NHWC x, OIHW w -> NHWC product in the operands' dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _maxpool_nhwc(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def _oihw(w_hwio, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w_hwio, np.float32).transpose(3, 2, 0, 1))).to(device,
                                                                  dtype)


def _f32(v, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(v, np.float32))).to(device)


def _l2_normalize(feat):
    norm = feat.norm(dim=1, keepdim=True)
    return feat / norm.clamp(min=1e-12)


def _graph(params: Dict, x: torch.Tensor, conv: Callable) -> torch.Tensor:
    """The ReID net's graph with the conv abstracted out. conv(x, p, name,
    stride, pad) returns f32 NHWC. The stride rule reads the HWIO shape of
    ``p["w"]`` or, in a quantized package, ``p["wq"]``. Returns
    L2-normalized (N, 512) features."""

    def shape(p):
        return (p["w"] if "w" in p else p["wq"]).shape

    out = F.relu(conv(x, params["stem"], "stem", 1, 1))
    out = _maxpool_nhwc(out)
    for li, blocks in enumerate(params["layers"]):
        for bi, block in enumerate(blocks):
            stride = 1
            if block["down"] is not None:
                ci, co = shape(block["conv1"])[2:]
                stride = 2 if ci != co else 1
            tag = f"l{li}b{bi}"
            y = F.relu(conv(out, block["conv1"], f"{tag}c1", stride, 1))
            y = conv(y, block["conv2"], f"{tag}c2", 1, 1)
            if block["down"] is not None:
                shortcut = conv(out, block["down"], f"{tag}d", stride, 0)
            else:
                shortcut = out
            out = F.relu(y + shortcut)
    return _l2_normalize(out.mean((1, 2)))


def _float_conv(dtype):
    """A ``_graph`` conv over numpy {"w" HWIO, "b"} params in ``dtype``,
    f32 out."""

    def conv(x, p, name, stride, pad):
        del name
        y = _conv_nhwc(x.to(dtype), _oihw(p["w"], dtype, x.device), stride,
                       pad)
        return y.float() + _f32(p["b"], x.device)

    return conv


def _calib_tensor(calib_x, device) -> torch.Tensor:
    if isinstance(calib_x, torch.Tensor):
        return calib_x.float()
    return _f32(calib_x, resolve_device(device))


@contextlib.contextmanager
def _full_f32_convs():
    """Calibration convs in full float32 on a CUDA device too (cuDNN takes
    TF32 for f32 convs by default), so a card calibrates the scales a CPU
    does up to the order of the sums."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


@torch.no_grad()
def calibrate_reid_act_scales(params: Dict, calib_x,
                              device=None) -> Dict[str, float]:
    """Per-conv-input activation scales (absmax / 127) from one f32 forward
    over a calibration batch ``calib_x`` (N, 128, 64, 3), normalized."""
    scales: Dict[str, float] = {}
    f32_conv = _float_conv(torch.float32)

    def conv(x, p, name, stride, pad):
        scales[name] = float(x.abs().max()) / 127.0
        return f32_conv(x, p, name, stride, pad)

    with _full_f32_convs():
        _graph(params, _calib_tensor(calib_x, device), conv)
    return {k: max(v, 1e-12) for k, v in scales.items()}


def _quantize_weight(p):
    w = np.asarray(p["w"], np.float32)
    wscale = np.abs(w).reshape(-1, w.shape[3]).max(0) / 127.0
    wscale = np.maximum(wscale, 1e-12).astype(np.float32)
    wq = np.clip(np.rint(w / wscale), -127, 127).astype(np.int8)
    return wq, wscale


def quantize_reid_params(params: Dict, calib_x, device=None) -> Dict:
    """Folded f32 params -> the per-layer int8 package: {wq HWIO int8,
    wscale (Co,) f32, b, xscale} per conv."""
    if "dense" in params:
        raise ValueError("original_model.py layout is not on the int8 path")
    act = calibrate_reid_act_scales(params, calib_x, device)

    def qconv(p, name):
        wq, wscale = _quantize_weight(p)
        return {"wq": wq, "wscale": wscale,
                "b": np.asarray(p["b"], np.float32),
                "xscale": np.float32(act[name])}

    out: Dict = {"stem": qconv(params["stem"], "stem"), "layers": []}
    for li, blocks in enumerate(params["layers"]):
        out["layers"].append([{
            "conv1": qconv(block["conv1"], f"l{li}b{bi}c1"),
            "conv2": qconv(block["conv2"], f"l{li}b{bi}c2"),
            "down": (qconv(block["down"], f"l{li}b{bi}d")
                     if block["down"] is not None else None),
        } for bi, block in enumerate(blocks)])
    return out


@torch.no_grad()
def calibrate_reid_resident_scales(params: Dict, calib_x,
                                   device=None) -> Dict:
    """Activation scales of the resident path: the per-conv input scales
    plus each down block's SHORTCUT output scale (the resident path
    quantizes those too)."""
    x = _calib_tensor(calib_x, device)
    scales = calibrate_reid_act_scales(params, x)
    short: Dict[str, float] = {}
    f32_conv = _float_conv(torch.float32)

    def conv(x, p, name, stride, pad):
        out = f32_conv(x, p, name, stride, pad)
        if name.endswith("d"):
            short[name] = max(float(out.abs().max()) / 127.0, 1e-12)
        return out

    with _full_f32_convs():
        _graph(params, x, conv)
    return {"act": scales, "short": short}


def quantize_reid_params_resident(params: Dict, calib_x,
                                  device=None) -> Dict:
    """The package of the int8-resident path: stem and stage 1 as FLOAT
    params under "front", stages 2-4 as int8 convs, each with its combined
    dequant scale and its epilogue's requant scale: wq (HWIO int8), scale
    (Co,) = xscale * wscale, b (Co,), oinv = 1 / out_scale (out_scale: the
    consumer conv's xscale; a shortcut conv's own calibrated output scale;
    the last conv emits f32 and stores oinv = 0)."""
    if "dense" in params:
        raise ValueError("original_model.py layout is not on the int8 path")
    cal = calibrate_reid_resident_scales(params, calib_x, device)
    act, short = cal["act"], cal["short"]

    def qconv(p, name, out_scale):
        wq, wscale = _quantize_weight(p)
        return {
            "wq": wq,
            "scale": (np.float32(act[name]) * wscale).astype(np.float32),
            "b": np.asarray(p["b"], np.float32),
            "oinv": np.float32(0.0 if out_scale is None else 1.0 / out_scale),
        }

    n_stage = len(params["layers"])
    out: Dict = {
        "front": {"stem": params["stem"], "layers0": params["layers"][0]},
        # the front's f32 output quantizes with stage-2 conv1's input scale
        "in_scale": np.float32(act["l1b0c1"]),
        "layers": [],
    }
    for li in range(1, n_stage):
        blocks = params["layers"][li]
        qblocks = []
        for bi, block in enumerate(blocks):
            tag = f"l{li}b{bi}"
            # the consumer of this block's output: the next block's conv1
            # (and down conv: same tensor, same scale)
            if li == n_stage - 1 and bi == len(blocks) - 1:
                nxt = None
            elif bi + 1 < len(blocks):
                nxt = act[f"l{li}b{bi + 1}c1"]
            else:
                nxt = act[f"l{li + 1}b0c1"]
            qblocks.append({
                "conv1": qconv(block["conv1"], f"{tag}c1", act[f"{tag}c2"]),
                "conv2": qconv(block["conv2"], f"{tag}c2", nxt),
                "down": (qconv(block["down"], f"{tag}d", short[f"{tag}d"])
                         if block["down"] is not None else None),
                # dequant factor of the shortcut's codes
                "res_scale": np.float32(
                    short[f"{tag}d"] if block["down"] is not None
                    else act[f"{tag}c1"]),
            })
        out["layers"].append(qblocks)
    return out


def _probe(pkg: Dict):
    """One scale of a package (resident or per layer): a numpy scalar, or a
    0-dim tensor once converted."""
    return pkg["in_scale"] if "front" in pkg else pkg["stem"]["xscale"]


def is_torch_package(pkg: Dict) -> bool:
    return isinstance(_probe(pkg), torch.Tensor)


def package_device(pkg: Dict) -> torch.device:
    """The device a converted package lies on."""
    return _probe(pkg).device


def package_front_dtype(pkg: Dict) -> torch.dtype:
    """The dtype the serving steps make crops in for this converted package:
    the front's for a resident package, f32 for a per-layer one (every conv
    there quantizes an f32 input)."""
    if "front" in pkg:
        return pkg["front"]["stem"]["w"].dtype
    return torch.float32


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / scale), -127, 127) as int8, ties to even; ``scale`` a
    0-dim tensor on x's device, so the division stays a division."""
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8)


@torch.no_grad()
def reid_apply_int8(qparams: Dict, x: torch.Tensor) -> torch.Tensor:
    """Per-layer int8 forward: (N, 128, 64, 3) normalized -> (N, 512)
    L2-normalized. Every conv quantizes its f32 input, convolves the codes
    exactly (``int_conv_nhwc``) and dequantizes: f32(acc) * (xscale *
    wscale) + b. No kernel: the route is the accuracy control of the
    resident one. ``qparams`` is the converted per-layer package."""

    def conv(xf, qp, name, stride, pad):
        del name
        acc = int_conv_nhwc(_quantize(xf.float(), qp["xscale"]), qp["wq"],
                            stride, pad)
        return acc.float() * qp["scale"] + qp["b"]

    return _graph(qparams, x, conv)


def _resident_stages(qparams: Dict, tq: torch.Tensor,
                     iconv: Callable) -> torch.Tensor:
    """Stages 2-4 of the int8-resident forward: the front's output as int8
    codes ``tq`` (N, 32, 16, 64) through the 15 fused int8 convs ``iconv``
    (``conv_int8`` or ``conv_int8_plain``), the last of which emits f32 ->
    (N, 512) L2-normalized features."""

    def run(xq, qp, stride, pad, relu, out_int8, residual=None,
            res_scale=None):
        # the kernel reads the package's packed weights, the plain version
        # the HWIO ones
        wq = qp.get("wq_packed", qp["wq"]) \
            if iconv is conv_int8 and xq.is_cuda else qp["wq"]
        return iconv(xq, wq, qp["scale"], qp["b"], qp["oinv"],
                     residual, res_scale, stride=stride, pad=pad, relu=relu,
                     out_int8=out_int8)

    n_stages = len(qparams["layers"])
    for li, blocks in enumerate(qparams["layers"]):
        for bi, block in enumerate(blocks):
            last = li == n_stages - 1 and bi == len(blocks) - 1
            down = block["down"]
            stride = 2 if down is not None else 1
            y1 = run(tq, block["conv1"], stride, 1, True, True)
            shortq = (run(tq, down, stride, 0, False, True)
                      if down is not None else tq)
            tq = run(y1, block["conv2"], 1, 1, True, not last,
                     residual=shortq, res_scale=block["res_scale"])
    return _l2_normalize(tq.mean((1, 2)))  # the last conv emitted f32


@torch.no_grad()
def reid_apply_int8_resident(qparams: Dict, x: torch.Tensor,
                             use_pallas: bool = False) -> torch.Tensor:
    """int8-resident forward: (N, 128, 64, 3) normalized -> (N, 512)
    L2-normalized. Stem and stage 1 in the front's dtype through library
    convs (f32 bias add, ReLU and residual, as the reference); stages 2-4 as
    15 fused int8 convs with int8 activations in between. ``use_pallas``
    (the reference's name) takes kernel 8 -- for CUDA tensors the CUDA
    kernel, or it raises; for CPU tensors its plain version -- and False
    takes the plain version wherever the tensors lie. ``qparams`` is the
    converted resident package; its front carries the dtype."""
    front = qparams["front"]
    dtype = front["stem"]["w"].dtype

    def fconv(xf, p, stride, pad):
        # the conv's output plus the f32 bias promotes to f32 in one pass
        return _conv_nhwc(xf.to(dtype), p["w"], stride, pad) + p["b"]

    out = F.relu(fconv(x, front["stem"], 1, 1))
    out = _maxpool_nhwc(out.to(dtype))
    for block in front["layers0"]:  # stage 1: 64 -> 64, stride 1, no down
        y = F.relu(fconv(out, block["conv1"], 1, 1))
        y = fconv(y, block["conv2"], 1, 1)
        out = F.relu(y + out)  # f32 + the front's dtype -> f32

    # quantize once into the resident domain
    tq = _quantize(out, qparams["in_scale"]).contiguous()
    return _resident_stages(qparams, tq,
                            conv_int8 if use_pallas else conv_int8_plain)


@torch.no_grad()
def reid_apply_f32_via_graph(params: Dict, x: torch.Tensor,
                             compute_dtype=torch.float32) -> torch.Tensor:
    """Float twin of ``reid_apply_int8`` through the same ``_graph`` walker
    (a walker bug shows as a disagreement with ``models/reid.ReIDNet``)."""
    return _graph(params, x, _float_conv(compute_dtype))
