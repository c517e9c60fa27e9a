"""Darknet ``.weights`` IO, BN folding, and parameters into modules.

* ``load_darknet_weights`` / ``save_darknet_weights`` /
  ``fold_inference_params`` / ``random_raw_params`` are copies of the JAX
  package's (yolo_deepsort_tpu/models/weights.py): the byte stream is a
  5 x int32 header, then float32 params for every [convolutional] layer in
  cfg order (bn_bias, bn_weight, bn_mean, bn_var, conv OIHW -- or
  conv_bias, conv OIHW without BN). Folding BN (eps 1e-5) into the conv
  gives the HWIO {"w", "b"} tree both packages compute from.
* Darknet: that folded tree -> OIHW tensors for ``Darknet.load_params``.
* ``conv_int8_package_to_torch``: the numpy int8 package of
  ``models/quantize_darknet.py`` (either package's) -> the device tensors
  the conv kernel reads (``ops/conv_kernel.int8_package_to_torch`` under
  the name this module's callers use).
* ``reid_int8_package_to_torch``: the numpy int8 package of
  ``models/quantize.py`` (either package's; resident or per layer) -> device
  tensors, the int8 weights laid out once for kernel 8; the one form the
  forward functions of ``models/quantize.py`` and the serving steps read.
* ReID: a folded HWIO tree (``models/reid.py`` random params or loaders)
  -> ``ReIDNet`` or, for the 128-d layout, ``OriginalReIDNet``.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .models.darknet import Darknet, NetworkPlan, conv_layer_shapes
from .device import resolve_device
from .models.quantize import is_torch_package
from .models.reid import OriginalReIDNet, ReIDNet
from .ops.conv_plan import pack_conv_weights
from .ops.conv_kernel import (  # noqa: F401  (re-exported)
    int8_package_to_torch as conv_int8_package_to_torch,
)

BN_EPS = 1e-5


def count_params(module_defs: Sequence[dict], in_channels: int = 3) -> int:
    """Total float count of the .weights payload (excluding the header)."""
    total = 0
    for _, oc, ic, k, has_bn in conv_layer_shapes(module_defs, in_channels):
        total += oc * ic * k * k + (4 * oc if has_bn else oc)
    return total


def load_darknet_weights(source, module_defs: Sequence[dict],
                         in_channels: int = 3, cutoff: int | None = None
                         ) -> Tuple[np.ndarray, Dict]:
    """Parse a ``.weights`` file or its bytes into (header, raw params with
    OIHW convs). ``cutoff`` stops at that module index (backbone-only
    files; darknet53.conv.74 is cut at 75 by default)."""
    if isinstance(source, bytes):
        data = source
    else:
        if str(source).endswith("darknet53.conv.74") and cutoff is None:
            cutoff = 75
        with open(source, "rb") as f:
            data = f.read()
    header = np.frombuffer(data[:20], dtype=np.int32).copy()
    weights = np.frombuffer(data[20:], dtype=np.float32)
    params = {}
    ptr = 0
    for idx, oc, ic, k, has_bn in conv_layer_shapes(module_defs, in_channels):
        if cutoff is not None and idx >= cutoff:
            break
        layer = {}
        names = (("bn_bias", "bn_weight", "bn_mean", "bn_var") if has_bn
                 else ("conv_bias",))
        for name in names:
            layer[name] = weights[ptr:ptr + oc].copy()
            ptr += oc
        nw = oc * ic * k * k
        layer["conv_weight"] = weights[ptr:ptr + nw].reshape(oc, ic, k, k).copy()
        ptr += nw
        params[idx] = layer
    if cutoff is None and ptr != len(weights):
        raise ValueError(f"weight file mismatch: consumed {ptr} of "
                         f"{len(weights)} floats -- cfg and weights disagree")
    return header, params


def save_darknet_weights(path: str | os.PathLike, header: np.ndarray,
                         params: Dict, module_defs: Sequence[dict],
                         in_channels: int = 3,
                         cutoff: int | None = None) -> None:
    """Serialize raw params back to the ``.weights`` byte format."""
    with open(path, "wb") as f:
        f.write(np.asarray(header, dtype=np.int32).tobytes())
        for idx, oc, ic, k, has_bn in conv_layer_shapes(module_defs,
                                                        in_channels):
            if cutoff is not None and idx >= cutoff:
                break
            layer = params[idx]
            names = (("bn_bias", "bn_weight", "bn_mean", "bn_var") if has_bn
                     else ("conv_bias",))
            for name in names:
                f.write(np.asarray(layer[name], dtype=np.float32).tobytes())
            f.write(np.asarray(layer["conv_weight"], dtype=np.float32)
                    .reshape(oc, ic, k, k).tobytes())


def random_raw_params(module_defs: Sequence[dict], in_channels: int = 3,
                      seed: int = 0) -> Dict:
    """Random raw params (He-ish scaling, identity BN): the reference
    package's, same generator and draw order."""
    rng = np.random.default_rng(seed)
    params = {}
    for idx, oc, ic, k, has_bn in conv_layer_shapes(module_defs, in_channels):
        std = float(np.sqrt(2.0 / (ic * k * k)))
        layer = {"conv_weight": rng.normal(0, std, (oc, ic, k, k)).astype(
            np.float32)}
        if has_bn:
            layer["bn_weight"] = np.ones(oc, np.float32)
            layer["bn_bias"] = np.zeros(oc, np.float32)
            layer["bn_mean"] = np.zeros(oc, np.float32)
            layer["bn_var"] = np.ones(oc, np.float32)
        else:
            layer["conv_bias"] = np.zeros(oc, np.float32)
        params[idx] = layer
    return params


def fold_inference_params(raw: Dict, module_defs: Sequence[dict],
                          in_channels: int = 3) -> Dict:
    """Fold BN into each conv and transpose OIHW -> HWIO; layers missing
    from ``raw`` (cutoff loads) are skipped."""
    out = {}
    for idx, oc, ic, k, has_bn in conv_layer_shapes(module_defs, in_channels):
        if idx not in raw:
            continue
        layer = raw[idx]
        w = np.asarray(layer["conv_weight"], np.float32)  # OIHW
        if has_bn:
            gamma = np.asarray(layer["bn_weight"], np.float32)
            beta = np.asarray(layer["bn_bias"], np.float32)
            mean = np.asarray(layer["bn_mean"], np.float32)
            var = np.asarray(layer["bn_var"], np.float32)
            scale = gamma / np.sqrt(var + BN_EPS)
            w = w * scale[:, None, None, None]
            b = beta - mean * scale
        else:
            b = np.asarray(layer["conv_bias"], np.float32)
        out[idx] = {"w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)), "b": b}
    return out


def darknet_params_from_folded(folded: Dict) -> Dict[int, Dict[str, torch.Tensor]]:
    """HWIO folded params -> {layer: {"w": OIHW f32 tensor, "b": tensor}}."""
    return {
        int(i): {
            "w": torch.from_numpy(np.ascontiguousarray(
                np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1))),
            "b": torch.from_numpy(np.asarray(p["b"], np.float32).copy()),
        }
        for i, p in folded.items()
    }


def darknet_from_raw(plan: NetworkPlan, raw: Dict) -> Darknet:
    """A float32 CPU Darknet from raw darknet-layout params (OIHW + BN)."""
    folded = fold_inference_params(raw, plan.defs(), plan.in_channels)
    model = Darknet(plan)
    model.load_params(darknet_params_from_folded(folded))
    return model.eval()


def reid_from_params(params: Dict) -> torch.nn.Module:
    """A float32 CPU ReID net from a folded HWIO param tree: the 128-d
    ``OriginalReIDNet`` when it carries the dense head, else ``ReIDNet``
    (with its classifier head when the tree has one)."""
    if "dense" in params:
        model = OriginalReIDNet()
    else:
        head = params.get("classifier")
        model = ReIDNet(None if head is None
                        else int(np.shape(head["fc2_w"])[1]))
    model.load_params(params)
    return model.eval()


def reid_int8_package_to_torch(pkg: Dict, device=None,
                               front_dtype=torch.bfloat16) -> Dict:
    """A numpy int8 package (either package's; resident or per layer) as
    the tensors the forward functions read, on ``device`` (the CUDA card
    unless another is named).

    Resident: the front's convs as OIHW weights in ``front_dtype`` with f32
    biases; ``in_scale`` as a 0-dim f32 tensor (the first quantize DIVIDES
    by it on the device; a host scalar would be turned into a multiply by
    its reciprocal on a CUDA tensor, which rounds differently); every int8
    conv's ``wq`` HWIO contiguous, on a CUDA device also ``wq_packed`` (the
    K-major rows kernel 8 reads, ``ops/conv_plan.py`` ``pack_conv_weights``:
    packed here, once), with ``scale`` and ``b`` f32; ``oinv`` and
    ``res_scale`` stay host floats (the kernel takes them by value).
    Per layer: ``wq``, ``scale`` = xscale * wscale, ``b``, and ``xscale`` as
    a 0-dim tensor."""
    device = resolve_device(device)
    if is_torch_package(pkg):
        raise ValueError("the package holds tensors already")

    def f32(v) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(v, np.float32))).to(device)

    def host(v) -> float:
        return float(np.float32(v))

    def scalar(v) -> torch.Tensor:
        return torch.full((), host(v), dtype=torch.float32, device=device)

    def wq_of(qp) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(qp["wq"], np.int8))).to(device)

    def blocks_of(layers, conv):
        return [[{name: (None if b[name] is None else conv(b[name]))
                  for name in ("conv1", "conv2", "down")}
                 | ({"res_scale": host(b["res_scale"])}
                    if "res_scale" in b else {})
                 for b in blocks] for blocks in layers]

    if "front" not in pkg:
        def per_layer(qp):
            scale = (np.float32(qp["xscale"])
                     * np.asarray(qp["wscale"], np.float32))
            return {"wq": wq_of(qp), "scale": f32(scale),
                    "b": f32(qp["b"]), "xscale": scalar(qp["xscale"])}

        return {"stem": per_layer(pkg["stem"]),
                "layers": blocks_of(pkg["layers"], per_layer)}

    def fconv(p):
        w = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)  # from HWIO
        return {"w": f32(w).to(front_dtype), "b": f32(p["b"])}

    def resident(qp):
        out = {"wq": wq_of(qp), "scale": f32(qp["scale"]),
               "b": f32(qp["b"]), "oinv": host(qp["oinv"])}
        if device.type == "cuda":
            out["wq_packed"] = pack_conv_weights(out["wq"])
        return out

    front = pkg["front"]
    return {
        "front": {"stem": fconv(front["stem"]),
                  "layers0": [{"conv1": fconv(b["conv1"]),
                               "conv2": fconv(b["conv2"])}
                              for b in front["layers0"]]},
        "in_scale": scalar(pkg["in_scale"]),
        "layers": blocks_of(pkg["layers"], resident),
    }
