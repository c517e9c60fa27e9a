"""cfg-driven darknet detector as an ``nn.Module`` (port of
yolo_deepsort_tpu/models/darknet.py).

``build_network`` and ``conv_layer_shapes`` are pure-Python copies of the
reference package's cfg walks (the port imports nothing of the JAX
package). ``Darknet`` is its
``network_apply``: convolutions (BN folded into weight and bias), route with
groups, shortcut, maxpool with the k2s1 zero-pad special case, nearest
upsample, leaky/mish/linear, and the YOLO decode. Public layout is the
reference's: NHWC input in [0, 1], (N, boxes, 5+C) decoded output.
Internally the convolutions run NCHW, and an NHWC input is handed to them
as its channels_last NCHW view (the same bytes), so a channels_last model
reads the letterbox kernel's output without a copy.

A bf16 model rounds where the reference's bf16 forward rounds: each conv
sums in f32, adds its f32 bias, activates in f32 and rounds to bf16 once
(``models/layers.conv_layer_bf16``: kernel 7 on the card, its plain
version on the CPU). A float32 model runs the library conv.

While a torch profiler records, the forward opens one range per module
inside ``ydt.detector``, named by its kind (``module_span``): a conv by its
activation (``ydt.det.conv.mish`` / ``.leaky`` / ``.linear``), the others
by type (``ydt.det.maxpool``, ``.route``, ``.upsample``, ``.shortcut``,
``.yolo``); a span of modules that a ``block_impl`` claims is one
``ydt.det.block`` range, opened by the route that claims it. Whether a
profiler records is checked once a forward; with none, no range is built.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.decode import yolo_decode
from ..utils.profiling import recording, span
from .layers import Conv2d, conv_layer_bf16


BLOCK_SPAN = "ydt.det.block"


def module_span(mdef: Dict[str, str]) -> str:
    """The profiler range of a module, by kind: ``ydt.det.conv.<act>`` for a
    conv (``linear`` when it names none), ``ydt.det.<type>`` otherwise."""
    if mdef["type"] == "convolutional":
        return "ydt.det.conv." + (mdef.get("activation") or "linear")
    return "ydt.det." + mdef["type"]


def conv_layer_shapes(module_defs: Sequence[dict], in_channels: int = 3
                      ) -> List[Tuple[int, int, int, int, bool]]:
    """(module_index, out_c, in_c, kernel, has_bn) per conv layer, walking
    the channel bookkeeping of the darknet module list."""
    output_filters = [in_channels]
    shapes = []
    for i, mdef in enumerate(module_defs):
        t = mdef["type"]
        if t == "convolutional":
            filters = int(mdef["filters"])
            shapes.append((i, filters, output_filters[-1], int(mdef["size"]),
                           bool(int(mdef.get("batch_normalize", 0)))))
        elif t == "route":
            layers = [int(x) for x in str(mdef["layers"]).split(",")]
            filters = sum(
                output_filters[l + 1 if l >= 0 else len(output_filters) + l]
                for l in layers)
            groups = int(mdef.get("groups", 1))
            if groups > 1:
                filters //= groups
        elif t == "shortcut":
            frm = int(mdef["from"])
            filters = output_filters[
                frm + 1 if frm >= 0 else len(output_filters) + frm]
        elif t in ("maxpool", "upsample", "yolo"):
            filters = output_filters[-1]
        else:
            raise ValueError(f"unknown module type {t!r}")
        output_filters.append(filters)
    return shapes


@dataclasses.dataclass(frozen=True)
class YoloHeadSpec:
    module_index: int
    anchors: Tuple[Tuple[float, float], ...]  # mask-selected, pixels
    num_classes: int
    scale_x_y: float


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """Static description of a darknet network."""

    module_defs: Tuple[Tuple[Tuple[str, str], ...], ...]
    img_size: int
    in_channels: int
    num_classes: int
    heads: Tuple[YoloHeadSpec, ...]
    keep: frozenset  # module indices whose outputs are referenced later

    def defs(self) -> List[Dict[str, str]]:
        return [dict(items) for items in self.module_defs]


def _resolve(ref: int, current: int) -> int:
    return ref if ref >= 0 else current + ref


def build_network(module_defs: Sequence[dict],
                  img_size: Optional[int] = None) -> NetworkPlan:
    """Build a plan from parsed cfg sections (with or without [net])."""
    defs = [dict(d) for d in module_defs]
    net_info: Dict[str, str] = {}
    if defs and defs[0]["type"] == "net":
        net_info = defs.pop(0)
    if img_size is None:
        img_size = int(net_info.get("width", 416))
    in_channels = int(net_info.get("channels", 3))

    keep = set()
    heads = []
    num_classes = 0
    for i, mdef in enumerate(defs):
        t = mdef["type"]
        if t == "route":
            for l in str(mdef["layers"]).split(","):
                keep.add(_resolve(int(l), i))
        elif t == "shortcut":
            keep.add(_resolve(int(mdef["from"]), i))
            keep.add(i - 1)
        elif t == "yolo":
            mask = [int(x) for x in str(mdef["mask"]).split(",")]
            flat = [float(x) for x in str(mdef["anchors"]).split(",")]
            all_anchors = [(flat[2 * j], flat[2 * j + 1])
                           for j in range(len(flat) // 2)]
            num_classes = int(mdef["classes"])
            heads.append(YoloHeadSpec(
                module_index=i,
                anchors=tuple(all_anchors[m] for m in mask),
                num_classes=num_classes,
                scale_x_y=float(mdef.get("scale_x_y", 1.0)),
            ))

    return NetworkPlan(
        module_defs=tuple(tuple(sorted(d.items())) for d in defs),
        img_size=img_size,
        in_channels=in_channels,
        num_classes=num_classes,
        heads=tuple(heads),
        keep=frozenset(keep),
    )


def _activate(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "leaky":
        return torch.where(x > 0, x, 0.1 * x)
    if act == "mish":
        return x * torch.tanh(torch.logaddexp(torch.zeros_like(x), x))
    if act in ("linear", ""):
        return x
    raise ValueError(f"unknown activation {act!r}")


class Darknet(nn.Module):
    """The detector of ``plan``. Conv layers are ``layers.Conv2d`` with
    bias (BN folded; the bias stays float32 in a bf16 model); load weights
    with ``load_params`` (see ``weights.py``). Cast the module to the
    compute dtype and channels_last with ``.to``."""

    def __init__(self, plan: NetworkPlan):
        super().__init__()
        self.plan = plan
        self._defs = plan.defs()
        self._heads = {h.module_index: h for h in plan.heads}
        self._spans = [module_span(d) for d in self._defs]
        self.convs = nn.ModuleDict()
        for idx, oc, ic, k, _ in conv_layer_shapes(self._defs,
                                                   plan.in_channels):
            mdef = self._defs[idx]
            stride = int(mdef.get("stride", 1))
            pad = (k - 1) // 2 if int(mdef.get("pad", 0)) else 0
            self.convs[str(idx)] = Conv2d(ic, oc, k, stride, pad, bias=True)

    @torch.no_grad()
    def load_params(self, params: Dict[int, Dict[str, torch.Tensor]]) -> None:
        """Copy {layer: {"w": OIHW, "b": (oc,)}} into the conv layers."""
        for key, conv in self.convs.items():
            p = params[int(key)]
            conv.weight.copy_(torch.as_tensor(p["w"]))
            conv.bias.copy_(torch.as_tensor(p["b"]))

    def forward(self, x: torch.Tensor, capture_all_layers: bool = False,
                conv_impl=None, block_impl=None):
        """x: (N, S, S, 3) NHWC in [0, 1] -> (N, boxes, 5+C) float32
        detections (centre format, input pixels, sigmoided scores). With
        ``capture_all_layers`` also returns every layer's output (NHWC for
        feature maps, decoded rows for yolo layers).

        ``conv_impl(x, w, b, stride, pad, act, layer_idx)`` may claim a conv
        layer (conv + bias + activation fused, e.g. the int8 mode of the
        tensor-core kernel of ``ops/conv_kernel.py``) by returning its NHWC
        output, or return None for the default: ``conv_layer_bf16`` in a
        bf16 model, the library conv in a float32 one. It sees the
        reference's layouts: ``x`` NHWC and ``w`` HWIO, both views of the
        module's own tensors (of a channels_last model's memory as it lies,
        so nothing is copied).

        ``block_impl(x, convs, layer_idx)`` is consulted first at every
        module index and may claim a SPAN of modules starting there (e.g.
        the fused residual chains of ``ops/resblock_kernel.py``) by
        returning ``(out, consumed)``, ``out`` the NHWC output of the last
        claimed module; its factory guarantees that nothing outside the
        span references the outputs in between. ``x`` is the NHWC view of
        the module's input, ``convs`` this module's conv layers. Ignored
        under ``capture_all_layers`` (every layer's output is wanted). A
        route that claims a span opens ``BLOCK_SPAN`` around its work."""
        with span("ydt.detector"):
            return self._forward(x, capture_all_layers, conv_impl,
                                 block_impl)

    def _forward(self, x, capture_all_layers, conv_impl, block_impl):
        dtype = next(self.parameters()).dtype
        prev = x.to(dtype).permute(0, 3, 1, 2)  # channels_last NCHW view
        cache: Dict[int, torch.Tensor] = {}
        outputs = []
        all_layers = []
        if capture_all_layers:
            block_impl = None
        traced = recording()  # once a forward, not once a module
        i = 0
        while i < len(self._defs):
            if block_impl is not None and prev.dim() == 4:  # a feature map
                res = block_impl(prev.permute(0, 2, 3, 1), self.convs, i)
                if res is not None:
                    out, consumed = res
                    prev = out.permute(0, 3, 1, 2).to(dtype)
                    i += consumed
                    if i - 1 in self.plan.keep:
                        cache[i - 1] = prev
                    continue
            if traced:
                with torch.profiler.record_function(self._spans[i]):
                    out = self._module(i, prev, cache, conv_impl, dtype)
            else:
                out = self._module(i, prev, cache, conv_impl, dtype)
            if self._defs[i]["type"] == "yolo":
                outputs.append(out)
            if i in self.plan.keep:
                cache[i] = out
            if capture_all_layers:
                all_layers.append(out if self._defs[i]["type"] == "yolo"
                                  else out.permute(0, 2, 3, 1))
            prev = out
            i += 1
        detections = torch.cat(outputs, 1) if outputs else None
        if capture_all_layers:
            return detections, all_layers
        return detections

    def _module(self, i, prev, cache, conv_impl, dtype):
        """Module i's output from its input ``prev`` (NCHW) and the kept
        outputs ``cache``; a [yolo] module's decoded rows."""
        mdef = self._defs[i]
        t = mdef["type"]
        if t == "convolutional":
            conv = self.convs[str(i)]
            act = mdef.get("activation", "linear")
            if conv_impl is not None:
                out = conv_impl(prev.permute(0, 2, 3, 1),
                                conv.weight.permute(2, 3, 1, 0), conv.bias,
                                conv.stride[0], conv.padding[0], act, i)
                if out is not None:
                    return out.permute(0, 3, 1, 2).to(dtype)
            if dtype == torch.bfloat16:
                return conv_layer_bf16(conv, prev.permute(0, 2, 3, 1),
                                       act).permute(0, 3, 1, 2)
            return _activate(conv(prev), act)
        if t == "maxpool":
            k, stride = int(mdef["size"]), int(mdef["stride"])
            if k == 2 and stride == 1:
                # reference special case: ZeroPad2d((0, 1, 0, 1)), then an
                # unpadded pool
                return F.max_pool2d(F.pad(prev, (0, 1, 0, 1)), 2, 1)
            return F.max_pool2d(prev, k, stride, (k - 1) // 2)
        if t == "upsample":
            return F.interpolate(prev, scale_factor=int(mdef["stride"]),
                                 mode="nearest")
        if t == "route":
            layers = [_resolve(int(l), i)
                      for l in str(mdef["layers"]).split(",")]
            parts = [cache[l] for l in layers]
            out = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
            groups = int(mdef.get("groups", 1))
            if groups > 1:
                gid = int(mdef.get("group_id", 0))
                gc = out.shape[1] // groups
                out = out[:, gid * gc:(gid + 1) * gc]
            return out
        if t == "shortcut":
            return cache[i - 1] + cache[_resolve(int(mdef["from"]), i)]
        if t == "yolo":
            spec = self._heads[i]
            return yolo_decode(prev.permute(0, 2, 3, 1), spec.anchors,
                               spec.num_classes, self.plan.img_size,
                               spec.scale_x_y)
        raise ValueError(f"unknown module type {t!r}")
