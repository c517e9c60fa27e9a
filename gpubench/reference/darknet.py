"""Plain float32 darknet detector: cfg parser, letterbox, each module on its
own inputs (``module``) and the forward composed of them, YOLO decode.

Written from the darknet cfg semantics (pjreddie/darknet and
AlexeyAB/darknet) as eriklindernoren's PyTorch-YOLOv3 reads them, with
nothing of the program under test: convolution, batch norm in eval mode
(or, for the weight set-up, with its batch statistics captured), leaky /
mish / linear activations, route (with groups), shortcut, maxpool (the
2x2 stride-1 pool zero-pads right and bottom; SPP pools pad with -inf),
nearest upsample and the YOLO decode with ``scale_x_y``. Layout NCHW,
float32, TF32 off (the caller's ``f32_exact``)."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


@contextlib.contextmanager
def f32_exact():
    """float32 matrix products and convolutions without TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def parse_cfg(text: str) -> List[Dict[str, str]]:
    """Darknet cfg text -> sections, [net] first: {"type": ..., key:
    value}."""
    defs: List[Dict[str, str]] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("["):
            defs.append({"type": line[1:-1].strip()})
            if defs[-1]["type"] == "convolutional":
                defs[-1]["batch_normalize"] = "0"
        else:
            key, value = line.split("=", 1)
            defs[-1][key.strip()] = value.strip()
    return defs


def conv_shapes(defs: Sequence[Dict[str, str]], img_size: int):
    """Every conv of the net (defs without [net]) at a square input of
    ``img_size``: dicts of module index, ci, co, k, stride, hin, win,
    hout, wout, bn. Follows the feature-map shapes through every module
    type the forward knows."""
    shapes: List[tuple] = []  # per module: (channels, h, w)
    convs = []
    c, h, w = 3, img_size, img_size
    for i, d in enumerate(defs):
        t = d["type"]
        if t == "convolutional":
            k, s = int(d["size"]), int(d.get("stride", 1))
            pad = (k - 1) // 2 if int(d.get("pad", 0)) else 0
            co = int(d["filters"])
            ho, wo = (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1
            convs.append(dict(index=i, ci=c, co=co, k=k, stride=s,
                              hin=h, win=w, hout=ho, wout=wo,
                              bn=bool(int(d.get("batch_normalize", 0)))))
            c, h, w = co, ho, wo
        elif t == "maxpool":
            k, s = int(d["size"]), int(d["stride"])
            if not (k == 2 and s == 1):  # that one keeps its size
                pad = (k - 1) // 2
                h, w = (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1
        elif t == "upsample":
            h, w = h * int(d["stride"]), w * int(d["stride"])
        elif t == "route":
            srcs = [shapes[_ref(int(l), i)] for l in d["layers"].split(",")]
            c = sum(x[0] for x in srcs) // int(d.get("groups", 1))
            h, w = srcs[0][1], srcs[0][2]
        elif t in ("shortcut", "yolo"):
            pass
        else:
            raise ValueError(f"unknown module type {t!r}")
        shapes.append((c, h, w))
    return convs


def _ref(layer: int, i: int) -> int:
    return layer if layer >= 0 else i + layer


def _head(d: Dict[str, str]):
    """A [yolo] section -> (its anchors [(w, h)], classes, scale_x_y)."""
    flat = [float(a) for a in d["anchors"].split(",")]
    pairs = [(flat[2 * j], flat[2 * j + 1]) for j in range(len(flat) // 2)]
    mask = [int(m) for m in d["mask"].split(",")]
    return ([pairs[m] for m in mask], int(d["classes"]),
            float(d.get("scale_x_y", 1.0)))


def yolo_heads(defs: Sequence[Dict[str, str]]):
    """[(module index, anchors [(w, h)], classes, scale_x_y)] per [yolo]."""
    return [(i,) + _head(d) for i, d in enumerate(defs)
            if d["type"] == "yolo"]


def letterbox(frames: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, size, size) float32 in [0, 1]: zero pad
    to a square (the short side gets d // 2 before, the rest after), then
    a bilinear resize with half-pixel centres and no antialiasing."""
    b, h, w, _ = frames.shape
    d = abs(h - w)
    p1, p2 = d // 2, d - d // 2
    x = frames.permute(0, 3, 1, 2).float() / 255.0
    pad = (0, 0, p1, p2) if h <= w else (p1, p2, 0, 0)
    x = F.pad(x, pad)
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=False)


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "leaky":
        return F.leaky_relu(x, 0.1)
    if name == "mish":
        return x * torch.tanh(F.softplus(x))
    if name == "linear":
        return x
    raise ValueError(f"unknown activation {name!r}")


def decode(raw: torch.Tensor, anchors, classes: int, img_size: int,
           scale_x_y: float) -> torch.Tensor:
    """(N, A*(5+C), G, G) -> (N, A*G*G, 5+C): centre boxes in input
    pixels, sigmoid objectness and class scores."""
    n, _, g, _ = raw.shape
    a = len(anchors)
    stride = img_size / g
    p = raw.reshape(n, a, 5 + classes, g, g).permute(0, 1, 3, 4, 2)
    gy, gx = torch.meshgrid(torch.arange(g, device=raw.device),
                            torch.arange(g, device=raw.device), indexing="ij")
    anc = torch.tensor(anchors, dtype=torch.float32,
                       device=raw.device) / stride
    off = 0.5 * (scale_x_y - 1.0)
    bx = torch.sigmoid(p[..., 0]) * scale_x_y - off + gx
    by = torch.sigmoid(p[..., 1]) * scale_x_y - off + gy
    bw = torch.exp(p[..., 2]) * anc[None, :, 0, None, None]
    bh = torch.exp(p[..., 3]) * anc[None, :, 1, None, None]
    boxes = torch.stack([bx, by, bw, bh], -1) * stride
    out = torch.cat([boxes, torch.sigmoid(p[..., 4:])], -1)
    return out.reshape(n, a * g * g, 5 + classes)


def fake_int8(t: torch.Tensor, dims) -> torch.Tensor:
    """Round to int8 codes with a symmetric scale (the largest magnitude
    over all but ``dims`` / 127) and back: W8A8's rounding."""
    amax = t.abs().amax(dim=dims, keepdim=True) if dims else t.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return torch.clamp(torch.round(t / scale), -127, 127) * scale


def sources(defs: Sequence[Dict[str, str]], i: int) -> List[int]:
    """The modules whose outputs module ``i`` reads, in the order it reads
    them (-1: the net's input): the previous one, a route's layers, or a
    shortcut's previous one and its ``from``."""
    d = defs[i]
    if d["type"] == "route":
        return [_ref(int(l), i) for l in d["layers"].split(",")]
    if d["type"] == "shortcut":
        return [i - 1, _ref(int(d["from"]), i)]
    return [i - 1]


def module(defs: Sequence[Dict[str, str]], params: Dict[int, Dict], i: int,
           inputs: Sequence[torch.Tensor], img_size: int,
           capture_bn: bool = False, int8: bool = False) -> torch.Tensor:
    """Module ``i`` of the net on its ``inputs`` (NCHW, the outputs of
    ``sources(defs, i)``) -> its output, or for a [yolo] module the decoded
    rows (N, A*G*G, 5+C) of its input. ``params``, ``capture_bn`` and
    ``int8`` as ``forward`` takes them."""
    d = defs[i]
    t = d["type"]
    prev = inputs[0]
    if t == "convolutional":
        p = params[i]
        k = int(d["size"])
        pad = (k - 1) // 2 if int(d.get("pad", 0)) else 0
        w = p["conv_weight"]
        if int8:  # per-tensor activations, per-output-channel weights
            prev, w = fake_int8(prev, None), fake_int8(w, (1, 2, 3))
        y = F.conv2d(prev, w, None, int(d.get("stride", 1)), pad)
        if int(d.get("batch_normalize", 0)):
            if capture_bn:
                p["bn_mean"] = torch.zeros_like(p["bn_mean"])
                p["bn_var"] = (y * y).mean((0, 2, 3))
            scale = p["bn_weight"] / torch.sqrt(p["bn_var"] + BN_EPS)
            y = ((y - p["bn_mean"][None, :, None, None])
                 * scale[None, :, None, None]
                 + p["bn_bias"][None, :, None, None])
        else:
            y = y + p["conv_bias"][None, :, None, None]
        return _act(y, d.get("activation", "linear"))
    if t == "maxpool":
        k, s = int(d["size"]), int(d["stride"])
        if k == 2 and s == 1:
            return F.max_pool2d(F.pad(prev, (0, 1, 0, 1)), 2, 1)
        return F.max_pool2d(prev, k, s, (k - 1) // 2)
    if t == "upsample":
        return F.interpolate(prev, scale_factor=int(d["stride"]),
                             mode="nearest")
    if t == "route":
        out = torch.cat(list(inputs), 1)
        groups = int(d.get("groups", 1))
        if groups > 1:
            gc = out.shape[1] // groups
            gid = int(d.get("group_id", 0))
            out = out[:, gid * gc:(gid + 1) * gc]
        return out
    if t == "shortcut":
        return prev + inputs[1]
    if t == "yolo":
        anchors, classes, sxy = _head(d)
        return decode(prev, anchors, classes, img_size, sxy)
    raise ValueError(f"unknown module type {t!r}")


def forward(defs: Sequence[Dict[str, str]], params: Dict[int, Dict],
            x: torch.Tensor, img_size: int, capture_bn: bool = False,
            int8: bool = False):
    """Run the net (defs without [net]) on x (N, 3, S, S) float32, module
    by module (``module``).

    ``params[i]``: "conv_weight" (OIHW) and either the BN tensors
    "bn_weight", "bn_bias", "bn_mean", "bn_var" or "conv_bias". With
    ``capture_bn`` every BN normalizes with its batch's own statistics,
    uncentered (mean 0, variance the mean square over N, H, W), and writes
    them into ``params`` as its running statistics, so the eval forward of
    the returned weights reproduces this pass. ``int8`` rounds
    every conv's input and weights to int8 codes (the lower-precision
    control of the detector). -> (N, boxes, 5+C) decoded rows."""
    reads = [sources(defs, i) for i in range(len(defs))]
    keep = {j for i, r in enumerate(reads) for j in r if j != i - 1}
    outs: List[torch.Tensor] = []  # only the outputs a later module reads
    decoded = []
    prev = x
    for i, d in enumerate(defs):
        ins = [prev if j == i - 1 else outs[j] for j in reads[i]]
        out = module(defs, params, i, ins, img_size, capture_bn, int8)
        if d["type"] == "yolo":  # the head's map passes through
            decoded.append(out)
            out = prev
        outs.append(out if i in keep else None)
        prev = out
    return torch.cat(decoded, 1)
