"""Plain float32 ReID embed of deep_sort_pytorch (ZQPei,
``deep_sort/deep/model.py`` ``Net`` with ``reid=True``) and its crop
preprocessing (``deep_sort/deep/feature_extractor.py``: the box's integer
crop, a bilinear resize to 128 x 64, /255, ImageNet mean and std).

The net reads the public ``ckpt.t7`` state-dict layout: ``conv.0`` (3x3,
3 -> 64, with bias), ``conv.1`` (BN), ReLU, 3x3 max pool stride 2 pad 1;
``layer1`` .. ``layer4``, two BasicBlocks each (64, 128, 256, 512
channels; the first block of layers 2-4 has stride 2 and a 1x1 conv + BN
``downsample``); a global average pool and the L2 norm."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
CROP_H, CROP_W = 128, 64
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
STAGES = ((64, 64), (64, 128), (128, 256), (256, 512))
FEAT_DIM = 512


def state_dict_shapes() -> Dict[str, tuple]:
    """Every tensor of the Net's state dict (the classifier head left out)
    with its shape, in the checkpoint's key order."""
    shapes: Dict[str, tuple] = {"conv.0.weight": (64, 3, 3, 3),
                                "conv.0.bias": (64,)}
    shapes.update(_bn("conv.1", 64))
    for li, (ci, co) in enumerate(STAGES, 1):
        for bi in range(2):
            p = f"layer{li}.{bi}"
            cin = ci if bi == 0 else co
            shapes[f"{p}.conv1.weight"] = (co, cin, 3, 3)
            shapes.update(_bn(f"{p}.bn1", co))
            shapes[f"{p}.conv2.weight"] = (co, co, 3, 3)
            shapes.update(_bn(f"{p}.bn2", co))
            if bi == 0 and ci != co:
                shapes[f"{p}.downsample.0.weight"] = (co, ci, 1, 1)
                shapes.update(_bn(f"{p}.downsample.1", co))
    return shapes


def _bn(prefix: str, c: int) -> Dict[str, tuple]:
    return {f"{prefix}.{k}": (c,) for k in
            ("weight", "bias", "running_mean", "running_var")}


def conv_shapes():
    """Every conv of the Net on one 128 x 64 crop: (ci, co, k, stride,
    hin, win, hout, wout)."""
    out = [(3, 64, 3, 1, CROP_H, CROP_W, CROP_H, CROP_W)]
    h, w = CROP_H // 2, CROP_W // 2  # after the stem's max pool
    for ci, co in STAGES:
        s = 2 if ci != co else 1
        ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
        out += [(ci, co, 3, s, h, w, ho, wo), (co, co, 3, 1, ho, wo, ho, wo),
                (co, co, 3, 1, ho, wo, ho, wo), (co, co, 3, 1, ho, wo, ho, wo)]
        if s == 2:
            out.append((ci, co, 1, 2, h, w, ho, wo))
        h, w = ho, wo
    return out


def _bn_apply(x, sd, prefix):
    scale = sd[f"{prefix}.weight"] / torch.sqrt(
        sd[f"{prefix}.running_var"] + BN_EPS)
    shift = sd[f"{prefix}.bias"] - sd[f"{prefix}.running_mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def embed(sd: Dict[str, torch.Tensor], crops: torch.Tensor) -> torch.Tensor:
    """crops (N, 3, 128, 64) float32, normalized -> (N, 512) unit
    features, eval-mode BN."""
    x = F.conv2d(crops, sd["conv.0.weight"], sd["conv.0.bias"], 1, 1)
    x = F.max_pool2d(F.relu(_bn_apply(x, sd, "conv.1")), 3, 2, 1)
    for li, (ci, co) in enumerate(STAGES, 1):
        for bi in range(2):
            p = f"layer{li}.{bi}"
            s = 2 if bi == 0 and ci != co else 1
            y = F.relu(_bn_apply(F.conv2d(x, sd[f"{p}.conv1.weight"], None,
                                          s, 1), sd, f"{p}.bn1"))
            y = _bn_apply(F.conv2d(y, sd[f"{p}.conv2.weight"], None, 1, 1),
                          sd, f"{p}.bn2")
            if f"{p}.downsample.0.weight" in sd:
                x = _bn_apply(F.conv2d(x, sd[f"{p}.downsample.0.weight"],
                                       None, s), sd, f"{p}.downsample.1")
            x = F.relu(x + y)
    feat = x.mean((2, 3))
    return feat / feat.norm(dim=1, keepdim=True)


def crops(frame: torch.Tensor, boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """frame (H, W, 3) uint8, boxes (D, 4) frame xyxy -> (D, 3, 128, 64)
    float32, normalized. The crop is the box's integer pixels (corners
    truncated, x2 / y2 exclusive, at least one pixel, inside the frame),
    resized with half-pixel centres, the source coordinate clamped inside
    the crop."""
    h, w = frame.shape[0], frame.shape[1]
    b = boxes_xyxy.to(torch.int64)
    x1 = b[:, 0].clamp(0, w - 1)
    y1 = b[:, 1].clamp(0, h - 1)
    x2 = torch.minimum(torch.maximum(b[:, 2], x1 + 1), torch.tensor(w))
    y2 = torch.minimum(torch.maximum(b[:, 3], y1 + 1), torch.tensor(h))
    ys = _taps(y1, y2, CROP_H)
    xs = _taps(x1, x2, CROP_W)
    img = frame.float()
    (y0, y1i, ty), (x0, x1i, tx) = ys, xs
    r0 = img[y0[:, :, None], x0[:, None, :]] * (1 - tx[:, None, :, None]) \
        + img[y0[:, :, None], x1i[:, None, :]] * tx[:, None, :, None]
    r1 = img[y1i[:, :, None], x0[:, None, :]] * (1 - tx[:, None, :, None]) \
        + img[y1i[:, :, None], x1i[:, None, :]] * tx[:, None, :, None]
    out = r0 * (1 - ty[:, :, None, None]) + r1 * ty[:, :, None, None]
    mean = torch.tensor(MEAN, device=frame.device)
    std = torch.tensor(STD, device=frame.device)
    return ((out / 255.0 - mean) / std).permute(0, 3, 1, 2).contiguous()


def _taps(start: torch.Tensor, end: torch.Tensor, n: int):
    """Source taps (i0, i1) and the weight of i1 for n outputs over
    [start, end)."""
    dev = start.device
    span = (end - start).double()
    c = start.double()[:, None] + (torch.arange(n, device=dev).double()[None]
                                   + 0.5) / n * span[:, None] - 0.5
    c = torch.minimum(torch.maximum(c, start.double()[:, None]),
                      torch.maximum(end.double()[:, None] - 1,
                                    start.double()[:, None]))
    i0 = torch.floor(c)
    t = (c - i0).float()
    i0 = i0.long()
    i1 = torch.minimum(i0 + 1, end[:, None] - 1)
    return i0, i1, t
