"""DeepSORT ReID embedding nets as ``nn.Module``s (port of
yolo_deepsort_tpu/models/reid.py ``reid_apply``).

Input (N, 128, 64, 3) NHWC crops, already /255 and ImageNet-normalized.

``ReIDNet``, the reference's default deep/model.py Net, (N, 512) features:
  stem: conv3x3 3->64 + ReLU + maxpool(3, stride 2, pad 1)
  4 stages of 2 BasicBlocks (64->64, 64->128, 128->256, 256->512; the
  first block of a channel-changing stage has stride 2 and a 1x1
  projection shortcut), ReLU after the residual add
  global average pool -> L2 normalize.
With ``num_classes`` it carries the classifier head (fc1 512 -> 256,
BN1d, ReLU, fc2; ``forward(classify=True)`` gives its logits, in float32).
``OriginalReIDNet``, deep/original_model.py (the mars-small128 layout),
(N, 128) features: two ELU stem convs 3->32->32 + maxpool, three stages of
2 ELU BasicBlocks (32->32, 32->64, 64->128), the NCHW flatten of the
(128, 16, 8) map, a dense 16384 -> 128 layer in float32, L2 normalize.
BN is folded into every conv (weight and bias).

A bf16 net rounds where the reference's ``reid_apply`` / ``_original_apply``
round: each conv sums in f32 and adds its f32 bias; the stems and each
block's first conv activate in f32 and round once (kernel 7's ReLU and ELU
codes on the card, ``models/layers.conv_layer_bf16``); a projection
shortcut stays f32 (kernel 7's f32-output form), and a block's second conv
takes ``act((y + b) + shortcut)`` in f32 (an identity shortcut is the bf16
input, exact in f32) and rounds once, all in its epilogue (kernel 7's
residual form).

The loaders are numpy copies of the reference package's: the reference's
``ckpt.t7`` state-dicts (either layout) and the package's own ``.npz``
training checkpoints map to the same folded HWIO param trees.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, KeepsF32, Linear, conv_layer_bf16

BN_EPS = 1e-5
STAGES = [(64, 64, False), (64, 128, True), (128, 256, True), (256, 512, True)]
FEAT_DIM = 512
ORIGINAL_STAGES = [(32, 32, False), (32, 64, True), (64, 128, True)]
ORIGINAL_FEAT_DIM = 128


def random_reid_params(seed: int = 0,
                       num_classes: Optional[int] = None) -> Dict:
    """Random folded params, HWIO -- a numpy twin of the reference
    package's ``random_reid_params`` (same generator, same draw order, so
    the same seed gives the same arrays); ``num_classes`` adds the
    classifier head (fc1 512 -> 256, BN1d, fc2 256 -> classes)."""
    rng = np.random.default_rng(seed)

    def conv(ci, co, k):
        std = np.sqrt(2.0 / (ci * k * k))
        return {
            "w": rng.normal(0, std, (k, k, ci, co)).astype(np.float32),
            "b": rng.normal(0, 0.1, co).astype(np.float32),
        }

    params: Dict = {"stem": conv(3, 64, 3), "layers": []}
    for ci, co, down in STAGES:
        blocks = []
        for bi in range(2):
            first = bi == 0
            blocks.append({
                "conv1": conv(ci if first else co, co, 3),
                "conv2": conv(co, co, 3),
                "down": (conv(ci, co, 1) if (first and (down or ci != co))
                         else None),
            })
        params["layers"].append(blocks)
    if num_classes:
        params["classifier"] = {
            "fc1_w": rng.normal(0, 0.05, (512, 256)).astype(np.float32),
            "fc1_b": np.zeros(256, np.float32),
            "bn_w": np.ones(256, np.float32),
            "bn_b": np.zeros(256, np.float32),
            "bn_m": np.zeros(256, np.float32),
            "bn_v": np.ones(256, np.float32),
            "fc2_w": rng.normal(0, 0.05, (256, num_classes)).astype(
                np.float32),
            "fc2_b": np.zeros(num_classes, np.float32),
        }
    return params


def random_original_reid_params(seed: int = 0) -> Dict:
    """Random folded params in the original_model.py layout -- a numpy twin
    of the reference package's (same generator, same draw order)."""
    rng = np.random.default_rng(seed)

    def conv(ci, co, k):
        std = np.sqrt(2.0 / (ci * k * k))
        return {
            "w": rng.normal(0, std, (k, k, ci, co)).astype(np.float32),
            "b": rng.normal(0, 0.1, co).astype(np.float32),
        }

    params: Dict = {"stem": conv(3, 32, 3), "stem2": conv(32, 32, 3),
                    "layers": []}
    for ci, co, down in ORIGINAL_STAGES:
        blocks = []
        for bi in range(2):
            first = bi == 0
            blocks.append({
                "conv1": conv(ci if first else co, co, 3),
                "conv2": conv(co, co, 3),
                "down": (conv(ci, co, 1) if (first and (down or ci != co))
                         else None),
            })
        params["layers"].append(blocks)
    params["dense"] = {
        "w": rng.normal(0, 0.01, (128 * 16 * 8, 128)).astype(np.float32),
        "b": np.zeros(128, np.float32),
    }
    return params


def feat_dim_of(params: Dict) -> int:
    """Embedding width of a ReID param tree: 128 for the original_model.py
    layout, 512 for the default Net."""
    return ORIGINAL_FEAT_DIM if "dense" in params else FEAT_DIM


def _fold(conv_w_oihw, bn_w, bn_b, bn_m, bn_v, conv_b=None):
    scale = bn_w / np.sqrt(bn_v + BN_EPS)
    w = conv_w_oihw * scale[:, None, None, None]
    pre = conv_b if conv_b is not None else 0.0  # the stem conv's own bias
    b = bn_b + (pre - bn_m) * scale
    return {
        "w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)).astype(np.float32),
        "b": b.astype(np.float32),
    }


def _state_dict_folder(sd: Dict[str, np.ndarray]):
    def fold(prefix_conv, prefix_bn):
        return _fold(sd[f"{prefix_conv}.weight"], sd[f"{prefix_bn}.weight"],
                     sd[f"{prefix_bn}.bias"], sd[f"{prefix_bn}.running_mean"],
                     sd[f"{prefix_bn}.running_var"],
                     conv_b=sd.get(f"{prefix_conv}.bias"))
    return fold


def _state_dict_layers(sd, fold, n_stages: int) -> List:
    layers = []
    for li in range(1, n_stages + 1):
        blocks = []
        for bi in range(2):
            p = f"layer{li}.{bi}"
            blocks.append({
                "conv1": fold(f"{p}.conv1", f"{p}.bn1"),
                "conv2": fold(f"{p}.conv2", f"{p}.bn2"),
                "down": (fold(f"{p}.downsample.0", f"{p}.downsample.1")
                         if f"{p}.downsample.0.weight" in sd else None),
            })
        layers.append(blocks)
    return layers


def params_from_state_dict(sd: Dict[str, np.ndarray]) -> Dict:
    """The reference Net's state-dict -> folded params."""
    fold = _state_dict_folder(sd)
    params: Dict = {"stem": fold("conv.0", "conv.1"),
                    "layers": _state_dict_layers(sd, fold, 4)}
    if "classifier.0.weight" in sd:
        params["classifier"] = {
            "fc1_w": sd["classifier.0.weight"].T.astype(np.float32),
            "fc1_b": sd["classifier.0.bias"].astype(np.float32),
            "bn_w": sd["classifier.1.weight"].astype(np.float32),
            "bn_b": sd["classifier.1.bias"].astype(np.float32),
            "bn_m": sd["classifier.1.running_mean"].astype(np.float32),
            "bn_v": sd["classifier.1.running_var"].astype(np.float32),
            "fc2_w": sd["classifier.4.weight"].T.astype(np.float32),
            "fc2_b": sd["classifier.4.bias"].astype(np.float32),
        }
    return params


def original_params_from_state_dict(sd: Dict[str, np.ndarray]) -> Dict:
    """The original_model.py state-dict -> folded params."""
    fold = _state_dict_folder(sd)
    return {
        "stem": fold("conv.0", "conv.1"),
        "stem2": fold("conv.3", "conv.4"),
        "layers": _state_dict_layers(sd, fold, 3),
        "dense": {"w": sd["dense.1.weight"].T.astype(np.float32),
                  "b": sd["dense.1.bias"].astype(np.float32)},
    }


def fold_train_params(params: Dict, stats: Dict) -> Dict:
    """Fold train-layout ReID params (HWIO convs + explicit BN gamma/beta,
    with running stats) into inference params."""

    def fold(p, st):
        scale = (np.asarray(p["bn"]["gamma"], np.float32)
                 / np.sqrt(np.asarray(st["var"], np.float32) + BN_EPS))
        w = np.asarray(p["w"], np.float32) * scale  # HWIO: scale over O
        pre = np.asarray(p.get("b", 0.0), np.float32)
        b = (np.asarray(p["bn"]["beta"], np.float32)
             + (pre - np.asarray(st["mean"], np.float32)) * scale)
        return {"w": w.astype(np.float32), "b": b.astype(np.float32)}

    out: Dict = {"stem": fold(params["stem"], stats["stem"]), "layers": []}
    for blocks, sblocks in zip(params["layers"], stats["layers"]):
        out["layers"].append([{
            "conv1": fold(block["conv1"], sblock["conv1"]),
            "conv2": fold(block["conv2"], sblock["conv2"]),
            "down": (fold(block["down"], sblock["down"])
                     if block["down"] is not None else None),
        } for block, sblock in zip(blocks, sblocks)])
    if "classifier" in params:
        c, sc = params["classifier"], stats["classifier"]
        out["classifier"] = {
            "fc1_w": np.asarray(c["fc1_w"], np.float32),
            "fc1_b": np.asarray(c["fc1_b"], np.float32),
            "bn_w": np.asarray(c["bn"]["gamma"], np.float32),
            "bn_b": np.asarray(c["bn"]["beta"], np.float32),
            "bn_m": np.asarray(sc["mean"], np.float32),
            "bn_v": np.asarray(sc["var"], np.float32),
            "fc2_w": np.asarray(c["fc2_w"], np.float32),
            "fc2_b": np.asarray(c["fc2_b"], np.float32),
        }
    return out


def load_reid_checkpoint(path: str | os.PathLike) -> Dict:
    """A ReID checkpoint -> folded params: the package's ``.npz`` training
    checkpoint (BN folded here), or the reference's ``ckpt.t7`` (a torch
    pickle with the state-dict under 'net_dict'; either net layout)."""
    if str(path).endswith(".npz"):
        from ..utils.checkpoint import load_reid_checkpoint_npz

        ck = load_reid_checkpoint_npz(path)
        return fold_train_params(ck["net_dict"], ck["stats"])
    state = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.numpy() for k, v in state["net_dict"].items()}
    if "dense.1.weight" in sd:
        return original_params_from_state_dict(sd)
    return params_from_state_dict(sd)


_ACTS = {"relu": F.relu, "elu": F.elu}


class BasicBlock(nn.Module):
    def __init__(self, ci: int, co: int, downsample: bool,
                 act: str = "relu"):
        super().__init__()
        stride = 2 if downsample and ci != co else 1
        self.act_name = act
        self.act = _ACTS[act]
        self.conv1 = Conv2d(ci, co, 3, stride, 1)
        self.conv2 = Conv2d(co, co, 3, 1, 1)
        self.down = Conv2d(ci, co, 1, stride, 0) if downsample else None

    def forward(self, x):
        """float32 NCHW (a bf16 net calls ``forward_bf16``)."""
        y = self.act(self.conv1(x))
        y = self.conv2(y)
        shortcut = self.down(x) if self.down is not None else x
        return self.act(y + shortcut)

    def forward_bf16(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, Ci) bf16 NHWC -> (N, Ho, Wo, Co) bf16 NHWC: conv2 and
        the shortcut (the bf16 input, or the projection's f32 output)
        summed in f32, activated, rounded once, all in conv2's epilogue."""
        y = conv_layer_bf16(self.conv1, x, self.act_name)
        shortcut = (x if self.down is None else
                    conv_layer_bf16(self.down, x, "linear", torch.float32))
        return conv_layer_bf16(self.conv2, y, self.act_name,
                               residual=shortcut)


def _maxpool_nhwc(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 max pool of an NHWC tensor, NHWC contiguous."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(
        0, 2, 3, 1).contiguous()


def _put_conv(conv: nn.Conv2d, p) -> None:
    """Copy one folded HWIO {"w", "b"} conv into an OIHW ``nn.Conv2d``."""
    conv.weight.copy_(torch.as_tensor(
        np.ascontiguousarray(np.asarray(p["w"]).transpose(3, 2, 0, 1))))
    conv.bias.copy_(torch.as_tensor(np.asarray(p["b"])))


def _put_blocks(blocks: nn.Sequential, layers) -> None:
    flat = [blk for stage in layers for blk in stage]
    if len(flat) != len(blocks):
        raise ValueError(f"expected {len(blocks)} blocks, got {len(flat)}")
    for mod, p in zip(blocks, flat):
        _put_conv(mod.conv1, p["conv1"])
        _put_conv(mod.conv2, p["conv2"])
        if (mod.down is None) != (p["down"] is None):
            raise ValueError("projection shortcut layout mismatch")
        if mod.down is not None:
            _put_conv(mod.down, p["down"])


class ReIDClassifier(KeepsF32, nn.Module):
    """The classifier head of the reference Net in eval mode: fc1 512 ->
    256, BatchNorm1d on its running statistics, ReLU, fc2 -> classes, in
    float32 whatever the net's dtype (as ``reid_apply(classify=True)``)."""

    F32 = ("bn_w", "bn_b", "bn_m", "bn_v")

    def __init__(self, num_classes: int):
        super().__init__()
        self.fc1 = Linear(FEAT_DIM, 256)
        self.fc2 = Linear(256, num_classes)
        for name, v in (("bn_w", 1.0), ("bn_b", 0.0), ("bn_m", 0.0),
                        ("bn_v", 1.0)):
            self.register_buffer(name, torch.full((256,), v))

    @torch.no_grad()
    def load_params(self, c: Dict) -> None:
        """The folded tree's ``classifier`` entry: fc weights (in, out)."""
        for lin, w, b in ((self.fc1, "fc1_w", "fc1_b"),
                          (self.fc2, "fc2_w", "fc2_b")):
            lin.weight.copy_(torch.as_tensor(
                np.ascontiguousarray(np.asarray(c[w], np.float32).T)))
            lin.bias.copy_(torch.as_tensor(np.asarray(c[b], np.float32)))
        for name in ("bn_w", "bn_b", "bn_m", "bn_v"):
            getattr(self, name).copy_(torch.as_tensor(
                np.asarray(c[name], np.float32)))

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        """(N, 512) float32 pooled features -> (N, classes) logits."""
        h = F.linear(feat, self.fc1.weight, self.fc1.bias)
        scale = self.bn_w / torch.sqrt(self.bn_v + BN_EPS)
        h = torch.relu((h - self.bn_m) * scale + self.bn_b)
        return F.linear(h, self.fc2.weight, self.fc2.bias)


class ReIDNet(nn.Module):
    """The 512-d ReID Net; load folded params with ``load_params``.
    ``num_classes`` adds the classifier head (``forward(classify=True)``)."""

    def __init__(self, num_classes: Optional[int] = None):
        super().__init__()
        self.stem = Conv2d(3, 64, 3, 1, 1)
        blocks = []
        for ci, co, down in STAGES:
            blocks.append(BasicBlock(ci, co, down or ci != co))
            blocks.append(BasicBlock(co, co, False))
        self.blocks = nn.Sequential(*blocks)
        self.classifier = ReIDClassifier(num_classes) if num_classes else None

    @torch.no_grad()
    def load_params(self, params: Dict) -> None:
        """Copy the reference's folded HWIO param tree into the module (its
        classifier head too when both have one)."""
        _put_conv(self.stem, params["stem"])
        _put_blocks(self.blocks, params["layers"])
        if (self.classifier is None) != ("classifier" not in params):
            raise ValueError("classifier head layout mismatch")
        if self.classifier is not None:
            self.classifier.load_params(params["classifier"])

    def forward(self, x: torch.Tensor, classify: bool = False
                ) -> torch.Tensor:
        """(N, 128, 64, 3) NHWC -> (N, 512) float32, L2-normalized; with
        ``classify`` the classifier head's (N, classes) logits."""
        if self.stem.weight.dtype == torch.bfloat16:
            out = _maxpool_nhwc(conv_layer_bf16(self.stem, x, "relu"))
            for block in self.blocks:
                out = block.forward_bf16(out)
            feat = out.float().mean((1, 2))
        else:
            out = F.relu(self.stem(x.float().permute(0, 3, 1, 2)))
            out = F.max_pool2d(out, 3, 2, 1)
            out = self.blocks(out)
            feat = out.float().mean((2, 3))
        if classify:
            if self.classifier is None:
                raise ValueError("classify needs the classifier head "
                                 "(ReIDNet(num_classes=...))")
            return self.classifier(feat)
        norm = feat.norm(dim=1, keepdim=True)
        return feat / norm.clamp(min=1e-12)


class OriginalReIDNet(nn.Module):
    """The 128-d original_model.py net; load folded params with
    ``load_params``. The dense head runs in float32 whatever the module's
    dtype, as in the reference."""

    def __init__(self):
        super().__init__()
        self.stem = Conv2d(3, 32, 3, 1, 1)
        self.stem2 = Conv2d(32, 32, 3, 1, 1)
        blocks = []
        for ci, co, down in ORIGINAL_STAGES:
            blocks.append(BasicBlock(ci, co, down or ci != co, "elu"))
            blocks.append(BasicBlock(co, co, False, "elu"))
        self.blocks = nn.Sequential(*blocks)
        self.dense = Linear(128 * 16 * 8, ORIGINAL_FEAT_DIM)  # stays f32

    @torch.no_grad()
    def load_params(self, params: Dict) -> None:
        _put_conv(self.stem, params["stem"])
        _put_conv(self.stem2, params["stem2"])
        _put_blocks(self.blocks, params["layers"])
        self.dense.weight.copy_(torch.as_tensor(
            np.ascontiguousarray(np.asarray(params["dense"]["w"]).T)))
        self.dense.bias.copy_(torch.as_tensor(np.asarray(
            params["dense"]["b"])))

    def forward(self, x: torch.Tensor, classify: bool = False
                ) -> torch.Tensor:
        """(N, 128, 64, 3) NHWC -> (N, 128) float32, L2-normalized. The
        layout has no classifier head: ``classify`` raises, as the
        reference's does."""
        if classify:
            raise ValueError("classify mode is not supported for the "
                             "original_model.py layout (its classifier head "
                             "is not loaded)")
        if self.stem.weight.dtype == torch.bfloat16:
            out = conv_layer_bf16(self.stem, x, "elu")
            out = _maxpool_nhwc(conv_layer_bf16(self.stem2, out, "elu"))
            for block in self.blocks:
                out = block.forward_bf16(out)
            out = out.permute(0, 3, 1, 2)
        else:
            out = F.elu(self.stem(x.float().permute(0, 3, 1, 2)))
            out = F.elu(self.stem2(out))
            out = F.max_pool2d(out, 3, 2, 1)
            out = self.blocks(out)
        flat = out.float().flatten(1)  # NCHW order: (N, 128 * 16 * 8)
        feat = F.linear(flat, self.dense.weight, self.dense.bias)
        norm = feat.norm(dim=1, keepdim=True)
        return feat / norm.clamp(min=1e-12)
