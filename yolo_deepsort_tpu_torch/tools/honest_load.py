"""The honest load shared by the detector gate, the soaks and the smoke run
(port of ``bench.py`` ``plant_box_prior`` and of ``tools/bench_probes.py``
``bn_weights_and_frames`` / ``calibrate_conf``).

Random weights straight from a generator are not a detector: their BN
statistics do not describe their own activations, their heads decode boxes
of every size the anchors allow, and a fixed threshold admits thousands of
boxes or none. The load fixes each of these the way the reference does:

1. BN-consistent weights: random raw params (``weights.random_raw_params``,
   the reference's draws), one train-mode forward with ``bn_update=1.0``
   over the letterboxed frames (``train/yolo_cli.py``
   ``make_forward_train``), whose batch statistics become the running ones
   (``bn_consistent_raw``);
2. the MOT box prior (``plant_box_prior``): each head's tw/th biases aimed
   at person-sized boxes;
3. per-stream thresholds (``calibrate_conf``): the ``target``-th largest
   objectness of the bf16 forward on the frames the run will see.

``bn_weights_and_frames`` does all three and returns the float32
``Darknet`` on the device, its bf16 twin (channels_last, every conv through
kernel 7 on the card), the frames as a (K, S, H, W, 3) uint8 device tensor
and the thresholds. The BN capture and the calibration letterbox with the
plain ``ops/letterbox.letterbox_batch`` in float32, as the reference uses
its XLA letterbox there, so the weights and thresholds can be held to the
JAX package's on the same seeds.
"""

from __future__ import annotations

import copy
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.darknet import Darknet, NetworkPlan
from ..ops.letterbox import letterbox_batch
from ..train.trees import full_f32, to_torch
from ..train.yolo_cli import (
    make_forward_train,
    raw_params_to_train,
    train_params_to_raw,
)
from ..weights import darknet_from_raw, random_raw_params

BOX_PRIOR_HEIGHTS = (120.0, 150.0, 185.0, 225.0, 270.0)  # 1080p pixels
BOX_PRIOR_ASPECT = 0.41  # w / h, Market-1501 crop aspect

def plant_box_prior(raw, plan: NetworkPlan, frame_hw,
                    heights=BOX_PRIOR_HEIGHTS, aspect=BOX_PRIOR_ASPECT):
    """Rewrite each yolo head's tw/th channels the way training on person
    data would set them: zero their weight rows and set their biases so
    anchor a of head g decodes boxes of height heights[(3g + a) % len] frame
    pixels (converted through the letterbox scale; the ladder is calibrated
    at 1080p) and width aspect * height. Box centres, objectness and
    classes stay live. Copies the head arrays it rewrites (raw params may
    share memory with training tensors); returns the same dict."""
    size = plan.img_size
    scale = size / float(max(frame_hw))  # frame px -> letterbox px
    scale *= frame_hw[0] / 1080.0
    for g, head in enumerate(plan.heads):
        layer = raw[head.module_index - 1]
        layer["conv_weight"] = np.array(layer["conv_weight"])
        layer["conv_bias"] = np.array(layer["conv_bias"])
        per = 5 + head.num_classes
        for a, (pw, ph) in enumerate(head.anchors):
            h_t = heights[(3 * g + a) % len(heights)] * scale
            w_t = aspect * h_t
            cw, ch = a * per + 2, a * per + 3
            layer["conv_weight"][cw] = 0.0
            layer["conv_weight"][ch] = 0.0
            layer["conv_bias"][cw] = np.log(w_t / pw)
            layer["conv_bias"][ch] = np.log(h_t / ph)
    return raw


@torch.no_grad()
def bn_consistent_raw(plan: NetworkPlan, frames: torch.Tensor,
                      seed: int = 0) -> Dict:
    """Raw darknet params (numpy, OIHW + BN) whose BN running statistics
    are the batch statistics of one float32 train-mode forward over
    ``frames`` (S, H, W, 3) uint8, letterboxed, on the frames' device, with
    the MOT box prior planted for the frames' geometry."""
    defs = plan.defs()
    raw = random_raw_params(defs, plan.in_channels, seed=seed)
    t_params, t_stats = raw_params_to_train(raw, defs)
    dev = frames.device
    xs = letterbox_batch(frames, plan.img_size)
    with full_f32():
        _, new_stats = make_forward_train(plan, bn_update=1.0)(
            to_torch(t_params, dev), to_torch(t_stats, dev), xs)
    raw = train_params_to_raw(t_params, {**t_stats, **new_stats}, defs)
    return plant_box_prior(raw, plan, tuple(frames.shape[1:3]))


@torch.no_grad()
def calibrate_conf(detector_bf16: Darknet, frames_s: torch.Tensor,
                   img_size: int, target: int) -> np.ndarray:
    """Per-stream objectness threshold that puts ~``target`` detections
    above it: the ``target``-th largest objectness of the bf16 forward on
    each of ``frames_s`` (S, H, W, 3) uint8 -- the frames the run will see
    (noise and decoded video give very different confidence distributions).
    -> (S,) float32 on the host."""
    obj = detector_bf16(letterbox_batch(frames_s, img_size))[..., 4]
    kth = torch.topk(obj.float(), target, dim=-1).values[:, target - 1]
    return kth.cpu().numpy().astype(np.float32)


class HonestLoad(NamedTuple):
    plan: NetworkPlan
    raw: Dict                # raw darknet params (numpy), prior planted
    detector: Darknet        # float32, on the device
    detector_bf16: Darknet   # its bf16 channels_last twin
    frames: torch.Tensor     # (K, S, H, W, 3) uint8 on the device
    conf_vec: np.ndarray     # (S,) float32 per-stream thresholds


def bn_weights_and_frames(model: str, img_size: int, k: int, s: int, hw,
                          target: int, device=None) -> HonestLoad:
    """The honest load on ``device`` (the CUDA card unless named): S seeded
    noise frames of ``hw``, the same in each of the K frames of a chunk;
    BN-consistent weights captured on them; the box prior; the thresholds
    calibrated on them through the bf16 twin."""
    from ..cfg.architectures import ARCHITECTURES
    from ..models.darknet import build_network

    dev = resolve_device(device)
    plan = build_network(ARCHITECTURES[model](img_size=img_size))
    rng = np.random.default_rng(0)
    base = torch.from_numpy(
        rng.integers(0, 256, (s, *hw, 3), dtype=np.uint8)).to(dev)
    frames = base[None].expand(k, -1, -1, -1, -1).contiguous()
    raw = bn_consistent_raw(plan, base)
    detector = darknet_from_raw(plan, raw).to(dev)
    detector_bf16 = copy.deepcopy(detector).to(
        dev, torch.bfloat16, memory_format=torch.channels_last)
    conf_vec = calibrate_conf(detector_bf16, base, img_size, target)
    return HonestLoad(plan, raw, detector, detector_bf16, frames, conf_vec)
