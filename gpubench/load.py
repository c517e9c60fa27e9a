"""The seeded inputs of a run, made on the device from ``--seed``, handed
alike to the program and to the plain reference:

* frames: static cameras with sensor noise. One uniform noise scene a
  stream, and ``variants`` frames of it, each the scene plus its own
  rounded Gaussian noise of ``noise_sigma`` grey levels: (V, S, H, W, 3)
  uint8. A chunk's K frames are the V = K variants in turn (so no two
  frames of a chunk are alike, and a step that reused one frame's work
  for another would be seen); a K=1 step takes variant ``step % V``.
* darknet weights: raw params (OIHW, BN) with He-scaled normal weights and
  identity BN, the BN statistics then taken from one float32 forward of
  the reference over the letterboxed first variant, each BN normalizing
  by its batch's own statistics as it goes -- uncentered: mean 0 and the
  mean square as the variance, so every layer's output has unit mean
  square. (Centred statistics make a random detector chaotic: subtracting
  the large mean that a leaky, mish or max-pool output has amplifies any
  perturbation a little at every layer, and bf16 rounding ends up
  decorrelating yolov4's heads from float32's, 1 - cosine 0.3.) Then the
  MOT box prior is planted in the heads (each head's tw / th rows zeroed
  and their biases set so anchor a of head g decodes person boxes of
  ``heights[(3g + a) % len]`` pixels of 1080p at ``aspect``; a frozen
  copy of the honest load's method);
* ReID weights: a state dict in the public ``ckpt.t7`` key layout,
  He-scaled normal convs, BN with unit scale, zero shift and running
  statistics of a fresh net;
* thresholds (``stream_thresholds``, ``pooled_threshold``): from the
  reference's float32 objectness on every frame of the run, so that the
  reference's NMS leaves ``target_dets - margin`` detections in the
  fullest frame (of each stream, or of all), in the widest objectness gap
  that does. The program's bfloat16 objectness ranks the candidates next
  to the threshold a little otherwise, so its counts lie a few either
  side; the margin keeps them inside the capacity the mix is sized for.

"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .reference import darknet as ref_darknet
from .reference import reid as ref_reid

SEED_MOD = 2 ** 63 - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent generator for each of a run's draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % SEED_MOD)
    return g


def frames(seed: int, s: int, hw: Sequence[int], device, variants: int = 1,
           noise_sigma: float = 0.0) -> torch.Tensor:
    """(V, S, H, W, 3) uint8: a noise scene a stream, and V variants of it
    with sensor noise of ``noise_sigma`` grey levels each."""
    scene = torch.randint(0, 256, (s, hw[0], hw[1], 3), dtype=torch.uint8,
                          generator=generator(seed, 1, device), device=device)
    out = torch.empty((variants,) + tuple(scene.shape), dtype=torch.uint8,
                      device=device)
    g = generator(seed, 4, device)
    for v in range(variants):
        noise = torch.randn(scene.shape, generator=g, device=device)
        out[v] = (scene + noise * noise_sigma).round_().clamp_(0, 255)
    return out


def darknet_raw(defs, img_size: int, seed: int, device) -> Dict[int, Dict]:
    """Raw params of every conv (defs without [net]): float32 on the
    device, drawn in one call and scaled per layer."""
    convs = ref_darknet.conv_shapes(defs, img_size)
    sizes = [c["co"] * c["ci"] * c["k"] * c["k"] for c in convs]
    flat = torch.randn(sum(sizes), generator=generator(seed, 2, device),
                       device=device)
    raw, off = {}, 0
    for c, n in zip(convs, sizes):
        std = float(np.sqrt(2.0 / (c["ci"] * c["k"] * c["k"])))
        layer = {"conv_weight": (flat[off:off + n] * std).reshape(
            c["co"], c["ci"], c["k"], c["k"])}
        off += n
        ones = torch.ones(c["co"], device=device)
        if c["bn"]:
            layer.update(bn_weight=ones, bn_bias=ones * 0, bn_mean=ones * 0,
                         bn_var=ones.clone())
        else:
            layer["conv_bias"] = ones * 0
        raw[c["index"]] = layer
    return raw


@torch.no_grad()
def capture_bn(defs, raw, frames_s: torch.Tensor, img_size: int) -> None:
    """BN running statistics := the uncentered batch statistics of one
    float32 forward of the reference over the letterboxed frames."""
    with ref_darknet.f32_exact():
        ref_darknet.forward(defs, raw, ref_darknet.letterbox(
            frames_s, img_size), img_size, capture_bn=True)


@torch.no_grad()
def plant_box_prior(defs, raw, img_size: int, frame_hw, heights,
                    aspect: float) -> None:
    scale = img_size / float(max(frame_hw)) * frame_hw[0] / 1080.0
    for g, (idx, anchors, classes, _) in enumerate(
            ref_darknet.yolo_heads(defs)):
        layer = raw[idx - 1]
        per = 5 + classes
        for a, (pw, ph) in enumerate(anchors):
            h_t = heights[(3 * g + a) % len(heights)] * scale
            w_t = aspect * h_t
            for ch, v in ((a * per + 2, np.log(w_t / pw)),
                          (a * per + 3, np.log(h_t / ph))):
                layer["conv_weight"][ch] = 0.0
                layer["conv_bias"][ch] = float(v)


def detector_weights(defs, img_size, frames_s, seed, prior):
    """The raw params of the run: drawn, BN statistics captured, the box
    prior planted."""
    raw = darknet_raw(defs, img_size, seed, frames_s.device)
    capture_bn(defs, raw, frames_s, img_size)
    plant_box_prior(defs, raw, img_size, tuple(frames_s.shape[1:3]),
                    prior["heights"], prior["aspect"])
    return raw


def reid_state_dict(seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = ref_reid.state_dict_shapes()
    convs = {k: v for k, v in shapes.items() if len(v) == 4}
    sizes = [int(np.prod(v)) for v in convs.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, 3, device),
                       device=device)
    sd, off = {}, 0
    for (k, shape), n in zip(convs.items(), sizes):
        fan_in = shape[1] * shape[2] * shape[3]
        sd[k] = (flat[off:off + n] * float(np.sqrt(2.0 / fan_in))).reshape(
            shape)
        off += n
    for k, shape in shapes.items():
        if len(shape) == 4:
            continue
        fill = 1.0 if k.endswith(("weight", "running_var")) else 0.0
        sd[k] = torch.full(shape, fill, device=device)
    return sd


@torch.no_grad()
def candidates(defs, raw, frames_v: torch.Tensor, img_size: int, top: int
               ) -> np.ndarray:
    """(V, S, top, 6 + C) float64: of every frame, the reference's float32
    decoded rows of the ``top`` highest objectness, each with its row
    index last (NMS breaks score ties by it), in row order."""
    out = []
    with ref_darknet.f32_exact():
        for v in range(frames_v.shape[0]):
            d = ref_darknet.forward(defs, raw, ref_darknet.letterbox(
                frames_v[v], img_size), img_size)
            idx = d[..., 4].topk(top, dim=1).indices.sort(1).values
            rows = torch.gather(d, 1, idx[..., None].expand(
                -1, -1, d.shape[-1]))
            out.append(torch.cat([rows.double(), idx[..., None].double()],
                                 -1).cpu().numpy())
    return np.stack(out)


class KeptCount:
    """The number of rows ``reference.nms.nms_image`` keeps from one
    frame's candidates at any objectness threshold, without re-running
    it: the ranking by score and which row each row would merge are fixed,
    so a threshold only chooses which rows take part. Exact for
    thresholds above the lowest candidate's objectness."""

    def __init__(self, cand: np.ndarray, nms_thres: float, max_boxes: int,
                 max_dets: int):
        rows = cand[:, :-1]
        cls_conf = rows[:, 5:].max(1)
        score = rows[:, 4].astype(np.float32) * cls_conf.astype(np.float32)
        order = np.argsort(-score, kind="stable")  # cand is in row order
        rows = rows[order]
        self.obj = rows[:, 4]
        cls = rows[:, 5:].argmax(1)
        xyxy = np.stack([rows[:, 0] - rows[:, 2] / 2,
                         rows[:, 1] - rows[:, 3] / 2,
                         rows[:, 0] + rows[:, 2] / 2,
                         rows[:, 1] + rows[:, 3] / 2], 1)
        ix1 = np.maximum(xyxy[:, None, 0], xyxy[None, :, 0])
        iy1 = np.maximum(xyxy[:, None, 1], xyxy[None, :, 1])
        ix2 = np.minimum(xyxy[:, None, 2], xyxy[None, :, 2])
        iy2 = np.minimum(xyxy[:, None, 3], xyxy[None, :, 3])
        inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
        area = (xyxy[:, 2] - xyxy[:, 0]) * (xyxy[:, 3] - xyxy[:, 1])
        iou = inter / (area[:, None] + area[None, :] - inter + 1e-16)
        merges = (iou > nms_thres) & (cls[:, None] == cls[None, :])
        self.merges = [np.flatnonzero(m[i + 1:]) + i + 1
                       for i, m in enumerate(merges)]
        self.max_boxes, self.max_dets = max_boxes, max_dets

    def __call__(self, thr: float) -> int:
        taking = np.flatnonzero(self.obj >= thr)[:self.max_boxes]
        gone = np.ones(len(self.obj), bool)
        gone[taking] = False
        n = 0
        for i in taking:
            if gone[i]:
                continue
            n += 1
            if n == self.max_dets:
                break
            gone[self.merges[i]] = True
        return n


def _threshold(counters: List[KeptCount], fullest: int) -> float:
    """The midpoint of the widest gap of the frames' pooled objectness at
    which the fullest frame keeps exactly ``fullest`` rows (counts are
    followed down the pooled objectness, frame by frame)."""
    obj = np.concatenate([c.obj for c in counters])
    owner = np.concatenate([np.full(len(c.obj), i)
                            for i, c in enumerate(counters)])
    order = np.argsort(-obj, kind="stable")
    obj, owner = obj[order], owner[order]
    # below a frame's lowest candidate, rows outside ``cand`` would count
    floor = max(c.obj.min() for c in counters)
    counts = np.zeros(len(counters), int)
    best, best_gap = None, 0.0
    for r in range(1, len(obj)):
        if 0.5 * (obj[r - 1] + obj[r]) <= floor:
            break
        i = owner[r - 1]
        counts[i] = counters[i](obj[r - 1])
        if counts.max() > fullest:
            break
        gap = obj[r - 1] - obj[r]
        if counts.max() == fullest and gap > best_gap:
            best, best_gap = 0.5 * (obj[r - 1] + obj[r]), gap
    if best is None:
        raise ValueError(f"no threshold leaves {fullest} detections in the "
                         "fullest frame")
    return float(np.float32(best))


def stream_thresholds(cand: np.ndarray, fullest: int, det: Dict
                      ) -> List[float]:
    """cand (V, S, M, 6 + C) -> one threshold a stream, over its V
    frames."""
    return [_threshold([KeptCount(cand[v, s], det["nms_thres"],
                                  det["max_boxes"], det["max_dets"])
                        for v in range(cand.shape[0])], fullest)
            for s in range(cand.shape[1])]


def pooled_threshold(cand: np.ndarray, fullest: int, det: Dict) -> float:
    """One threshold for every stream and frame (the K=1 step takes a
    scalar)."""
    return _threshold([KeptCount(c, det["nms_thres"], det["max_boxes"],
                                 det["max_dets"])
                       for c in cand.reshape(-1, *cand.shape[2:])], fullest)
