"""Kernel 7's residual form on the card: the ReID blocks' second conv with
the block's tail -- + shortcut, the activation, one rounding -- in its
epilogue (modes 4 and 5 of ``csrc/conv.cu``), against the f32-output form
(mode 3) and the same tail in framework ops, at the blocks' own shapes at
320 crops (the K=1 cells' 8 streams x cap 40).

The sums are mode 3's for the same plan, and the tail runs the same f32
operations in the same order, so the ReLU blocks (``ReIDNet``) are held
bit for bit. The ELU blocks (``OriginalReIDNet``) take ``expm1f`` in the
epilogue where the framework tail takes ``torch.expm1``: within 1 bf16
ulp. One bf16 ``ReIDNet`` forward counts 8 residual launches (one a
block), and the K=1 step's features are the block-by-block composition's,
bit for bit.

Every test is marked ``gpu`` and skips without a CUDA device. This file
imports no jax:

    python -m pytest --noconftest -q -m gpu \
        tests/test_torch_port_reid_shortcut_gpu.py
"""

import numpy as np
import pytest
import torch

from yolo_deepsort_tpu_torch.kernels.launches import (read_launches,
                                                      zero_launches)
from yolo_deepsort_tpu_torch.models import reid as R
from yolo_deepsort_tpu_torch.models.layers import conv_layer_bf16
from yolo_deepsort_tpu_torch.ops import conv_kernel as CK
from yolo_deepsort_tpu_torch.weights import reid_from_params

pytestmark = pytest.mark.gpu

CROPS = 320  # 8 streams x cap 40
F32 = torch.float32
# (net, block index, (H, W) of the block's input)
BLOCKS = ([("ReIDNet", i, hw) for i, hw in enumerate(
    [(64, 32)] * 3 + [(32, 16)] * 2 + [(16, 8)] * 2 + [(8, 4)])]
    + [("OriginalReIDNet", i, hw) for i, hw in enumerate(
        [(64, 32)] * 3 + [(32, 16)] * 2 + [(16, 8)])])


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _net(name, dev):
    params = (R.random_reid_params(0) if name == "ReIDNet"
              else R.random_original_reid_params(0))
    return reid_from_params(params).to(dev, torch.bfloat16,
                                       memory_format=torch.channels_last)


def _tail(block, x):
    """The block with its tail in framework ops: conv2 in mode 3, the
    shortcut (the bf16 input or the projection's f32 output) added in
    f32, the activation, one rounding."""
    y = conv_layer_bf16(block.conv1, x, block.act_name)
    y = conv_layer_bf16(block.conv2, y, "linear", F32)
    shortcut = (x.float() if block.down is None else
                conv_layer_bf16(block.down, x, "linear", F32))
    return CK.apply_act(y + shortcut, block.act_name).to(torch.bfloat16)


def _ulps(got, want):
    """|got - want| in bf16 ulps of |want| (the ulp of the smallest normal
    below it), both bf16."""
    g, w = got.float(), want.float()
    e = torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126)))
    return float(((g - w).abs() / torch.exp2(e - 7)).max())


@pytest.mark.parametrize("net,index,hw", BLOCKS)
def test_block_tail_in_the_epilogue(dev, net, index, hw):
    model = _net(net, dev)
    block = model.blocks[index]
    ci = block.conv1.in_channels
    rng = np.random.default_rng(index)
    # a block's input is a rectified map: ReLU'd (ReIDNet) or ELU'd
    x = torch.from_numpy(rng.standard_normal(
        (CROPS, *hw, ci)).astype(np.float32)).to(dev)
    x = CK.apply_act(x, block.act_name).to(torch.bfloat16)
    with torch.no_grad():
        want = _tail(block, x)
        before = (CK.launches, CK.launches_residual)
        got = block.forward_bf16(x)
        after = (CK.launches, CK.launches_residual)
    n_convs = 2 + (block.down is not None)
    assert after == (before[0] + n_convs, before[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    if block.act_name == "relu":
        assert torch.equal(got, want)
    else:
        assert _ulps(got, want) <= 1


@pytest.mark.parametrize("net,blocks,convs", [("ReIDNet", 8, 20),
                                               ("OriginalReIDNet", 6, 16)])
def test_forward_counts_residual_launches(dev, net, blocks, convs):
    model = _net(net, dev)
    crops = torch.randn((CROPS, 128, 64, 3), device=dev)
    zero_launches()
    with torch.no_grad():
        model(crops)
    got = read_launches()
    assert (got["conv"], got["conv_residual"]) == (convs, blocks)


def test_k1_step_features_equal_the_blockwise_tail(dev, monkeypatch):
    """A small K=1 step on the card (yolov3-tiny at 64, 2 streams, bf16):
    every step's features are those of the same ``ReIDNet`` with each
    block's tail in framework ops, on the same crops, bit for bit."""
    from specs.weights_np import random_darknet_weights
    from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
    from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
    from yolo_deepsort_tpu_torch.models.darknet import build_network
    from yolo_deepsort_tpu_torch.parallel.streams import (
        init_stream_states, make_batched_step)
    from yolo_deepsort_tpu_torch.weights import (darknet_from_raw,
                                                 load_darknet_weights)

    h, w, s, size = 64, 128, 2, 64
    plan = build_network(ARCHITECTURES["yolov3-tiny"](img_size=size))
    blob = random_darknet_weights(plan.defs(), seed=0, well_conditioned=True)
    _, raw = load_darknet_weights(blob, plan.defs())
    detector = darknet_from_raw(plan, raw).to(
        dev, torch.bfloat16, memory_format=torch.channels_last)
    reid = _net("ReIDNet", dev)
    det_cfg = DetectorConfig(img_size=size, conf_thres=0.0, max_dets=8)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    step = make_batched_step(detector, reid, det_cfg, trk_cfg, (h, w), cap=6)
    seen = []
    forward = R.ReIDNet.forward

    def recorded(self, x, classify=False):
        out = forward(self, x, classify)
        seen.append((x.clone(), out.clone()))
        return out

    monkeypatch.setattr(R.ReIDNet, "forward", recorded)
    rng = np.random.default_rng(0)
    states = init_stream_states(trk_cfg, s, dev)
    for _ in range(3):
        frames = torch.from_numpy(rng.integers(0, 256, (s, h, w, 3),
                                               np.uint8)).to(dev)
        states, _ = step(states, frames)
    assert len(seen) == 3
    monkeypatch.setattr(R.BasicBlock, "forward_bf16", _tail)
    with torch.no_grad():
        for crops, feats in seen:
            assert feats.shape == (s * 6, R.FEAT_DIM)
            assert torch.equal(forward(reid, crops), feats)
