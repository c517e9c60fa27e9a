"""Kernel 7's residual form (``conv_bf16(..., residual=)``) on the CPU: the
ReID blocks' second conv with the block's whole tail -- + shortcut, the
activation, one rounding -- against the composition the bf16 blocks ran
before it had one: the f32-output conv, ``+ shortcut`` in f32,
``apply_act``, ``.to(bfloat16)``. The plain version runs the same f32
operations in the same order, so every comparison here is bit for bit, at
small shapes, inputs from a numpy seed. (The kernel on the card:
tests/test_torch_port_reid_shortcut_gpu.py.)
"""

import numpy as np
import pytest
import torch

from yolo_deepsort_tpu_torch.kernels.launches import LAUNCH_COUNTERS
from yolo_deepsort_tpu_torch.models import reid as R
from yolo_deepsort_tpu_torch.models.layers import conv_layer_bf16
from yolo_deepsort_tpu_torch.ops import conv_kernel as CK
from yolo_deepsort_tpu_torch.weights import reid_from_params

F32 = torch.float32


def _parent_forward_bf16(block, x):
    """The bf16 block as it ran with the tail in framework ops."""
    y = conv_layer_bf16(block.conv1, x, block.act_name)
    y = conv_layer_bf16(block.conv2, y, "linear", F32)
    shortcut = (x.float() if block.down is None else
                conv_layer_bf16(block.down, x, "linear", F32))
    return CK.apply_act(y + shortcut, block.act_name).to(torch.bfloat16)


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("act", ["relu", "elu"])
@pytest.mark.parametrize("shortcut", ["identity", "projection"])
def test_plain_residual_equals_the_framework_tail(shortcut, act):
    rng = np.random.default_rng(7)
    n, h, w, ci, co = 2, 16, 8, 16, 32
    stride = 2 if shortcut == "projection" else 1
    if shortcut == "identity":
        ci = co
    x = _bf16(rng, (n, h, w, ci))
    w1 = _bf16(rng, (3, 3, ci, co), 1 / np.sqrt(9 * ci))
    w2 = _bf16(rng, (3, 3, co, co), 1 / np.sqrt(9 * co))
    b1, b2 = (torch.from_numpy(rng.standard_normal(co).astype(np.float32))
              for _ in range(2))
    y = CK.conv_plain_bf16(x, w1, b1, stride=stride, act=act)
    if shortcut == "identity":
        res = x
    else:
        wd = _bf16(rng, (1, 1, ci, co), 1 / np.sqrt(ci))
        bd = torch.from_numpy(rng.standard_normal(co).astype(np.float32))
        res = CK.conv_plain_bf16(x, wd, bd, stride=2, pad=0, act="linear",
                                 out_dtype=F32)
    want = CK.apply_act(
        CK.conv_plain_bf16(y, w2, b2, act="linear", out_dtype=F32)
        + res.float(), act).to(torch.bfloat16)
    for fn in (CK.conv_plain_bf16, CK.conv_bf16):
        got = fn(y, w2, b2, act=act, residual=res)
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert torch.equal(got, want)
        assert got.view(torch.int16).equal(want.view(torch.int16))


@pytest.mark.parametrize("net", ["ReIDNet", "OriginalReIDNet"])
def test_bf16_reid_forward_equals_blockwise_tail(net, monkeypatch):
    """Both nets share ``BasicBlock``: their bf16 forwards with conv2's
    residual form give the features the framework tail gave, bit for bit,
    and every block's output is the tail's too."""
    params = (R.random_reid_params(3) if net == "ReIDNet"
              else R.random_original_reid_params(3))
    model = reid_from_params(params).to(torch.bfloat16)
    assert type(model).__name__ == net
    crops = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 128, 64, 3)).astype(np.float32))
    outs = []
    fused = R.BasicBlock.forward_bf16

    def recorded(block, x):
        out = fused(block, x)
        want = _parent_forward_bf16(block, x)
        assert out.view(torch.int16).equal(want.view(torch.int16))
        outs.append(out)
        return out

    with torch.no_grad():
        monkeypatch.setattr(R.BasicBlock, "forward_bf16", recorded)
        got = model(crops)
        monkeypatch.setattr(R.BasicBlock, "forward_bf16",
                            _parent_forward_bf16)
        want = model(crops)
    assert len(outs) == sum(isinstance(m, R.BasicBlock)
                            for m in model.modules())
    assert got.dtype == F32 and torch.equal(got, want)


def test_conv_residual_is_a_launch_counter():
    assert LAUNCH_COUNTERS["conv_residual"] == ("ops.conv_kernel",
                                                "launches_residual")


@pytest.mark.parametrize("bad", ["shape", "dtype", "device",
                                 "non_contiguous", "f32_out"])
def test_conv_refuses_a_residual_it_cannot_read(bad):
    x = torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 16, 16), dtype=torch.bfloat16)
    b = torch.zeros((16,))
    res = torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16)
    kw = {}
    if bad == "shape":
        res = torch.zeros((1, 4, 4, 16), dtype=torch.bfloat16)
    elif bad == "dtype":
        res = res.half()
    elif bad == "device":
        res = torch.zeros((1, 8, 8, 16), dtype=torch.bfloat16, device="meta")
    elif bad == "non_contiguous":
        res = torch.zeros((1, 16, 8, 8), dtype=torch.bfloat16).permute(
            0, 2, 3, 1)
    else:
        kw["out_dtype"] = F32
    with pytest.raises(ValueError, match="residual"):
        CK.conv_bf16(x, w, b, act="relu", residual=res, **kw)
    CK.conv_bf16(x, w, b, act="relu", residual=torch.zeros_like(x))
