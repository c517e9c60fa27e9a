"""Kernel 8's plain version and wrapper (ops/conv_int8_kernel.py) against the
JAX package on the CPU, at the five cases of tests/test_pallas_conv_int8.py
(3x3 stride 1 with and without residual, 3x3 stride 2 from 64 channels, the
f32-out last conv with residual, the 1x1 stride-2 shortcut), seeded numpy
inputs through both packages.

Tolerances:
* against an independent numpy reference (int64 sums over explicit taps,
  then the epilogue op by op in np.float32, which never contracts a
  multiply-add): codes and f32 values EXACTLY equal;
* against the JAX twin ``_xla_conv_int8_resident`` and against the Pallas
  kernel ``conv_int8`` in interpret mode: the reference's own bound for its
  pair -- codes at most 1 apart on at most 0.01% of elements (XLA may
  contract ``acc * scale + bias`` into an FMA, whose last-bit difference
  flips a value sitting on a rounding boundary), f32 outputs to rtol 1e-6 /
  atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from yolo_deepsort_tpu.models.quantize import _xla_conv_int8_resident
from yolo_deepsort_tpu.ops.pallas_conv_int8 import conv_int8 as j_conv_int8
from yolo_deepsort_tpu_torch.ops import conv_int8_kernel as CK
from torch_port_threads import torch_threads  # noqa: F401

CASES = [
    # (n, hi, wi, ci, co, k, stride, pad, relu, out_int8, residual)
    (4, 8, 8, 128, 128, 3, 1, 1, True, True, False),
    (4, 8, 8, 128, 128, 3, 1, 1, True, True, True),
    (4, 8, 8, 64, 128, 3, 2, 1, True, True, False),
    (8, 4, 4, 256, 256, 3, 1, 1, True, False, True),   # f32 out (last conv)
    (4, 8, 8, 128, 256, 1, 2, 0, False, True, False),  # 1x1 downsample
]
OUT_SCALE, RES_SCALE = 0.05, 0.03


def _case_inputs(case, seed):
    n, hi, wi, ci, co, k, stride, pad, _, _, has_res = case
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (n, hi, wi, ci)).astype(np.int8)
    w = rng.normal(0, 0.4, (k, k, ci, co)).astype(np.float32)
    wscale = np.abs(w).reshape(-1, co).max(0) / 127.0
    qp = {
        "wq": np.clip(np.rint(w / wscale), -127, 127).astype(np.int8),
        "scale": (0.02 * wscale).astype(np.float32),
        "b": rng.normal(0, 0.1, co).astype(np.float32),
        "oinv": np.float32(1.0 / OUT_SCALE),
    }
    ho = (hi + 2 * pad - k) // stride + 1
    wo = (wi + 2 * pad - k) // stride + 1
    res = (rng.integers(-127, 128, (n, ho, wo, co)).astype(np.int8)
           if has_res else None)
    return xq, qp, res, (ho, wo)


def _plain(case, xq, qp, res):
    _, _, _, _, _, _, stride, pad, relu, out_int8, has_res = case
    return CK.conv_int8_plain(
        torch.from_numpy(xq), torch.from_numpy(qp["wq"]),
        torch.from_numpy(qp["scale"]), torch.from_numpy(qp["b"]), qp["oinv"],
        None if res is None else torch.from_numpy(res),
        np.float32(RES_SCALE) if has_res else None,
        stride=stride, pad=pad, relu=relu, out_int8=out_int8).numpy()


def _numpy_reference(case, xq, qp, res, out_hw):
    n, hi, wi, ci, co, k, stride, pad, relu, out_int8, _ = case
    ho, wo = out_hw
    xp = np.pad(xq.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    acc = np.zeros((n, ho, wo, co), np.int64)
    for dy in range(k):
        for dx in range(k):
            tap = xp[:, dy:dy + stride * ho:stride, dx:dx + stride * wo:stride]
            acc += np.einsum("nhwc,co->nhwo", tap,
                             qp["wq"][dy, dx].astype(np.int64))
    assert np.abs(acc).max() < 2 ** 31
    y = acc.astype(np.int32).astype(np.float32) * qp["scale"]
    y = y + qp["b"]
    if res is not None:
        y = y + res.astype(np.float32) * np.float32(RES_SCALE)
    if relu:
        y = np.maximum(y, np.float32(0))
    assert y.dtype == np.float32
    if not out_int8:
        return y
    return np.clip(np.rint(y * qp["oinv"]), -127, 127).astype(np.int8)


def _assert_codes_match(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert float((diff > 0).mean()) <= 1e-4


@pytest.mark.parametrize("case", CASES)
def test_conv_int8_plain_equals_numpy_reference(case):
    xq, qp, res, out_hw = _case_inputs(case, 17)
    got = _plain(case, xq, qp, res)
    want = _numpy_reference(case, xq, qp, res, out_hw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert np.abs(want.astype(np.float32)).max() > 0


@pytest.mark.parametrize("interpret_kernel", [False, True],
                         ids=["xla_twin", "pallas_interpret"])
@pytest.mark.parametrize("case", CASES)
def test_conv_int8_plain_matches_jax(case, interpret_kernel):
    _, _, _, _, _, _, stride, pad, relu, out_int8, has_res = case
    xq, qp, res, _ = _case_inputs(case, 23)
    got = _plain(case, xq, qp, res)
    jqp = {k: jnp.asarray(v) for k, v in qp.items()}
    jres = None if res is None else jnp.asarray(res)
    jrs = jnp.float32(RES_SCALE) if has_res else None
    if interpret_kernel:
        want = j_conv_int8(jnp.asarray(xq), jqp["wq"], jqp["scale"], jqp["b"],
                           jqp["oinv"], jres, jrs, stride=stride, pad=pad,
                           relu=relu, out_int8=out_int8, interpret=True)
    else:
        want = _xla_conv_int8_resident(jnp.asarray(xq), jqp, stride, pad,
                                       relu, out_int8, residual=jres,
                                       res_scale=jrs)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if out_int8:
        _assert_codes_match(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    """``conv_int8`` on CPU tensors is the plain version and counts no
    launch; the launcher itself refuses CPU tensors, widths the kernel does
    not take, and a malformed residual."""
    case = CASES[1]
    xq, qp, res, _ = _case_inputs(case, 5)
    args = (torch.from_numpy(xq), torch.from_numpy(qp["wq"]),
            torch.from_numpy(qp["scale"]), torch.from_numpy(qp["b"]),
            qp["oinv"], torch.from_numpy(res), np.float32(RES_SCALE))
    before = CK.launches
    got = CK.conv_int8(*args)
    assert CK.launches == before
    np.testing.assert_array_equal(got.numpy(), _plain(case, xq, qp, res))
    with pytest.raises(ValueError, match="CUDA tensor"):
        CK.conv_int8_cuda(*args)
    with pytest.raises(ValueError, match="int8"):
        CK.conv_int8(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="pad"):
        CK.conv_int8(*args, pad=0)
    with pytest.raises(ValueError, match="does not fit"):
        CK.conv_int8(args[0][..., :64], *args[1:])


def test_int_conv_is_exact_past_2_pow_24():
    """All-127 codes over a 3x3x512 receptive field sum to 74,317,824 >
    2^24: an f32 conv would round it, the float64 one must not."""
    xq = torch.full((1, 3, 3, 512), 127, dtype=torch.int8)
    wq = torch.full((3, 3, 512, 16), 127, dtype=torch.int8)
    wq[0, 0, 0, 1] = 126
    acc = CK.int_conv_nhwc(xq, wq, 1, 1)
    assert acc.dtype == torch.int32
    assert int(acc[0, 1, 1, 0]) == 127 * 127 * 9 * 512
    assert int(acc[0, 1, 1, 1]) == 127 * 127 * 9 * 512 - 127
