"""Kernel 7's mish epilogue (``yolo_deepsort_tpu_torch/csrc/conv_backbone.cuh``
``activate``) on the CPU, through a float32 mirror of its steps:

    e = expf(y); n = e (e + 2); d = n + 2; yn = y n
    r ~ 1 / d; q = yn r; m = fma(fma(-d, q, yn), r, q)
    y > 20 ? y : m

which is y tanh(softplus(y)) with tanh(log(1 + e^y)) = n / (n + 2), the
division y n / d as a reciprocal and one Newton step on the quotient (the
card's reciprocal is the approximate one, within an ulp; here 1 / d). The
mirror is held to float64 ``y * tanh(log(1 + e^y))`` on every bf16 value, on
2^20 seeded float32 values in [-90, 90] and on the edges (the cut at 20, the
overflow of n past ~44.3, the underflow of e^y below ~-87.3, the infinities
and NaN): within 8 float32 ulps for y >= -80, within 2^-120 below it, y
itself above 20, NaN exactly where float64 gives NaN (a NaN in, and -inf,
whose 0 x -inf the plain version shares), never NaN or inf for a finite y.
The card's own ``expf`` is held to the same bounds by
``tests/test_torch_port_gpu.py``; here numpy's float32 ``exp`` stands in.

Also here: the kernel source still takes those steps, ``conv_mish`` is a
launch counter, and ``tools/conv_clocks.py``'s ``MISH_CLASSES`` are the
mish convs of ``gpubench/configs/yolov4.cfg`` at 608.
"""

import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from yolo_deepsort_tpu_torch.cfg.parse import parse_model_config
from yolo_deepsort_tpu_torch.kernels.launches import LAUNCH_COUNTERS
from yolo_deepsort_tpu_torch.tools import conv_clocks
from yolo_deepsort_tpu_torch.tools.detector_kinds import module_shapes
from torch_port_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
F32 = np.float32
MAX_ULPS = 8.0
TINY_ABS = 2.0 ** -120  # below y = -80


def fma32(a, b, c):
    """fma(a, b, c) rounded to float32: a b is exact in float64; the sum
    rounds there and again to float32, which differs from one rounding only
    where float64 lands on a float32 tie."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def mish_form(y):
    """The kernel's mish, step for step in float32."""
    y = np.asarray(y, F32)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        e = np.exp(y)
        n = e * (e + F32(2))
        d, yn = n + F32(2), y * n
        r = F32(1) / d
        q = yn * r
        out = fma32(fma32(-d, q, yn), r, q)
    return np.where(y > 20, y, out).astype(F32)


def mish64(y):
    """y tanh(softplus(y)) in float64."""
    with np.errstate(invalid="ignore"):  # signalling NaNs among the bf16
        y = np.asarray(y, np.float64)
        return y * np.tanh(np.logaddexp(0.0, y))


def f32_ulp(v):
    """The float32 ulp at |v| (the subnormal spacing below 2^-126)."""
    a = np.maximum(np.abs(v), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 23)


def all_bf16():
    return (np.arange(2 ** 16, dtype=np.uint32) << 16).view(F32)


def edges():
    up = lambda v: np.nextafter(F32(v), F32(np.inf))  # noqa: E731
    down = lambda v: np.nextafter(F32(v), F32(-np.inf))  # noqa: E731
    pts = [0.0, -0.0, 20.0, up(20), down(20), 44.36, 88.72, up(88.72),
           89.0, 100.0, 1e30, np.finfo(F32).max, -np.finfo(F32).max,
           -80.0, down(-80), -87.3, -103.97, -104.0, -1e30, np.inf,
           -np.inf, np.nan, np.finfo(F32).tiny, -np.finfo(F32).tiny,
           np.finfo(F32).smallest_subnormal]
    return np.concatenate([
        np.asarray(pts, F32),
        np.linspace(9, 10, 4097, dtype=F32),
        np.linspace(44.3, 44.4, 1025, dtype=F32),
        np.linspace(88.7, 90, 1025, dtype=F32),
        np.linspace(-104, -87.3, 4097, dtype=F32)])


INPUTS = {
    "every_bf16": all_bf16,
    "seeded_2_20": lambda: np.random.default_rng(28).uniform(
        -90, 90, 2 ** 20).astype(F32),
    "edges": edges,
}


def check_against_float64(got, y):
    """Hold float32 mish ``got`` of the float32 inputs ``y`` to float64:
    NaN exactly where float64 has it, finite for a finite y, y itself above
    20, within TINY_ABS below -80 and MAX_ULPS float32 ulps elsewhere (0
    exactly at +-0). -> the worst ulps. The card's f32 output form is held
    to it too (``tests/test_torch_port_gpu.py``)."""
    want = mish64(y)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(y)
    assert np.isfinite(got[finite]).all(), "finite in, finite out"
    big = y > 20
    assert np.array_equal(got[big], y[big]), "y itself above 20"
    low = finite & (y < -80)
    assert (np.abs(got[low] - want[low]) <= TINY_ABS).all()
    rest = finite & ~low & ~big
    err = np.abs(got[rest].astype(np.float64) - want[rest])
    assert (err[want[rest] == 0] == 0).all()  # y = +-0
    worst = float((err / f32_ulp(want[rest])).max())
    assert worst <= MAX_ULPS
    return worst


@pytest.mark.parametrize("name", list(INPUTS))
def test_mish_form_against_float64(name):
    y = INPUTS[name]()
    got = mish_form(y)
    assert np.isnan(got[np.isnan(y)]).all()
    check_against_float64(got, y)


def test_kernel_source_takes_the_mirrored_steps():
    src = (ROOT / "yolo_deepsort_tpu_torch" / "csrc"
           / "conv_backbone.cuh").read_text()
    branch = re.search(r"if \(act == ACT_MISH\) \{(.*?)\n    \}", src,
                       re.S).group(1)
    code = " ".join(line.split("//")[0].strip()
                    for line in branch.splitlines()).split()
    assert " ".join(code) == (
        "const float e = expf(y); "
        "const float n = __fmul_rn(e, __fadd_rn(e, 2.0f)); "
        "const float d = __fadd_rn(n, 2.0f), yn = __fmul_rn(y, n); "
        "float r; "
        'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d)); '
        "const float q = __fmul_rn(yn, r); "
        "const float m = __fmaf_rn(__fmaf_rn(-d, q, yn), r, q); "
        "return y > 20.0f ? y : m;")


def test_conv_mish_is_a_launch_counter():
    assert LAUNCH_COUNTERS["conv_mish"] == ("ops.conv_kernel",
                                            "launches_mish")


def test_conv_clocks_mish_classes_are_yolov4_608s_mish_convs():
    defs = parse_model_config(ROOT / "gpubench" / "configs" / "yolov4.cfg")
    net, defs = defs[0], defs[1:]
    assert int(net["width"]) == int(net["height"]) == 608
    found = Counter()
    for row, d in zip(module_shapes(defs, 608, int(net["channels"])), defs):
        if d["type"] == "convolutional" and d["activation"] == "mish":
            ci, co, k, stride, hi, _, _, _ = row["conv"]
            found[(hi, ci, co, k, stride)] += 1
    assert dict(conv_clocks.MISH_CLASSES) == dict(found)
    assert len(conv_clocks.MISH_CLASSES) == len(found) == 26
    assert sum(found.values()) == 72
