"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test is marked ``gpu`` and skips without a CUDA device. This file
imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

from yolo_deepsort_tpu_torch.config import TrackerConfig
from yolo_deepsort_tpu_torch.ops import (
    assignment_kernel,
    conv_int8_kernel,
    conv_kernel,
    conv_plan,
    crops_kernel,
    letterbox_kernel,
    resblock_kernel,
)
from yolo_deepsort_tpu_torch.tools import int8_probe
from yolo_deepsort_tpu_torch.tracking import tracker_kernel
from yolo_deepsort_tpu_torch.tracking.tracker import (
    init_tracker_state,
    tracker_step,
)

import test_torch_port_mish_form as MF

pytestmark = pytest.mark.gpu

DISCRETE = ("state", "hits", "age", "time_since_update", "track_id",
            "gallery_head", "gallery_count", "next_id")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _frames(seed, b, h, w, dev):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (b, h, w, 3), np.uint8)).to(dev)


@pytest.mark.parametrize("hw,size", [((270, 480), 416), ((480, 270), 416),
                                     ((64, 64), 96), ((1080, 1920), 608)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_letterbox_kernel_vs_plain(cuda_device, hw, size, dtype):
    frames = _frames(4, 2, *hw, cuda_device)
    before = letterbox_kernel.launches
    got = letterbox_kernel.letterbox_batch_fused(frames, size, dtype)
    assert letterbox_kernel.launches == before + 1
    want = letterbox_kernel.letterbox_batch(frames, size, dtype)
    assert got.dtype == dtype and got.shape == (2, size, size, 3)
    # f32: same taps and weights, last-bit sums; bf16: one ulp below 1
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("window", [(32, 40), (320, 192), (64, 128)])
def test_crops_kernel_vs_plain(cuda_device, window):
    rng = np.random.default_rng(5)
    b, d, h, w = 2, 9, 96, 160
    bw, bh = rng.uniform(2, 60, (b, d)), rng.uniform(2, 50, (b, d))
    x1, y1 = rng.uniform(-10, w, (b, d)), rng.uniform(-10, h, (b, d))
    boxes = np.clip(np.stack([x1, y1, x1 + bw, y1 + bh], -1), 0,
                    [w - 1, h - 1, w - 1, h - 1]).astype(np.float32)
    frames = _frames(5, b, h, w, cuda_device)
    boxes = torch.from_numpy(boxes).to(cuda_device)
    before = crops_kernel.launches
    got = crops_kernel.crop_and_normalize_fused(frames, boxes, *window)
    assert crops_kernel.launches == before + 1
    want = crops_kernel.crops_plain(frames, boxes, *window)
    # oversized boxes included: both sides truncate to the same window
    assert (got - want).abs().max().item() <= 1e-4


def _scene(rng, s, n_obj, frames, d, feat_dim, dropout):
    base = np.stack([rng.uniform(10, 230, (s, n_obj)),
                     rng.uniform(10, 120, (s, n_obj)),
                     rng.uniform(20, 60, (s, n_obj)),
                     rng.uniform(40, 90, (s, n_obj))], -1)
    vel = rng.normal(0, 1.5, (s, n_obj, 2))
    feats = rng.normal(0, 1, (s, n_obj, feat_dim))
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    for f in range(frames):
        tl = np.zeros((s, d, 4), np.float32)
        fe = np.zeros((s, d, feat_dim), np.float32)
        mk = np.zeros((s, d), bool)
        for si in range(s):
            keep = np.flatnonzero(rng.uniform(size=n_obj) > dropout)[:d]
            box = base[si, keep].copy()
            box[:, :2] += vel[si, keep] * f
            box += rng.normal(0, 0.8, box.shape)
            ft = feats[si, keep] + rng.normal(0, 0.05, (len(keep), feat_dim))
            tl[si, :len(keep)] = box
            fe[si, :len(keep)] = ft / np.linalg.norm(ft, axis=-1,
                                                     keepdims=True)
            mk[si, :len(keep)] = True
        conf = np.where(mk, 0.9, 0.0).astype(np.float32)
        yield [torch.from_numpy(a) for a in (tl, conf, fe, mk)]


@pytest.mark.parametrize("case", ["churn", "multistream", "wide"])
def test_tracker_kernel_vs_plain(cuda_device, case):
    s, n_obj, d, dropout, kw = {
        "churn": (1, 10, 8, 0.35, dict(max_tracks=8, nn_budget=3,
                                       max_age=4)),
        "multistream": (3, 6, 8, 0.1, dict(max_tracks=16, nn_budget=5)),
        "wide": (2, 40, 48, 0.2, dict(max_tracks=72, nn_budget=6)),
    }[case]
    cfg = TrackerConfig(max_dets=d, feat_dim=64, **kw)
    k_state = init_tracker_state(cfg, s, cuda_device)
    p_state = init_tracker_state(cfg, s, "cpu")
    rng = np.random.default_rng(11)
    for f, args in enumerate(_scene(rng, s, n_obj, 16, d, 64, dropout)):
        p_state, p_out, p_emit = tracker_kernel.tracker_step_fused_batched(
            cfg, p_state, *args, (240, 320))
        k_state, k_out, k_emit = tracker_kernel.tracker_step_fused_batched(
            cfg, k_state, *(a.to(cuda_device) for a in args), (240, 320))
        for name in DISCRETE:
            assert torch.equal(getattr(p_state, name),
                               getattr(k_state, name).cpu()), (f, name)
        assert torch.equal(p_emit, k_emit.cpu()), f
        assert torch.equal(p_out[..., 4], k_out[..., 4].cpu()), f
        assert (p_out[..., :4] - k_out[..., :4].cpu()).abs().max() <= 1
        assert torch.allclose(p_state.mean, k_state.mean.cpu(), rtol=2e-4,
                              atol=2e-3), f
        assert torch.allclose(p_state.gallery, k_state.gallery.cpu(),
                              rtol=1e-5, atol=1e-6), f


def jv_problem(rng, s, r, c):
    """A seeded batch of two-stage problems: costs on a coarse grid (exact
    ties), INFTY gates, inactive rows and columns, cascade levels 0-5,
    per-stream stage-A thresholds, and (with S > 1) stream 0 with no active
    stage-A row."""
    cost_a = rng.integers(0, 12, (s, r, c)).astype(np.float32) / 40
    cost_a[rng.uniform(size=(s, r, c)) < 0.3] = 1e5
    levels = rng.integers(0, 6, (s, r)).astype(np.int32)
    rows_a = rng.uniform(size=(s, r)) < 0.6
    if s > 1:
        rows_a[0] = False
    cols = rng.uniform(size=(s, c)) < 0.85
    cost_b = rng.integers(0, 30, (s, r, c)).astype(np.float32) / 30
    cost_b[rng.uniform(size=(s, r, c)) < 0.2] = 1e5
    rows_b = (rng.uniform(size=(s, r)) < 0.4) | (
        rows_a & (rng.uniform(size=(s, r)) < 0.5))
    maxd_a = (rng.integers(3, 9, s) / 40).astype(np.float32)
    return [torch.from_numpy(v) for v in (cost_a, levels, rows_a, cols,
                                          maxd_a, cost_b, rows_b)]


@pytest.mark.parametrize("shape", [(8, 128, 64), (3, 72, 48), (1, 128, 64)])
def test_jv_kernels_vs_plain(cuda_device, shape):
    cost_a, levels, rows_a, cols, maxd_a, cost_b, rows_b = jv_problem(
        np.random.default_rng(sum(shape)), *shape)
    dev = [v.to(cuda_device) for v in (cost_a, levels, rows_a, cols, maxd_a)]
    before = assignment_kernel.cascade_launches
    got = assignment_kernel.solve_cascade_assignment_fused(*dev)
    assert assignment_kernel.cascade_launches == before + 1
    want = assignment_kernel.solve_cascade_assignment_fused(
        cost_a, levels, rows_a, cols, maxd_a)
    assert torch.equal(got.cpu(), want)
    assert (want >= 0).any()

    before = assignment_kernel.two_stage_launches
    got = assignment_kernel.solve_two_stage_assignment_fused(
        *dev, cost_b.to(cuda_device), rows_b.to(cuda_device), 0.7)
    assert assignment_kernel.two_stage_launches == before + 1
    want = assignment_kernel.solve_two_stage_assignment_fused(
        cost_a, levels, rows_a, cols, maxd_a, cost_b, rows_b, 0.7)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    # stage A leaves stage B free columns in stream 0 (no stage-A rows)
    assert (want[1] >= 0).any() or shape[0] == 1


def test_tracker_step_on_cuda_tensors(cuda_device):
    """The facades' unfused step runs on the card through kernel K5 and
    equals the same step on the CPU: discrete state and emitted rows
    exactly, Kalman means within the tolerance the tracker kernel is held
    to (the two devices round the filter's arithmetic apart by ulps)."""
    cfg = TrackerConfig(max_dets=16, feat_dim=64, max_tracks=24, nn_budget=5,
                        max_age=4)
    s = 3
    k_state = init_tracker_state(cfg, s, cuda_device)
    p_state = init_tracker_state(cfg, s, "cpu")
    rng = np.random.default_rng(12)
    before = assignment_kernel.two_stage_launches
    frames = list(_scene(rng, s, 12, 14, 16, 64, 0.25))
    for f, args in enumerate(frames):
        p_state, p_out, p_emit = tracker_step(cfg, p_state, *args, (240, 320))
        k_state, k_out, k_emit = tracker_step(
            cfg, k_state, *(a.to(cuda_device) for a in args), (240, 320))
        for name in DISCRETE:
            assert torch.equal(getattr(p_state, name),
                               getattr(k_state, name).cpu()), (f, name)
        assert torch.equal(p_emit, k_emit.cpu()), f
        assert torch.equal(p_out, k_out.cpu()), f
        assert torch.allclose(p_state.mean, k_state.mean.cpu(), rtol=2e-4,
                              atol=2e-3), f
    assert assignment_kernel.two_stage_launches == before + len(frames)
    assert int(p_emit.sum()) > 0


def _jv_both(dev_kind, prob, maxd_b=0.7):
    """K4 and K5 on one problem: (cascade, (match_a, match_b))."""
    cost_a, levels, rows_a, cols, maxd_a, cost_b, rows_b = prob
    args = [v.to(dev_kind) for v in prob]
    cascade = assignment_kernel.solve_cascade_assignment_fused(*args[:5])
    two = assignment_kernel.solve_two_stage_assignment_fused(*args, maxd_b)
    return cascade.cpu(), tuple(m.cpu() for m in two)


def _jv_equal(cuda_device, prob):
    got_c, got_two = _jv_both(cuda_device, prob)
    staged = assignment_kernel.last_staged
    want_c, want_two = _jv_both("cpu", prob)
    assert torch.equal(got_c, want_c)
    for g, w in zip(got_two, want_two):
        assert torch.equal(g, w)
    return want_c, want_two, staged


# (R, C): the runner's columns NC = R + C at the warp and slot edges (32,
# 33: one slot or two; 128 / 129, 192 / 193, 256 / 257: the last column of
# the 4-, 6- and 8-slot classes and one over; 512: the last register
# class, whose cost blocks exceed shared memory) and past them (600: the
# lane-major shared-memory runner, costs in device memory)
@pytest.mark.parametrize("rc,staged", [((20, 12), True), ((21, 12), True),
                                       ((64, 64), True), ((65, 64), True),
                                       ((128, 64), True), ((129, 64), True),
                                       ((128, 128), True), ((129, 128), True),
                                       ((256, 256), False),
                                       ((400, 200), False)])
def test_jv_runner_at_slot_edges(cuda_device, rc, staged):
    prob = jv_problem(np.random.default_rng(sum(rc)), 2, *rc)
    want_c, want_two, got_staged = _jv_equal(cuda_device, prob)
    assert got_staged == staged  # the device-memory branch where it must
    assert (want_c >= 0).any() and (want_two[1] >= 0).any()


@pytest.mark.parametrize("seed", range(5))
def test_jv_kernels_exact_ties_at_several_seeds(cuda_device, seed):
    prob = jv_problem(np.random.default_rng(100 + seed), 8, 128, 64)
    want_c, want_two, staged = _jv_equal(cuda_device, prob)
    assert staged and (want_c >= 0).any() and (want_two[0] >= 0).any()


@pytest.mark.parametrize("case", ["no_active_row", "rows_all_ineligible",
                                  "no_column"])
def test_jv_kernels_single_stream_edges(cuda_device, case):
    """S = 1 problems: no active row (n_active = 0), rows whose every column
    is ineligible (they take their dummies: -1), no eligible column."""
    prob = jv_problem(np.random.default_rng(7), 1, 40, 20)
    cost_a, levels, rows_a, cols, maxd_a, cost_b, rows_b = prob
    if case == "no_active_row":
        rows_a[:] = False
        rows_b[:] = False
    elif case == "rows_all_ineligible":
        cost_a[0, :10] = 1e5
        cost_b[0, :10] = 1e5
        rows_a[0, :10] = True
        rows_b[0, :10] = True
    else:
        cols[:] = False
    want_c, want_two, _ = _jv_equal(cuda_device, prob)
    if case == "rows_all_ineligible":
        assert (want_c[0, :10] < 0).all() and (want_two[1][0, :10] < 0).all()
        assert (want_c >= 0).any()
    else:
        assert (want_c < 0).all() and (want_two[1] < 0).all()


# (max_tracks, max_dets): NC = T + D at the runner's slot edges; 256 x 256
# exceeds shared memory, so its (T, D) blocks go through device memory
@pytest.mark.parametrize("td,staged", [((16, 16), True), ((17, 16), True),
                                       ((64, 64), True), ((65, 64), True),
                                       ((128, 64), True), ((129, 64), True),
                                       ((256, 256), False)])
def test_tracker_kernel_at_slot_edges(cuda_device, td, staged):
    t, d = td
    s, n_obj = 2, min(d, 3 * t // 4)
    cfg = TrackerConfig(max_dets=d, feat_dim=64, max_tracks=t, nn_budget=3,
                        max_age=4)
    k_state = init_tracker_state(cfg, s, cuda_device)
    p_state = init_tracker_state(cfg, s, "cpu")
    rng = np.random.default_rng(t + d)
    confirmed = 0
    for f, args in enumerate(_scene(rng, s, n_obj, 8, d, 64, 0.2)):
        p_state, p_out, p_emit = tracker_kernel.tracker_step_fused_batched(
            cfg, p_state, *args, (240, 320))
        k_state, k_out, k_emit = tracker_kernel.tracker_step_fused_batched(
            cfg, k_state, *(a.to(cuda_device) for a in args), (240, 320))
        assert tracker_kernel.last_staged == staged
        for name in DISCRETE:
            assert torch.equal(getattr(p_state, name),
                               getattr(k_state, name).cpu()), (f, name)
        assert torch.equal(p_emit, k_emit.cpu()), f
        assert torch.equal(p_out[..., 4], k_out[..., 4].cpu()), f
        assert (p_out[..., :4] - k_out[..., :4].cpu()).abs().max() <= 1
        assert torch.allclose(p_state.mean, k_state.mean.cpu(), rtol=2e-4,
                              atol=2e-3), f
        confirmed = int((p_state.state == 2).sum())
    assert confirmed > 0


def test_tracker_kernel_without_detections(cuda_device):
    """A frame with no valid detection (stage A and B with no eligible
    column) on a state with confirmed tracks: every track coasts."""
    cfg = TrackerConfig(max_dets=8, feat_dim=64, max_tracks=16, nn_budget=3)
    k_state = init_tracker_state(cfg, 1, cuda_device)
    p_state = init_tracker_state(cfg, 1, "cpu")
    frames = list(_scene(np.random.default_rng(3), 1, 6, 6, 8, 64, 0.0))
    empty = [a.clone() for a in frames[-1]]
    empty[3][:] = False
    for f, args in enumerate(frames + [empty]):
        p_state, p_out, p_emit = tracker_kernel.tracker_step_fused_batched(
            cfg, p_state, *args, (240, 320))
        k_state, k_out, k_emit = tracker_kernel.tracker_step_fused_batched(
            cfg, k_state, *(a.to(cuda_device) for a in args), (240, 320))
        for name in DISCRETE:
            assert torch.equal(getattr(p_state, name),
                               getattr(k_state, name).cpu()), (f, name)
        assert torch.equal(p_emit, k_emit.cpu()), f
    assert int((p_state.time_since_update == 1).sum()) > 0


def bf16_ulps(got, want, floor=2.0 ** -6):
    """max |got - want| in bf16 ulps of max(|want|, floor), in f32."""
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=floor))) - 7)
    return float(((got - want).abs() / ulp).max())


@pytest.mark.parametrize("shape", [
    # n, hi, ci, co, k, stride, act
    (8, 26, 256, 512, 3, 1, "leaky"),
    (8, 52, 256, 512, 3, 2, "leaky"),    # stride 2 read by index
    (8, 13, 1024, 255, 1, 1, "linear"),  # yolo head: ragged column tile
    (3, 13, 384, 136, 1, 1, "mish"),     # ragged rows, Ci and Co off the tile
])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_f32_input"])
def test_conv_kernel_vs_plain(cuda_device, shape, mode):
    """Kernel 7 against its plain versions: bf16 mode within 2 bf16 ulps
    (same exact products, another order of f32 sums); int8 mode exactly
    equal (exact int32 sums, same f32 epilogue; the kernel's mish is
    another form than the plain version's and is held to 1 bf16 ulp)."""
    n, hi, ci, co, k, stride, act = shape
    rng = np.random.default_rng(hi + ci + co)
    x = torch.from_numpy(rng.standard_normal((n, hi, hi, ci), np.float32))
    w = rng.standard_normal((k, k, ci, co), np.float32) / np.sqrt(k * k * ci)
    b = torch.from_numpy(rng.standard_normal((co,), np.float32)).to(
        cuda_device)
    pad = (k - 1) // 2
    kw = dict(stride=stride, pad=pad, act=act)
    before = conv_kernel.launches
    if mode == "bf16":
        xd = x.to(cuda_device, torch.bfloat16)
        wd = torch.from_numpy(w.astype(np.float32)).to(cuda_device,
                                                       torch.bfloat16)
        got = conv_kernel.conv_bf16(xd, wd, b, **kw)
        want = conv_kernel.conv_plain_bf16(xd, wd, b, **kw)
        assert bf16_ulps(got.float(), want.float()) <= 2
    else:
        xd = x.to(cuda_device, torch.bfloat16 if mode == "int8"
                  else torch.float32)
        ws = (np.abs(w).reshape(-1, co).max(0) / 127).astype(np.float32)
        wq = torch.from_numpy(np.clip(np.rint(w / ws), -127, 127).astype(
            np.int8)).to(cuda_device)
        xs = np.float32(np.abs(x.numpy()).max() / 127)
        scale = torch.from_numpy(xs * ws).to(cuda_device)
        xinv = np.float32(1.0 / xs)
        got = conv_kernel.conv_int8(xd, wq, b, scale, xinv, **kw)
        want = conv_kernel.conv_plain_int8(xd, wq, b, scale, xinv, **kw)
        if act == "mish":
            assert bf16_ulps(got.float(), want.float()) <= 1
        else:
            assert torch.equal(got, want)
    assert conv_kernel.launches == before + 1
    assert got.shape == (n, hi // stride, hi // stride, co)
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [
    # n, h, w, ci, co, k, stride, act, f32 out
    (16, 128, 64, 8, 64, 3, 1, "relu", False),    # a ReID stem, Ci padded
    (16, 64, 32, 64, 128, 3, 2, "relu", False),   # conv1 of a down block
    (16, 32, 16, 128, 128, 3, 1, "linear", True),  # conv2, f32 out
    (16, 64, 32, 64, 128, 1, 2, "linear", True),  # projection, f32 out
    (16, 64, 32, 32, 32, 3, 1, "elu", False),     # the 128-d net's ELU
    (2, 416, 416, 8, 32, 3, 1, "leaky", False),   # yolov3 layer 0, padded
    (2, 208, 208, 64, 32, 1, 1, "leaky", False),
])
def test_conv_kernel_default_path_forms_vs_plain(cuda_device, shape):
    """The forms the default bf16 forwards give kernel 7: the ReLU and ELU
    codes within 2 bf16 ulps of the plain version, the f32-output form
    (mode 3) within 2^-13 of max(|want|, 1), at the ReID nets' and the
    large early detector layers' shapes."""
    n, h, w_, ci, co, k, stride, act, f32_out = shape
    rng = np.random.default_rng(h + ci + co)
    x = torch.from_numpy(rng.standard_normal((n, h, w_, ci), np.float32)).to(
        cuda_device, torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((k, k, ci, co), np.float32)
                          / np.sqrt(k * k * ci)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((co,), np.float32)).to(
        cuda_device)
    kw = dict(stride=stride, pad=(k - 1) // 2, act=act,
              out_dtype=torch.float32 if f32_out else torch.bfloat16)
    before = conv_kernel.launches
    got = conv_kernel.conv_bf16(x, w, b, **kw)
    want = conv_kernel.conv_plain_bf16(x, w, b, **kw)
    assert conv_kernel.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    if f32_out:
        assert float(((got - want).abs() / want.abs().clamp(min=1.0)).max()
                     ) <= 2.0 ** -13
    else:
        assert bf16_ulps(got.float(), want.float()) <= 2


def _check_mish_bf16(got, y):
    """The bf16 mish of the sums ``y``: float64 mish rounded to bf16 (ties
    to even) wherever it lies more than ``MAX_ULPS`` float32 ulps from a
    bf16 rounding midpoint, within one bf16 ulp of it elsewhere; below y =
    -80, within ``TINY_ABS`` and one bf16 ulp (the bounds of
    ``tests/test_torch_port_mish_form.py``). -> the count near a
    midpoint."""
    want = MF.mish64(y)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    got, want, y = got[keep], want[keep], y[keep]
    bits = want.astype(np.float32).view(np.uint32)
    rne = (((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16).view(
        np.float32)
    mid = ((bits & 0xFFFF0000) | 0x8000).view(np.float32)
    bf16_ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                   2.0 ** -126))) - 7)
    with np.errstate(invalid="ignore"):  # inf - inf at y = inf
        err = np.abs(got.astype(np.float64) - want)
        far = ~(np.abs(want - mid) <= MF.MAX_ULPS * MF.f32_ulp(want))
    low = y < -80
    assert (err[low] <= MF.TINY_ABS + bf16_ulp[low]).all()
    far &= ~low
    assert np.array_equal(got[far], rne[far])
    near = ~low & ~far
    assert (err[near] <= bf16_ulp[near]).all()
    return int(near.sum())


@pytest.mark.parametrize("case", ["bf16", "bf16_biased", "int8"])
def test_conv_kernel_mish_against_float64(cuda_device, case):
    """Kernel 7's mish epilogue (one exponential and one division) as an
    identity 1x1 conv, Ci = Co = 8, each row one input in all 8 channels:
    ``bf16`` every bf16 value, bias 0; ``bf16_biased`` the same inputs
    under 8 launches of seeded per-column f32 biases (2^22 f32 sums);
    ``int8`` the int8 mode through its scale, the codes -127..127 (xinv 1)
    under 32 launches of seeded per-column scales and biases. The sums the
    epilogue activates are the linear f32-output form's (bf16) or the f32
    steps the epilogue takes (int8). The bf16 output follows float64 mish
    by the midpoint rule (``_check_mish_bf16``); the f32 output form is
    held to the CPU mirror's bounds (``check_against_float64``)."""
    dev = cuda_device
    rng = np.random.default_rng(28)
    eye = torch.eye(8).reshape(1, 1, 8, 8)
    got_b, got_f, sums = [], [], []
    before = (conv_kernel.launches, conv_kernel.launches_mish)
    if case == "int8":
        codes = np.arange(-127, 128, dtype=np.float32)
        x = torch.from_numpy(np.repeat(codes[:, None], 8, 1)).reshape(
            1, 1, 255, 8).to(dev, torch.bfloat16)
        wq = eye.to(dev, torch.int8)
        for _ in range(32):
            scale = rng.uniform(0.05, 0.9, 8).astype(np.float32)
            b = rng.uniform(-40, 25, 8).astype(np.float32)
            out = conv_kernel.conv_int8(
                x, wq, torch.from_numpy(b).to(dev),
                torch.from_numpy(scale).to(dev), 1.0, pad=0, act="mish")
            got_b.append(out.float().cpu().numpy().reshape(-1))
            sums.append((codes[:, None] * scale + b).reshape(-1))
        launched = mish = 32
    else:
        v = (np.arange(2 ** 16, dtype=np.uint32) << 16).view(np.float32)
        x = torch.from_numpy(np.repeat(v[:, None], 8, 1)).reshape(
            1, 256, 256, 8).to(dev, torch.bfloat16)
        w = eye.to(dev, torch.bfloat16)
        biases = ([np.zeros(8, np.float32)] if case == "bf16" else
                  [rng.uniform(-4, 4, 8).astype(np.float32)
                   for _ in range(8)])
        for b in biases:
            bd = torch.from_numpy(b).to(dev)
            kw = dict(pad=0, out_dtype=torch.float32)
            sums.append(conv_kernel.conv_bf16(
                x, w, bd, act="linear", **kw).cpu().numpy().reshape(-1))
            got_f.append(conv_kernel.conv_bf16(
                x, w, bd, act="mish", **kw).cpu().numpy().reshape(-1))
            got_b.append(conv_kernel.conv_bf16(
                x, w, bd, pad=0, act="mish").float().cpu().numpy().reshape(
                    -1))
        launched, mish = 3 * len(biases), 2 * len(biases)
    assert (conv_kernel.launches - before[0],
            conv_kernel.launches_mish - before[1]) == (launched, mish)
    y = np.concatenate(sums)
    near = _check_mish_bf16(np.concatenate(got_b), y)
    worst = (MF.check_against_float64(np.concatenate(got_f), y) if got_f
             else None)
    print(f"mish {case}: {y.size} sums, {near} near a bf16 midpoint, "
          f"worst f32 ulps {worst}")


def test_bf16_layer_route_pads_and_counts(cuda_device):
    """``models/layers.conv_layer_bf16`` on the card: a 3-channel input is
    zero-padded to 8 (weights packed once, padded), one kernel 7 launch a
    call, and the result equals the plain version on the CPU within 2 bf16
    ulps; the packed weights are kept until the weights change."""
    from yolo_deepsort_tpu_torch.models.layers import (Conv2d,
                                                       conv_layer_bf16,
                                                       kernel_weights)

    torch.manual_seed(0)
    conv = Conv2d(3, 16, 3, 1, 1).to(torch.bfloat16)
    assert conv.bias.dtype == torch.float32
    x = torch.randn(2, 32, 32, 3).to(torch.bfloat16)
    want = conv_layer_bf16(conv, x, "leaky")
    conv = conv.to(cuda_device)
    before = conv_kernel.launches
    got = conv_layer_bf16(conv, x.to(cuda_device), "leaky")
    assert conv_kernel.launches == before + 1
    assert kernel_weights(conv).ci == 8
    assert bf16_ulps(got.float().cpu(), want.float()) <= 2
    packed = kernel_weights(conv)
    assert kernel_weights(conv) is packed
    with torch.no_grad():
        conv.weight.mul_(2)
    assert kernel_weights(conv) is not packed


def test_conv_kernel_refuses_non_contiguous_input(cuda_device):
    x = torch.zeros((2, 128, 8, 8), dtype=torch.bfloat16, device=cuda_device)
    w = torch.zeros((1, 1, 128, 128), dtype=torch.bfloat16,
                    device=cuda_device)
    b = torch.zeros((128,), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        # an NCHW-contiguous tensor seen as NHWC: not channels_last memory
        conv_kernel.conv_bf16(x.permute(0, 2, 3, 1), w, b, pad=0)


def test_k1_step_launch_counts(cuda_device):
    """A small ``make_batched_step`` on the card (yolov3-tiny at 64, bf16,
    cap and crop window, every eligible conv routed, some through the int8
    package): per step K1 1, K2 0, the dense crops 1, K3 1 and K7 once per
    conv of the ReID net, and once per conv of the bf16 detector (the
    routed layers in their modes, every other one in bf16 mode: the bf16
    forwards' default) at the first step, which runs the detector eagerly,
    and the second, which captures its graph; the third replays it."""
    from specs.weights_np import random_darknet_weights
    from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
    from yolo_deepsort_tpu_torch.config import DetectorConfig
    from yolo_deepsort_tpu_torch.models.darknet import build_network
    from yolo_deepsort_tpu_torch.models.quantize_darknet import (
        quantize_darknet_from_frames,
    )
    from yolo_deepsort_tpu_torch.models.reid import random_reid_params
    from yolo_deepsort_tpu_torch.parallel import streams
    from yolo_deepsort_tpu_torch.parallel.streams import (
        init_stream_states,
        make_batched_step,
    )
    from yolo_deepsort_tpu_torch.weights import (
        darknet_from_raw,
        load_darknet_weights,
        reid_from_params,
    )

    h, w, s, size = 64, 128, 2, 64
    plan = build_network(ARCHITECTURES["yolov3-tiny"](img_size=size))
    blob = random_darknet_weights(plan.defs(), seed=0, well_conditioned=True)
    _, raw = load_darknet_weights(blob, plan.defs())
    frames = np.random.default_rng(0).integers(0, 256, (s, h, w, 3), np.uint8)
    on_card = torch.from_numpy(frames).to(cuda_device)
    # calibration runs where its detector lies: on the card here, and from
    # the same weights it packages the CPU calibration's ``wq``
    pkg = quantize_darknet_from_frames(
        darknet_from_raw(plan, raw).to(cuda_device), on_card, size,
        k3_only=True)
    on_cpu = quantize_darknet_from_frames(darknet_from_raw(plan, raw), frames,
                                          size, k3_only=True)
    assert set(pkg) == set(on_cpu)
    for idx in pkg:
        assert pkg[idx]["wq"].tobytes() == on_cpu[idx]["wq"].tobytes()
        np.testing.assert_allclose(pkg[idx]["xinv"], on_cpu[idx]["xinv"],
                                   rtol=1e-4)
    cl = torch.channels_last
    detector = darknet_from_raw(plan, raw).to(cuda_device, torch.bfloat16,
                                              memory_format=cl)
    reid = reid_from_params(random_reid_params(0)).to(
        cuda_device, torch.bfloat16, memory_format=cl)
    det_cfg = DetectorConfig(img_size=size, conf_thres=0.5, max_dets=8)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    step = make_batched_step(detector, reid, det_cfg, trk_cfg, (h, w), cap=6,
                             crop_window=(48, 64), use_pallas_conv=True,
                             backbone_int8_pkg=pkg)
    states = init_stream_states(trk_cfg, s)  # the card is the default
    assert states.mean.device.type == "cuda"
    routed = []
    impl = conv_kernel.make_backbone_conv_impl(int8_pkg=pkg)
    with torch.no_grad():
        detector(letterbox_kernel.letterbox_batch_fused(
            on_card, size, torch.bfloat16),
            conv_impl=lambda *a: routed.append(a[-1]) if impl(
                *a) is not None else None)
    assert len(routed) >= 3 and set(pkg) < set(routed)
    counters = ((letterbox_kernel, "launches"), (crops_kernel, "launches"),
                (crops_kernel, "launches_dense"),
                (tracker_kernel, "launches"), (conv_kernel, "launches"),
                (streams, "detector_eager_launches"),
                (streams, "detector_capture_launches"),
                (streams, "detector_graph_launches"))
    n_det, n_reid = (sum(isinstance(m, torch.nn.Conv2d)
                         for m in net.modules()) for net in (detector, reid))
    # (eager, capture, replay) and whether the detector's convs count
    for graph, counted in (([1, 0, 0], 1), ([0, 1, 1], 1), ([0, 0, 1], 0)):
        before = [getattr(m, a) for m, a in counters]
        states, (outputs, emit) = step(states, on_card)
        torch.cuda.synchronize()
        got = [getattr(m, a) - b for (m, a), b in zip(counters, before)]
        assert got == [1, 0, 1, 1, n_reid + counted * n_det] + graph, got
    assert outputs.shape == (s, 16, 5) and emit.shape == (s, 16)
    assert bool(torch.isfinite(states.mean).all())


@pytest.mark.parametrize("window", [(32, 40), (320, 192), (64, 128),
                                    (96, 160)])
def test_interleaved_crops_kernel_vs_plain_and_planar(cuda_device, window):
    """Kernel 6 against the plain version (1e-4, kernel 2's bound: the same
    rounding points) and against kernel 2 (exactly equal: the same f32 ops
    on the same taps). Boxes taller and wider than the window are included
    (the strip is cut shorter there), the last window is the whole frame,
    and a frame batch sliced at an odd byte offset exercises the unaligned
    staging copies."""
    rng = np.random.default_rng(5)
    b, d, h, w = 2, 9, 96, 160
    bw, bh = rng.uniform(2, 60, (b, d)), rng.uniform(2, 95, (b, d))
    x1, y1 = rng.uniform(-10, w, (b, d)), rng.uniform(-10, h, (b, d))
    boxes = np.clip(np.stack([x1, y1, x1 + bw, y1 + bh], -1), 0,
                    [w - 1, h - 1, w - 1, h - 1]).astype(np.float32)
    boxes = torch.from_numpy(boxes).to(cuda_device)
    flat = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (b * h * w * 3 + 7,), np.uint8)).to(cuda_device)
    for offset in (0, 7):
        frames = flat[offset:offset + b * h * w * 3].view(b, h, w, 3)
        before = (crops_kernel.launches, crops_kernel.launches_interleaved)
        got = crops_kernel.crops_cuda(frames, boxes, *window,
                                      interleaved=True)
        assert (crops_kernel.launches,
                crops_kernel.launches_interleaved) == (before[0],
                                                       before[1] + 1)
        planar = crops_kernel.crops_cuda(frames, boxes, *window)
        want = crops_kernel.crops_plain(frames, boxes, *window)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-4
        assert torch.equal(got, planar)


def test_crops_layout_is_read_at_the_call(cuda_device, monkeypatch):
    frames = _frames(8, 1, 64, 128, cuda_device)
    boxes = torch.tensor([[[10.0, 5.0, 40.0, 50.0]]], device=cuda_device)
    monkeypatch.setenv("YDT_CROPS_LAYOUT", "interleaved")
    before = (crops_kernel.launches, crops_kernel.launches_interleaved)
    a = crops_kernel.crop_and_normalize_fused(frames, boxes, 48, 64)
    monkeypatch.delenv("YDT_CROPS_LAYOUT")
    b = crops_kernel.crop_and_normalize_fused(frames, boxes, 48, 64)
    assert (crops_kernel.launches, crops_kernel.launches_interleaved) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(a, b)


# the crop family's shape classes: a frame 1080 rows tall whose row of
# W*3 = 999 bytes is not a multiple of 16; boxes 1, 127, 128, 129, 256, 257
# and 1080 rows tall (as wide, the last as wide as the frame), boxes at
# every frame edge, 1-pixel boxes, boxes that leave the frame
CLASS_H, CLASS_W = 1080, 333
SIDES = ((1, 1), (127, 127), (128, 128), (129, 129), (256, 256),
         (257, 257), (1080, 333))
STRIPS = (8, 16, 32, 64, 128)


def _strip_builds():
    """The crop kernels built once per strip height (``CROPS_STRIP_*``)."""
    from yolo_deepsort_tpu_torch.kernels import build

    return zip(STRIPS, build.load_variants(
        "crops", [crops_kernel.strip_defines(rows) for rows in STRIPS]))


def _class_boxes(b):
    h, w = CLASS_H, CLASS_W
    rows = []
    for f in range(b):
        per = []
        for i, (bh, bw) in enumerate(SIDES):
            t = ((i + f) % len(SIDES)) / (len(SIDES) - 1)
            x0, y0 = (w - bw) * t, (h - bh) * (1 - t)
            per.append([x0, y0, x0 + bw, y0 + bh])
        per += [[0, 0, 10, 10], [w - 10, 0, w, 20], [0, h - 5, 30, h],
                [w - 1, h - 1, w, h], [-5, -3, 2.5, 4.7],
                [0.2, 500 + f, w - 0.1, 500.5 + f], [50, 0, 50.5, h],
                [3.7, 9.2, 3.9, 9.4]]
        rows.append(per)
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("window", [(320, 192), (32, 40), (CLASS_H, CLASS_W)])
def test_crops_shape_classes_vs_plain(cuda_device, b, window):
    """Kernels 2 and 6 at the shape classes, with every strip height:
    kernel 2 within 1e-4 of its plain version (boxes larger than the
    window included: both sides truncate to the same window), kernel 6
    equal to kernel 2 bit for bit."""
    frames = _frames(11, b, CLASS_H, CLASS_W, cuda_device)
    boxes = torch.from_numpy(_class_boxes(b)).to(cuda_device)
    want = crops_kernel.crops_plain(frames, boxes, *window)
    served = crops_kernel.crops_cuda(frames, boxes, *window)
    torch.cuda.synchronize()
    assert (served - want).abs().max().item() <= 1e-4
    for rows, lib in _strip_builds():
        got = crops_kernel.crops_cuda(frames, boxes, *window, lib=lib)
        k6 = crops_kernel.crops_cuda(frames, boxes, *window,
                                     interleaved=True, lib=lib)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-4, rows
        assert torch.equal(k6, got), rows


@pytest.mark.parametrize("b", [1, 2])
def test_dense_crops_shape_classes_vs_plain(cuda_device, b):
    """The dense entry at the shape classes, with every strip height,
    against its plain version (``crop_and_normalize_batch`` at bf16) and
    against the per-frame ``crop_and_normalize`` on the card, bit for
    bit."""
    from yolo_deepsort_tpu_torch.ops.crops import (
        crop_and_normalize,
        crop_and_normalize_batch,
    )

    frames = _frames(12, b, CLASS_H, CLASS_W, cuda_device)
    boxes = torch.from_numpy(_class_boxes(b)).to(cuda_device)
    want = crop_and_normalize_batch(frames, boxes, torch.bfloat16)
    per_frame = torch.stack([crop_and_normalize(
        frames[i], boxes[i], compute_dtype=torch.bfloat16) for i in range(b)])
    assert torch.equal(want, per_frame)
    before = crops_kernel.launches_dense
    got = crops_kernel.crop_and_normalize_dense(frames, boxes)
    assert crops_kernel.launches_dense == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for rows, lib in _strip_builds():
        assert torch.equal(crops_kernel.crops_dense_cuda(
            frames, boxes, lib=lib), want), rows


def test_crops_stamped_build_computes_the_same(cuda_device):
    """The build with clock stamps (``CROPS_STAMPS``, read by
    ``tools/crops_phases.py``) gives the served build's crops bit for bit,
    and every stamp of a block is written in order."""
    import ctypes

    from yolo_deepsort_tpu_torch.kernels import build
    from yolo_deepsort_tpu_torch.tools.crops_phases import SLOTS, phases

    frames = _frames(15, 2, CLASS_H, CLASS_W, cuda_device)
    boxes = torch.from_numpy(_class_boxes(2)).to(cuda_device)
    (lib,) = build.load_variants("crops", [{"CROPS_STAMPS": 1}])
    lib.ydt_crops_stamps.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    for interleaved in (False, True):
        assert torch.equal(
            crops_kernel.crops_cuda(frames, boxes, 320, 192,
                                    interleaved=interleaved, lib=lib),
            crops_kernel.crops_cuda(frames, boxes, 320, 192,
                                    interleaved=interleaved))
    assert torch.equal(crops_kernel.crops_dense_cuda(frames, boxes, lib=lib),
                       crops_kernel.crops_dense_cuda(frames, boxes))
    rows = crops_kernel.STRIP_ROWS["dense"]
    n_blocks = boxes.shape[0] * boxes.shape[1] * (128 // rows)
    buf = torch.zeros(n_blocks * SLOTS, dtype=torch.int64, device=cuda_device)
    assert lib.ydt_crops_stamps(buf.data_ptr(), n_blocks * SLOTS) == 0
    st = buf.view(n_blocks, SLOTS).cpu().numpy().astype(np.float64)
    order = st[:, [0, 1, 2, 3] + list(range(6, 6 + rows // 4)) + [4]]
    assert (np.diff(order, axis=1) >= 0).all()
    assert phases(st, rows // 8)["life"] > 0


def test_dense_crops_served_shape_and_empty(cuda_device):
    """The dense entry at the K=1 shape (8 1080p frames, 40 boxes each, a
    full-frame box among them) bit for bit against its plain version, and
    a batch with no boxes."""
    from yolo_deepsort_tpu_torch.ops.crops import crop_and_normalize_batch

    rng = np.random.default_rng(13)
    frames = _frames(13, 8, 1080, 1920, cuda_device)
    x1, y1 = rng.uniform(0, 1700, (8, 40)), rng.uniform(0, 760, (8, 40))
    boxes = np.stack([x1, y1, x1 + rng.uniform(20, 220, x1.shape),
                      y1 + rng.uniform(40, 318, y1.shape)], -1)
    boxes[:, 0] = [0, 0, 1919, 1079]
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(cuda_device)
    got = crops_kernel.crop_and_normalize_dense(frames, boxes)
    assert torch.equal(got, crop_and_normalize_batch(frames, boxes,
                                                     torch.bfloat16))
    empty = crops_kernel.crop_and_normalize_dense(frames, boxes[:, :0])
    torch.cuda.synchronize()
    assert empty.shape == (8, 0, 128, 64, 3)


def test_crop_and_normalize_bf16_card_equals_cpu(cuda_device):
    """The port's ``crop_and_normalize`` at bf16 on the card against the
    same call on the CPU, bit for bit: the /255 must be a true division on
    both (PyTorch's CUDA division by a Python scalar multiplies by the
    reciprocal)."""
    from yolo_deepsort_tpu_torch.ops.crops import crop_and_normalize

    rng = np.random.default_rng(14)
    frame = rng.integers(0, 256, (192, 320, 3), np.uint8)
    xy = rng.uniform(0, 150, (20, 2))
    boxes = np.clip(np.concatenate([xy, xy + rng.uniform(2, 160, (20, 2))],
                                   1), 0, [319, 191, 319, 191])
    boxes = torch.from_numpy(boxes.astype(np.float32))
    frame = torch.from_numpy(frame)
    cpu = crop_and_normalize(frame, boxes, compute_dtype=torch.bfloat16)
    card = crop_and_normalize(frame.to(cuda_device), boxes.to(cuda_device),
                              compute_dtype=torch.bfloat16)
    assert torch.equal(card.cpu(), cpu)


def test_bf16_k1_step_card_equals_cpu(cuda_device):
    """The K=1 step with a bf16 ReID net (dense crops on the card, their
    plain version on the CPU) on the card against the same step built on the
    CPU: yolov3-tiny at 64, an f32 detector, 2 streams of 64x128, cap 6,
    window (48, 64), 4 static frames. Emit, ids and the discrete state
    exactly equal; boxes within 1 px (the f32 detector sums in another
    order on the card, so a Kalman mean can sit an ulp to either side of an
    integer)."""
    smoke = _load_smoke()
    before = crops_kernel.launches_dense
    assert smoke.check_small_k1(cuda_device) > 0
    assert crops_kernel.launches_dense == before + 4


def _load_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("frame_w,window,launched", [
    (120, (32, 40), (0, 1)), (128, None, (0, 1)), (128, (32, 40), (1, 0))],
    ids=["refused-frame", "no-window", "gated-frame"])
def test_chunk_crops_launch_once(cuda_device, frame_w, window, launched):
    """The chunk step's bf16 crops (``make_chunk_crops``, the bucketed
    track stage's) are one launch: the dense entry on a frame the
    reference's crop gate refuses (F8) and without a window (F3's dense
    branch), kernel 2 on a frame the gate takes; the dense entry bit for
    bit against its plain version on the card, kernel 2 within the crops
    tolerance."""
    from yolo_deepsort_tpu_torch.ops.crops import crop_and_normalize_batch
    from yolo_deepsort_tpu_torch.parallel.streams import make_chunk_crops

    rng = np.random.default_rng(16)
    b, d, h = 4, 6, 64
    x1, y1 = rng.uniform(0, frame_w - 2, (b, d)), rng.uniform(0, h - 2, (b, d))
    boxes = np.clip(np.stack([x1, y1, x1 + rng.uniform(1, 38, (b, d)),
                              y1 + rng.uniform(1, 30, (b, d))], -1), 0,
                    [frame_w - 1, h - 1, frame_w - 1, h - 1])
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(cuda_device)
    frames = _frames(16, b, h, frame_w, cuda_device)
    before = (crops_kernel.launches, crops_kernel.launches_dense)
    got = make_chunk_crops((h, frame_w), window, torch.bfloat16)(frames,
                                                                 boxes)
    assert (crops_kernel.launches - before[0],
            crops_kernel.launches_dense - before[1]) == launched
    torch.cuda.synchronize()
    if launched[1]:
        assert torch.equal(got, crop_and_normalize_batch(frames, boxes,
                                                         torch.bfloat16))
    else:
        want = crops_kernel.crops_plain(frames, boxes, *window)
        assert (got - want).abs().max().item() <= 1e-4


def test_dense_crops_f32_batch_equals_per_frame_on_card(cuda_device):
    """The monolithic step's f32 dense crops (``streams.dense_crops`` with
    ``batched``: one set of ops over the batch) equal the per-frame
    ``crop_and_normalize`` on the card, bit for bit, as on the CPU."""
    from yolo_deepsort_tpu_torch.ops.crops import crop_and_normalize
    from yolo_deepsort_tpu_torch.parallel.streams import dense_crops

    rng = np.random.default_rng(17)
    b, d, h, w = 3, 12, 270, 480
    frames = _frames(17, b, h, w, cuda_device)
    x1, y1 = rng.uniform(-5, w, (b, d)), rng.uniform(-5, h, (b, d))
    boxes = np.clip(np.stack([x1, y1, x1 + rng.uniform(1, w, (b, d)),
                              y1 + rng.uniform(1, h, (b, d))], -1), 0,
                    [w - 1, h - 1, w - 1, h - 1])
    boxes[:, 0] = [0, 0, w - 1, h - 1]
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(cuda_device)
    got = dense_crops(frames, boxes, torch.float32, batched=True)
    want = torch.stack([crop_and_normalize(frames[i], boxes[i])
                        for i in range(b)])
    assert torch.equal(got, want)


def test_small_scanned_step_card_equals_cpu(cuda_device):
    """The monolithic chunk step on the card against the same step on the
    CPU (``chip_smoke.check_small_scanned``: yolov3-tiny at 64, 2 x
    64x128, 2 chunks of K=3, both tracker branches): emit, ids and the
    discrete state exactly equal, boxes within 1 px, and per chunk K1 1,
    the dense crops 1, K2 0, K3 3 or K5 3."""
    rows = _load_smoke().check_small_scanned(cuda_device)
    assert rows["fused"] > 0 and rows["fused"] == rows["tracker_step"]


def _int8_conv_case(seed, n, hi, wi, ci, co, k, dev, residual, stride):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (n, hi, wi, ci)).astype(np.int8)
    w = rng.normal(0, 0.4, (k, k, ci, co)).astype(np.float32)
    wscale = np.abs(w).reshape(-1, co).max(0) / 127.0
    wq = np.clip(np.rint(w / wscale), -127, 127).astype(np.int8)
    ho, wo = hi // stride, wi // stride
    res = (torch.from_numpy(rng.integers(
        -127, 128, (n, ho, wo, co)).astype(np.int8)).to(dev)
        if residual else None)
    return (torch.from_numpy(xq).to(dev), torch.from_numpy(wq).to(dev),
            torch.from_numpy((0.02 * wscale).astype(np.float32)).to(dev),
            torch.from_numpy(rng.normal(0, 0.1, co).astype(np.float32)).to(
                dev),
            np.float32(1.0 / 0.05), res,
            np.float32(0.03) if residual else None)


INT8_CASES = [
    # (n, hi, wi, ci, co, k, stride, relu, out_int8, residual)
    (4, 8, 8, 128, 128, 3, 1, True, True, False),
    (4, 8, 8, 128, 128, 3, 1, True, True, True),
    (4, 8, 8, 64, 128, 3, 2, True, True, False),
    (8, 4, 4, 256, 256, 3, 1, True, False, True),    # f32 out (last conv)
    (4, 8, 8, 128, 256, 1, 2, False, True, False),   # 1x1 downsample
    (3, 6, 10, 48, 80, 3, 1, True, True, True),      # ragged tile edges
    (3, 6, 10, 16, 144, 1, 1, False, False, False),  # Ci below a depth step
    (40, 32, 16, 128, 128, 3, 1, True, True, True),  # the 128-row tile
    (40, 8, 4, 512, 512, 3, 1, True, False, True),   # the deepest class
]


@pytest.mark.parametrize("case", INT8_CASES)
def test_conv_int8_kernel_vs_plain(cuda_device, case):
    """Kernel 8 against its plain version: int8 codes exactly equal (int32
    sums are exact and the f32 epilogue is the same op sequence without
    FMA), f32 outputs likewise equal, held to 1e-5 relative."""
    n, hi, wi, ci, co, k, stride, relu, out_int8, residual = case
    args = _int8_conv_case(3, n, hi, wi, ci, co, k, cuda_device, residual,
                           stride)
    kw = dict(stride=stride, pad=(k - 1) // 2, relu=relu, out_int8=out_int8)
    before = conv_int8_kernel.launches
    got = conv_int8_kernel.conv_int8(*args, **kw)
    assert conv_int8_kernel.launches == before + 1
    want = conv_int8_kernel.conv_int8_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(want.float().abs().max() > 0)
    if out_int8:
        assert torch.equal(got, want)
    else:
        assert bool(((got - want).abs()
                     <= 1e-5 * want.abs().clamp(min=1e-3)).all())


def test_conv_int8_kernel_refuses_what_it_does_not_take(cuda_device):
    args = _int8_conv_case(3, 2, 4, 4, 24, 32, 3, cuda_device, False, 1)
    with pytest.raises(ValueError, match="multiples of 16"):
        conv_int8_kernel.conv_int8(*args)
    args = _int8_conv_case(3, 2, 4, 4, 32, 32, 3, cuda_device, False, 1)
    with pytest.raises(ValueError, match="contiguous"):
        conv_int8_kernel.conv_int8(args[0].transpose(1, 2), *args[1:])


def test_reid_resident_forward_card_vs_cpu(cuda_device):
    """``reid_apply_int8_resident`` with kernel 8 on the card against the
    plain version on the CPU, one package, bf16 front on both: the fronts
    differ by bf16 roundings of differently ordered sums, which flip int8
    codes at the first quantize; features agree to cosine > 0.999."""
    from yolo_deepsort_tpu_torch.models import quantize as Q
    from yolo_deepsort_tpu_torch.models.reid import random_reid_params
    from yolo_deepsort_tpu_torch.weights import reid_int8_package_to_torch

    rng = np.random.default_rng(11)
    calib = rng.normal(0, 1, (16, 128, 64, 3)).astype(np.float32)
    x = torch.from_numpy(rng.normal(0, 1, (24, 128, 64, 3)).astype(
        np.float32))
    pkg = Q.quantize_reid_params_resident(random_reid_params(3), calib)
    before = conv_int8_kernel.launches
    card = Q.reid_apply_int8_resident(
        reid_int8_package_to_torch(pkg), x.to(cuda_device),
        use_pallas=True)
    assert conv_int8_kernel.launches == before + 15
    plain_card = Q.reid_apply_int8_resident(
        reid_int8_package_to_torch(pkg), x.to(cuda_device))
    cpu = Q.reid_apply_int8_resident(
        reid_int8_package_to_torch(pkg, "cpu"), x, use_pallas=True)
    assert card.shape == (24, 512) and bool(torch.isfinite(card).all())
    # same front on the card: kernel and plain stages give equal features
    assert (card - plain_card).abs().max().item() <= 1e-6
    assert (card.cpu() * cpu).sum(1).min().item() > 0.999


def _chain_case(seed, n, h, ci, cm, nblk, dev, act="leaky"):
    """Seeded operands of one chain on the card, bf16 and W8A8."""
    case = resblock_kernel.seeded_chain_case(
        np.random.default_rng(seed), dev, n, h, ci, cm, nblk, act)
    return case["bf16"], case["int8"]


@pytest.mark.parametrize("shape", [
    # n, h, ci, cm, nblk, act
    (8, 52, 256, 128, 8, "leaky"),    # the three chain classes of yolov3-416
    (8, 26, 512, 256, 8, "leaky"),
    (8, 13, 1024, 512, 4, "leaky"),   # ragged 13x13 strips, columns split
    (32, 52, 256, 128, 8, "leaky"),   # the chunked step's batch: a work item
    (32, 26, 512, 256, 8, "leaky"),   # loops over several column tiles
    (32, 13, 1024, 512, 4, "leaky"),
    (3, 13, 128, 128, 2, "mish"),
    (2, 20, 256, 128, 1, "leaky"),    # one block: no scratch buffer
])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_resblock_chain_kernel_vs_plain(cuda_device, shape, mode):
    """Kernel 9 against its plain versions. int8 mode with a leaky
    activation: exactly equal (exact int32 sums, the same f32 epilogue,
    ``mid`` quantized from the same bf16 values). bf16 mode: f32 sums in
    another order move bf16 roundings and a chain compounds them: every
    element inside the reference's elementwise bound rtol = atol = 3e-2
    (``CHAIN_TOL``; the operands keep the chain state of order 1). The
    kernel's mish is another form than the plain version's: held to the
    bf16 bound in both modes."""
    n, h, ci, cm, nblk, act = shape
    bf16, int8 = _chain_case(h + ci + nblk, n, h, ci, cm, nblk, cuda_device,
                             act)
    sched = resblock_kernel.plan_chain_schedule(n, h, h, ci, cm, nblk,
                                                mode == "int8")
    assert sched.kernel_launches == 2 * nblk, "two kernels per block"
    before = resblock_kernel.launches
    before_kernels = resblock_kernel.device_kernels
    if mode == "bf16":
        got = resblock_kernel.resblock_chain_bf16(*bf16, act=act)
        want = resblock_kernel.resblock_chain_plain_bf16(*bf16, act=act)
    else:
        got = resblock_kernel.resblock_chain_int8(*int8, act=act)
        want = resblock_kernel.resblock_chain_plain_int8(*int8, act=act)
    torch.cuda.synchronize()
    assert resblock_kernel.launches == before + 1, "one launch per chain"
    assert resblock_kernel.device_kernels == before_kernels + 2 * nblk
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(want.float().abs().max() > 0)
    if mode == "int8" and act == "leaky":
        assert torch.equal(got, want)
    else:
        assert resblock_kernel.chain_outside_tol(got, want) == 0


@pytest.mark.parametrize("n,h,ci,cm,nblk", [(8, 52, 256, 128, 8),
                                            (8, 26, 512, 256, 8),
                                            (32, 13, 1024, 512, 4)])
def test_resblock_one_block_within_four_ulps_of_its_operands(cuda_device, n,
                                                            h, ci, cm, nblk):
    """Every block of a chain alone, in bf16 mode, fed the plain chain's
    state: the 3x3 conv's result y is within the conv kernel's 2 bf16 ulps
    of ITS magnitude, and |y| <= |x| + |out|, so the block's output is held
    to 4 bf16 ulps of max(|x|, |out|, 2^-3) (``chain_block_ulps``; where the
    shortcut add cancels, the ulp of |out| itself says nothing), and every
    element lies inside rtol = atol = 3e-2."""
    bf16, _ = _chain_case(5, n, h, ci, cm, nblk, cuda_device)
    state = bf16[0]
    for b in range(nblk):
        one = tuple(a[b:b + 1] for a in bf16[1:])
        got = resblock_kernel.resblock_chain_bf16(state, *one)
        want = resblock_kernel.resblock_chain_plain_bf16(state, *one)
        assert resblock_kernel.chain_block_ulps(got, want, state) <= \
            resblock_kernel.CHAIN_BLOCK_ULPS, b
        assert resblock_kernel.chain_outside_tol(got, want) == 0, b
        state = want


@pytest.mark.parametrize("nblk", [2, 3])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_resblock_chain_of_even_and_odd_length(cuda_device, nblk, mode):
    """The chain state goes through two buffers in turn (the output and one
    scratch buffer, the last block writing the output), whatever the
    chain's parity: the kernel with packed weights equals its plain version
    (int8 exactly, bf16 inside CHAIN_TOL), the raw weights give the same
    bits as the packed ones, and the input is left as it was."""
    bf16, int8 = _chain_case(40 + nblk, 2, 26, 256, 128, nblk, cuda_device)
    args = bf16 if mode == "bf16" else int8
    fn = (resblock_kernel.resblock_chain_bf16 if mode == "bf16"
          else resblock_kernel.resblock_chain_int8)
    plain = (resblock_kernel.resblock_chain_plain_bf16 if mode == "bf16"
             else resblock_kernel.resblock_chain_plain_int8)
    x0 = args[0].clone()
    got = fn(*resblock_kernel.pack_chain_args(args))
    raw = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(args[0], x0), "the chain's input is not written"
    assert torch.equal(got, raw)
    if mode == "int8":
        assert torch.equal(got, want)
    else:
        assert resblock_kernel.chain_outside_tol(got, want) == 0
    # every block, one at a time, is the chain's own first block
    state = args[0]
    for b in range(nblk):
        one = tuple(a[b:b + 1] for a in args[1:])
        state = fn(state, *one)
    torch.cuda.synchronize()
    assert torch.equal(state, got), "a chain is its blocks one by one"


def test_resblock_int8_refuses_xinv_on_the_card(cuda_device):
    """``xinv`` is handed to the kernels by value: a CUDA tensor would have
    to be read back (a synchronizing copy), so the kernel path refuses it
    and says why."""
    _, int8 = _chain_case(7, 2, 13, 128, 128, 2, cuda_device)
    *args, xinv = int8
    before = resblock_kernel.launches
    with pytest.raises(ValueError, match="host memory"):
        resblock_kernel.resblock_chain_int8(*args, xinv.to(cuda_device))
    assert resblock_kernel.launches == before
    resblock_kernel.resblock_chain_int8(*args, xinv.numpy())
    assert resblock_kernel.launches == before + 1


def test_resblock_kernel_refuses_what_it_does_not_take(cuda_device):
    bf16, _ = _chain_case(6, 2, 8, 128, 128, 1, cuda_device)
    x, w1, b1, w2, b2 = bf16
    with pytest.raises(ValueError, match="contiguous"):
        # an NCHW-contiguous tensor seen as NHWC: not channels_last memory
        resblock_kernel.resblock_chain_bf16(
            x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), w1, b1,
            w2, b2)
    with pytest.raises(ValueError, match="no schedule"):
        resblock_kernel.resblock_chain_bf16(
            x[..., :64].contiguous(), w1[:, :64].contiguous(), b1, w2[
                ..., :64].contiguous(), b2[:, :64].contiguous())


def test_routed_darknet_forward_vs_unrouted(cuda_device):
    """yolov3 at 416 in bf16 on the card, batch 2: the chain route claims
    the three chains the gates leave (starts 13, 38, 63: one launch each),
    and the decoded output stays within 4e-2 of the unrouted forward
    (relative to each column's scale)."""
    from specs.weights_np import random_darknet_weights
    from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
    from yolo_deepsort_tpu_torch.models.darknet import build_network
    from yolo_deepsort_tpu_torch.weights import (
        darknet_from_raw,
        load_darknet_weights,
    )

    plan = build_network(ARCHITECTURES["yolov3"](img_size=416))
    blob = random_darknet_weights(plan.defs(), seed=0, well_conditioned=True)
    _, raw = load_darknet_weights(blob, plan.defs())
    model = darknet_from_raw(plan, raw).to(
        cuda_device, torch.bfloat16, memory_format=torch.channels_last)
    x = torch.from_numpy(np.random.default_rng(2).random(
        (2, 416, 416, 3), np.float32)).to(cuda_device, torch.bfloat16)
    impl = resblock_kernel.make_resblock_impl(plan)
    claimed = []

    def hook(xx, convs, i):
        res = impl(xx, convs, i)
        if res is not None:
            claimed.append((i, res[1]))
        return res

    before = resblock_kernel.launches
    with torch.no_grad():
        got = model(x, block_impl=hook)
        want = model(x)
    torch.cuda.synchronize()
    assert claimed == [(13, 24), (38, 24), (63, 12)]
    assert resblock_kernel.launches == before + 3
    scale = want.abs().amax((0, 1)).clamp(min=1.0)
    assert float(((got - want).abs() / scale).max()) <= 4e-2


@pytest.mark.parametrize("m,k,n", [(32768, 256, 256), (1000, 64, 128)])
def test_matmul_probe_kernel_vs_plain(cuda_device, m, k, n):
    """Kernel 10: int8 mode exactly equal to the plain version (floor
    division of negative sums included), bf16 mode within 1 bf16 ulp."""
    xb, wb, xi, wi = int8_probe.probe_operands(m, k, n, cuda_device)
    before = int8_probe.launches
    got_b, got_i = int8_probe.matmul_probe(xb, wb), int8_probe.matmul_probe(
        xi, wi)
    assert int8_probe.launches == before + 2
    want_b = int8_probe.matmul_probe_plain(xb, wb)
    want_i = int8_probe.matmul_probe_plain(xi, wi)
    torch.cuda.synchronize()
    assert got_i.dtype == torch.int8 and torch.equal(got_i, want_i)
    assert int((want_i < 0).sum()) > 0 and int((want_i > 0).sum()) > 0
    assert int8_probe.bf16_ulps(got_b, want_b) <= 1


def test_matmul_probe_floor_division_of_negative_sums(cuda_device):
    """A sum of -1 must give -1 (floor), not 0 (C's truncation); -8 K gives
    exactly -1 and 8 K - 1 gives 0."""
    k, n = 32, 128
    x = torch.zeros((3, k), dtype=torch.int8, device=cuda_device)
    w = torch.zeros((k, n), dtype=torch.int8, device=cuda_device)
    w[:, 0] = 1
    x[0, 0] = -1                       # sum -1
    x[1, :] = -8                       # sum -256 = -(8 * 32)
    x[2, :] = 8
    x[2, 0] = 7                        # sum 255 = 8 * 32 - 1
    got = int8_probe.matmul_probe(x, w)
    assert got[:, 0].tolist() == [-1, -1, 0]
    assert torch.equal(got, int8_probe.matmul_probe_plain(x, w))


@pytest.mark.parametrize("tile", list(int8_probe.PROBE_TILES))
def test_matmul_probe_every_tile_vs_plain(cuda_device, tile):
    """Every tile kernel 10 instantiates, as the plan sweep forces it, with
    a split of the depth where the steps allow: int8 exactly equal, bf16
    within 1 bf16 ulp."""
    m, k, n = 4100, 512, 256
    xb, wb, xi, wi = int8_probe.probe_operands(m, k, n, cuda_device)
    for x, w, es in ((xb, wb, 2), (xi, wi, 1)):
        wp = int8_probe.pack_probe_weight(w)
        steps = conv_plan.depth_steps(k, es)
        for split in (1, 2):
            plan = conv_plan.ConvPlan(*tile, min(3, steps // split), split)
            got = int8_probe.matmul_probe_cuda(x, wp, plan=plan)
            want = int8_probe.matmul_probe_plain(x, w)
            torch.cuda.synchronize()
            if es == 1:
                assert torch.equal(got, want), plan
            else:
                assert int8_probe.bf16_ulps(got, want) <= 1, plan
    with pytest.raises(ValueError, match="not one of"):
        int8_probe.matmul_probe_cuda(
            xb, int8_probe.pack_probe_weight(wb),
            plan=conv_plan.ConvPlan(128, 256, 3, 1))


# ---- the shared wgmma ring of kernels 7 and 8 (csrc/conv_mainloop.cuh) ----

ALL_TILES = list(conv_plan.TILES)


def _forced_plan(bm, bn, split, stages, depth, elem_bytes):
    """A plan the kernels take for this depth: the split cut down to the
    depth steps, the ring to what fits."""
    steps = conv_plan.depth_steps(depth, elem_bytes)
    return conv_plan.ConvPlan(
        bm, bn, min(stages, conv_plan.max_stages(bm, bn)), min(split, steps))


def _k7_case(seed, n, hi, ci, co, k, dev):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, hi, hi, ci), np.float32))
    w = rng.standard_normal((k, k, ci, co), np.float32) / np.sqrt(k * k * ci)
    ws = (np.abs(w).reshape(-1, co).max(0) / 127).astype(np.float32)
    xs = np.float32(np.abs(x.numpy()).max() / 127)
    return dict(
        x=x, b=torch.from_numpy(rng.standard_normal((co,), np.float32)).to(
            dev),
        w=torch.from_numpy(w.astype(np.float32)).to(dev, torch.bfloat16),
        wq=torch.from_numpy(np.clip(np.rint(w / ws), -127, 127).astype(
            np.int8)).to(dev),
        scale=torch.from_numpy(xs * ws).to(dev), xinv=np.float32(1.0 / xs))


def _k7_check(c, dev, mode, kw, plan):
    """Kernel 7 under ``plan`` against its plain version, tolerances as
    ``test_conv_kernel_vs_plain``."""
    if mode == "bf16":
        xd = c["x"].to(dev, torch.bfloat16)
        got = conv_kernel.conv_bf16_cuda(xd, c["w"], c["b"], plan=plan, **kw)
        want = conv_kernel.conv_plain_bf16(xd, c["w"], c["b"], **kw)
        torch.cuda.synchronize()
        assert bf16_ulps(got.float(), want.float()) <= 2, plan
    else:
        xd = c["x"].to(dev, torch.bfloat16 if mode == "int8"
                       else torch.float32)
        args = (xd, c["wq"], c["b"], c["scale"], c["xinv"])
        got = conv_kernel.conv_int8_cuda(*args, plan=plan, **kw)
        want = conv_kernel.conv_plain_int8(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan
    assert bool(want.float().abs().max() > 0)


@pytest.mark.parametrize("shape", [
    # n, hi, ci, co, k, stride
    (1, 13, 8, 136, 3, 1),    # a depth step spans taps (Ci = 8)
    (3, 7, 24, 255, 3, 1),    # rows off every tile, Co off by one
    (5, 6, 72, 136, 3, 2),    # a step ends inside a tap, stride 2
    (3, 2, 72, 64, 3, 2),     # stride 2 on a 2x2 map: one output pixel
    (5, 9, 16, 255, 1, 1),    # depth shorter than the ring
])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int8_f32_input"])
def test_conv_ring_edges(cuda_device, shape, mode):
    """What a ring and flat depth steps can break in kernel 7: rows that are
    a multiple of no tile, Ci of 8 / 24 / 72 (steps that span or end inside
    taps; in the int8 modes a 16-byte piece spans two taps), a depth shorter
    than the ring, Co of 136 and 255, stride 2 on a 2x2 map; under the
    planner's plan and under every tile with the depth split."""
    n, hi, ci, co, k, stride = shape
    c = _k7_case(hi + ci + co, n, hi, ci, co, k, cuda_device)
    kw = dict(stride=stride, pad=(k - 1) // 2, act="leaky")
    es = 2 if mode == "bf16" else 1
    _k7_check(c, cuda_device, mode, kw, None)
    for bm, bn in ALL_TILES:
        for split in (1, 2):
            _k7_check(c, cuda_device, mode, kw,
                      _forced_plan(bm, bn, split, 3, k * k * ci, es))


@pytest.mark.parametrize("tile", ALL_TILES)
@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_conv_every_forced_plan(cuda_device, tile, split, mode):
    """Kernel 7 at one 3x3 shape with several tiles each way, under every
    tile, split and two ring depths: equal to the plain version under the
    unchanged tolerances."""
    n, hi, ci, co, k = 3, 13, 256, 320, 3
    c = _k7_case(7, n, hi, ci, co, k, cuda_device)
    kw = dict(stride=1, pad=1, act="leaky")
    for stages in (2, 8):
        _k7_check(c, cuda_device, mode, kw, _forced_plan(
            *tile, split, stages, k * k * ci, 2 if mode == "bf16" else 1))


@pytest.mark.parametrize("tile", ALL_TILES)
@pytest.mark.parametrize("split", [1, 2, 4])
def test_conv_int8_every_forced_plan(cuda_device, tile, split):
    """Kernel 8 under every tile, split and two ring depths, at shapes whose
    rows and columns are multiples of no tile, Ci = 16 and 48 (a depth step
    ends inside a stage), a depth shorter than the ring and stride 2 on a 2x2
    map: int8 codes and the f32 output equal to the plain version's."""
    for n, hi, wi, ci, co, k, stride, out_int8, residual in [
            (5, 6, 10, 48, 144, 3, 1, True, True),
            (3, 8, 4, 16, 80, 3, 1, False, True),
            (1, 8, 4, 16, 32, 1, 1, True, False),
            (3, 2, 2, 48, 272, 3, 2, True, False),
            (5, 2, 2, 64, 128, 1, 2, True, False)]:
        args = _int8_conv_case(11, n, hi, wi, ci, co, k, cuda_device,
                               residual, stride)
        kw = dict(stride=stride, pad=(k - 1) // 2, relu=True,
                  out_int8=out_int8)
        want = conv_int8_kernel.conv_int8_plain(*args, **kw)
        assert bool(want.float().abs().max() > 0)
        for stages in (2, 8):
            plan = _forced_plan(*tile, split, stages, k * k * ci, 1)
            got = conv_int8_kernel.conv_int8_cuda(*args, plan=plan, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (plan, n, hi, wi, ci, co, k)


@pytest.mark.parametrize("tile", [(64, 64), (64, 128)])
def test_conv_ring_blocks_walk_several_tiles(cuda_device, tile):
    """The tiles two blocks to an SM take: with more tiles than the card holds
    blocks at once, a block walks several, ring and barrier phases running on
    from one tile into the next. Both kernels at shapes of hundreds of tiles
    (odd numbers of depth steps, so the ring wraps at another place in every
    tile), shallow and deep rings: equal to the plain versions."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n, hi, ci, co, k = 8, 52, 40, 136, 3
    assert -(-n * hi * hi // 64) > 2 * sms  # more tiles than blocks
    c = _k7_case(9, n, hi, ci, co, k, cuda_device)
    kw = dict(stride=1, pad=1, act="leaky")
    for stages in (2, 8):
        for mode in ("bf16", "int8"):
            _k7_check(c, cuda_device, mode, kw, _forced_plan(
                *tile, 1, stages, k * k * ci, 2 if mode == "bf16" else 1))
    args = _int8_conv_case(13, 96, 32, 16, 48, 128, 3, cuda_device, True, 1)
    want = conv_int8_kernel.conv_int8_plain(*args)
    for stages in (2, 3, 8):
        plan = _forced_plan(*tile, 1, stages, 9 * 48, 1)
        got = conv_int8_kernel.conv_int8_cuda(*args, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan


def test_conv_ring_two_streams_back_to_back(cuda_device):
    """Barrier state is per launch: the same conv launched many times on two
    streams at once, both kernels, gives the same result every time."""
    c = _k7_case(3, 8, 13, 512, 256, 3, cuda_device)
    xd = c["x"].to(cuda_device, torch.bfloat16)
    args8 = _int8_conv_case(5, 40, 8, 4, 256, 256, 3, cuda_device, True, 1)
    want7 = conv_kernel.conv_plain_bf16(xd, c["w"], c["b"])
    want8 = conv_int8_kernel.conv_int8_plain(*args8)
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for rep in range(6):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append((conv_kernel.conv_bf16(xd, c["w"], c["b"]),
                             conv_int8_kernel.conv_int8(*args8)))
    torch.cuda.synchronize()
    for got7, got8 in outs:
        assert bf16_ulps(got7.float(), want7.float()) <= 2
        assert torch.equal(got8, want8)


def test_conv_plan_of_the_card(cuda_device):
    """The wrappers plan for the card's own SM count, and a plan the kernels
    do not take is refused before any launch."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert conv_plan.plan_for(cuda_device, 1352, 1024, 4608, 2) \
        == conv_plan.plan_conv_tiles(1352, 1024, 4608, 2, sms)
    c = _k7_case(3, 1, 4, 16, 16, 1, cuda_device)
    xd = c["x"].to(cuda_device, torch.bfloat16)
    with pytest.raises(ValueError, match="conv plan"):
        conv_kernel.conv_bf16_cuda(xd, c["w"], c["b"], pad=0,
                                   plan=conv_plan.ConvPlan(96, 128, 4, 1))
    with pytest.raises(ValueError, match="conv plan"):
        conv_kernel.conv_bf16_cuda(xd, c["w"], c["b"], pad=0,
                                   plan=conv_plan.ConvPlan(64, 64, 4, 2))
