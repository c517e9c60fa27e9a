"""The tile planner and the weight packing of the port's two implicit-GEMM
conv kernels (``yolo_deepsort_tpu_torch/ops/conv_plan.py``), on the CPU: what
surrounds the CUDA kernels and decides their launch (tiles, ring depth,
depth split, weight layout) is plain Python and is held here; the kernels
themselves are held to their plain versions on the card
(``tests/test_torch_port_gpu.py``)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from yolo_deepsort_tpu_torch.ops import conv_int8_kernel, conv_kernel
from yolo_deepsort_tpu_torch.ops import conv_plan as CP
from yolo_deepsort_tpu_torch.ops.conv_plan_table import TUNED_132_SMS
from torch_port_threads import torch_threads  # noqa: F401

# the eligible conv shapes of yolov3-416 as the detector presents them to the
# conv route, (map, Ci, Co, k, stride), and the mish shape held beside them
BACKBONE_CLASSES = [
    (52, 256, 128, 1, 1), (52, 128, 256, 3, 1), (52, 256, 512, 3, 2),
    (26, 512, 256, 1, 1), (26, 256, 512, 3, 1), (26, 512, 1024, 3, 2),
    (13, 1024, 512, 1, 1), (13, 512, 1024, 3, 1), (13, 1024, 255, 1, 1),
    (13, 512, 256, 1, 1), (26, 768, 256, 1, 1), (26, 512, 255, 1, 1),
    (26, 256, 128, 1, 1), (52, 384, 128, 1, 1), (52, 256, 255, 1, 1),
]
# the int8-resident ReID embed's conv classes: (k, stride, h, w, Ci, Co)
REID_CLASSES = [
    (3, 2, 64, 32, 64, 128), (1, 2, 64, 32, 64, 128),
    (3, 1, 32, 16, 128, 128), (3, 2, 32, 16, 128, 256),
    (1, 2, 32, 16, 128, 256), (3, 1, 16, 8, 256, 256),
    (3, 2, 16, 8, 256, 512), (1, 2, 16, 8, 256, 512),
    (3, 1, 8, 4, 512, 512),
]


def _problems():
    """(m, co, depth, element bytes) of every class the smoke run times."""
    out = []
    for n in (8, 32):
        for hi, ci, co, k, stride in BACKBONE_CLASSES:
            m = n * (hi // stride) ** 2
            out += [(m, co, k * k * ci, 2), (m, co, k * k * ci, 1)]
    for crops in (320, 512):
        for k, stride, h, w, ci, co in REID_CLASSES:
            out.append((crops * (h // stride) * (w // stride), co,
                        k * k * ci, 1))
    return out


def _check_plan(plan, m, co, depth, es):
    bm, bn, stages, split = plan
    assert (bm, bn) in CP.TILES and split in CP.SPLITS
    # every output row and column lies in exactly one tile
    tiles = CP.plan_tiles(plan, m, co)
    rows = np.zeros(m, np.int64)
    cols = np.zeros(co, np.int64)
    for (r0, r1), (c0, c1) in tiles:
        assert 0 <= r0 < r1 <= m and r1 - r0 <= bm
        assert 0 <= c0 < c1 <= co and c1 - c0 <= bn
    row_ranges = sorted({t[0] for t in tiles})
    col_ranges = sorted({t[1] for t in tiles})
    assert len(tiles) == len(row_ranges) * len(col_ranges) == len(set(tiles))
    for r0, r1 in row_ranges:
        rows[r0:r1] += 1
    for c0, c1 in col_ranges:
        cols[c0:c1] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert len(tiles) == -(-m // bm) * -(-co // bn)
    # the ring fits the block's shared memory and the split divides the steps
    steps = CP.depth_steps(depth, es)
    assert steps == -(-depth * es // 128)
    assert 2 <= stages <= CP.MAX_STAGES
    assert CP.plan_smem_bytes(bm, bn, stages) <= CP.SMEM_PER_BLOCK == 232448
    assert steps % split == 0 and split <= steps
    assert stages <= max(2, steps // split)
    assert CP.check_plan(plan, depth, es) == plan


@pytest.mark.parametrize("problem", _problems())
def test_plan_of_every_smoke_class(problem):
    """``plan_conv_tiles`` at every shape class the smoke run times (the 15
    backbone classes at batch 8 and 32 in both element sizes, the nine ReID
    classes at 320 and 512 crops): the tiles cover every row and column
    exactly once, the ring fits 227 KB, the split divides the depth steps."""
    _check_plan(CP.plan_conv_tiles(*problem), *problem)


@settings(max_examples=200, deadline=None)
@given(m=st.integers(1, 200000), co=st.integers(1, 2048),
       k=st.sampled_from([1, 3]), ci8=st.integers(1, 256),
       es=st.sampled_from([1, 2]), sms=st.sampled_from([1, 108, 132, 144]))
def test_plan_of_drawn_shapes(m, co, k, ci8, es, sms):
    depth = k * k * ci8 * 8
    plan = CP.plan_conv_tiles(m, co, depth, es, sms)
    _check_plan(plan, m, co, depth, es)


def test_plan_is_deterministic_and_cached():
    args = (1352, 1024, 4608, 2, 132)
    CP.plan_conv_tiles.cache_clear()
    first = CP.plan_conv_tiles(*args)
    misses = CP.plan_conv_tiles.cache_info().misses
    again = CP.plan_conv_tiles(*args)
    info = CP.plan_conv_tiles.cache_info()
    assert again is first and info.misses == misses and info.hits >= 1
    CP.plan_conv_tiles.cache_clear()
    assert CP.plan_conv_tiles(*args) == first
    # the default SM count is the H100's
    assert CP.plan_conv_tiles(*args[:4]) == first


def test_small_deep_shapes_take_one_wave():
    """The classes the one-rule tiling served worst (few rows, deep sums:
    176 blocks of 64 x 128 on 132 SMs, a wave and a third). The plan's blocks
    all run at once, on at least half of the SMs."""
    for m, co, depth, es in [(1352, 1024, 4608, 2), (10240, 512, 4608, 1)]:
        plan = CP.plan_conv_tiles(m, co, depth, es)
        blocks = CP.plan_blocks(plan, m, co)
        assert 66 <= blocks <= 132 * CP.blocks_per_sm(plan.bm, plan.bn), \
            (m, co, plan)
    # a walking tile's launch stops at what the card holds, else one block
    # per tile and share of the depth
    assert CP.plan_blocks(CP.ConvPlan(64, 128, 3, 1), 163840, 128) == 264
    assert CP.plan_blocks(CP.ConvPlan(64, 128, 3, 1), 640, 128, 108) == 10
    assert CP.plan_blocks(CP.ConvPlan(64, 128, 3, 2), 163840, 128) == 5120
    assert CP.plan_blocks(CP.ConvPlan(128, 256, 3, 1), 163840, 255) == 132
    assert CP.plan_blocks(CP.ConvPlan(128, 256, 3, 1), 1352, 1024) == 44


@pytest.mark.parametrize("key", sorted(TUNED_132_SMS))
def test_tuned_table_entry_is_a_plan_the_planner_returns(key):
    """Every entry of the table the sweep tool writes names a tile the
    kernels instantiate and a split that divides the depth steps; the
    planner returns it on a card of 132 SMs and nowhere else unasked."""
    m, co, depth, es, quantizing = key
    bm, bn, split = TUNED_132_SMS[key]
    assert (bm, bn) in CP.TILES and split in CP.SPLITS
    assert CP.depth_steps(depth, es) % split == 0
    plan = CP.plan_conv_tiles(m, co, depth, es, 132, quantizing)
    assert (plan.bm, plan.bn, plan.split) == (bm, bn, split)
    _check_plan(plan, m, co, depth, es)
    other = CP.plan_conv_tiles(m, co, depth, es, 108, quantizing)
    steps = CP.depth_steps(depth, es)
    assert (other.bm, other.bn, other.split) == CP._rule_plan(
        m, co, steps, 108, quantizing)


def test_table_holds_every_served_class():
    """The table has the shape classes the serving paths route: the 15
    backbone classes at batch 8 in both modes, the nine ReID classes at 320
    and 512 crops."""
    for hi, ci, co, k, stride in BACKBONE_CLASSES:
        m = 8 * (hi // stride) ** 2
        assert (m, co, k * k * ci, 2, False) in TUNED_132_SMS
        assert (m, co, k * k * ci, 1, True) in TUNED_132_SMS
    for crops in (320, 512):
        for k, stride, h, w, ci, co in REID_CLASSES:
            m = crops * (h // stride) * (w // stride)
            assert (m, co, k * k * ci, 1, False) in TUNED_132_SMS


@pytest.mark.parametrize("case", [
    # (m, co, steps, SMs, quantizing) -> (bm, bn, split)
    ((200000, 512, 36, 132, False), (128, 128, 1)),  # fills the card
    ((200000, 512, 36, 132, True), (64, 128, 1)),    # producers quantize
    ((4096, 256, 36, 132, False), (64, 64, 1)),      # 64 tiles of 128 x 128
    ((512, 256, 36, 132, False), (64, 64, 4)),       # 32 tiles: split 4
    ((512, 256, 18, 132, False), (64, 64, 2)),       # 18 steps: split 2
    ((512, 256, 8, 132, False), (64, 64, 1)),        # too short to split
    ((2048, 256, 36, 132, False), (64, 64, 1)),      # 128 tiles: no room
    ((512, 64, 36, 132, False), (64, 64, 4)),        # Co 64: 64 columns
    ((200000, 100, 36, 132, False), (128, 128, 1)),  # Co 100: 128 columns
])
def test_rule_plan(case):
    """The rule for shapes outside the table: the largest tile that gives
    every SM one, 64 rows where the producers quantize, a split only where
    the tiles leave half the card idle and the depth is long."""
    args, want = case
    assert CP._rule_plan(*args) == want


@pytest.mark.parametrize("bad", [(0, 8, 8, 2), (8, 0, 8, 2), (8, 8, 0, 2),
                                 (8, 8, 8, 4)])
def test_plan_refuses_bad_problems(bad):
    with pytest.raises(ValueError, match="plan_conv_tiles"):
        CP.plan_conv_tiles(*bad)


@pytest.mark.parametrize("plan", [(96, 128, 4, 1), (128, 192, 4, 1),
                                  (128, 64, 4, 1), (64, 256, 4, 1),
                                  (128, 128, 1, 1), (128, 256, 8, 1),
                                  (64, 64, 4, 16), (64, 64, 2, 4)])
def test_check_plan_refuses_what_the_kernels_do_not_take(plan):
    """A tile the kernels do not instantiate, a ring of one stage or past
    shared memory, a split past 8 or past the depth steps (here 3)."""
    with pytest.raises(ValueError, match="conv plan"):
        CP.check_plan(CP.ConvPlan(*plan), 3 * 64, 2)


@pytest.mark.parametrize("bm,bn", CP.TILES)
def test_max_stages_fits_and_is_maximal(bm, bn):
    s = CP.max_stages(bm, bn)
    assert 2 <= s <= CP.MAX_STAGES
    assert CP.plan_smem_bytes(bm, bn, s) <= CP.SMEM_PER_BLOCK
    assert s == CP.MAX_STAGES or \
        CP.plan_smem_bytes(bm, bn, s + 1) > CP.SMEM_PER_BLOCK
    # the staged accumulators (at most 128 columns a pass) lie beside a ring
    # of at least two stages
    assert CP.plan_smem_bytes(bm, bn, 2) \
        >= 2 * (bm + bn) * 128 + bm * (4 * min(bn, 128) + 32)
    # two blocks of the tiles that share an SM fit it (1 KB each goes to the
    # SM)
    if CP.blocks_per_sm(bm, bn) == 2:
        s2 = CP.max_stages(bm, bn, 2)
        assert 2 * (CP.plan_smem_bytes(bm, bn, s2) + 1024) \
            <= CP.SMEM_PER_BLOCK + 1024


def _weights(seed, k, ci, co, dtype):
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-127, 128, (k, k, ci, co)).astype(
            np.int8))
    return torch.from_numpy(rng.standard_normal((k, k, ci, co)).astype(
        np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shape", [(3, 8, 136), (3, 24, 255), (1, 72, 16),
                                   (3, 64, 128), (1, 1024, 255)])
def test_pack_round_trips(dtype, shape):
    """HWIO -> K-major rows -> HWIO is the identity; the pitch is the depth
    rounded up to 16 bytes, the pad is zero, and row co is column co of the
    tap-major (k*k*Ci, Co) matrix."""
    k, ci, co = shape
    w = _weights(k + ci + co, k, ci, co, dtype)
    p = CP.pack_conv_weights(w)
    depth = k * k * ci
    per = 16 // w.element_size()
    assert (p.k, p.ci, p.co) == (k, ci, co)
    assert p.data.shape == (co, -(-depth // per) * per)
    assert p.data.shape[1] == CP.packed_pitch(depth, w.element_size())
    assert p.data.dtype == dtype and p.data.is_contiguous()
    assert not bool(p.data[:, depth:].any())
    assert torch.equal(p.data[:, :depth], w.reshape(depth, co).t())
    assert torch.equal(CP.unpack_conv_weights(p), w)
    # a view with other strides (the route's HWIO view of OIHW weights)
    view = w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    assert torch.equal(CP.pack_conv_weights(view).data, p.data)
    assert CP.weight_geometry(p) == CP.weight_geometry(w) == (k, k, ci, co)


def test_pack_refuses_other_types():
    with pytest.raises(ValueError, match="pack_conv_weights"):
        CP.pack_conv_weights(torch.zeros((3, 3, 8, 8)))
    with pytest.raises(ValueError, match="pack_conv_weights"):
        CP.pack_conv_weights(torch.zeros((3, 8, 8), dtype=torch.int8))


def test_packed_weights_cache_follows_the_tensor():
    w = _weights(1, 3, 16, 32, torch.int8)
    first = CP.packed_weights(w)
    assert CP.packed_weights(w) is first
    assert CP.packed_weights(w[:]) is first  # another view of the same memory
    w[0, 0, 0, 0] += 1  # an in-place update bumps the version: repacked
    second = CP.packed_weights(w)
    assert second is not first
    assert torch.equal(CP.unpack_conv_weights(second), w)
    other = _weights(2, 3, 16, 32, torch.int8)
    assert torch.equal(CP.unpack_conv_weights(CP.packed_weights(other)),
                       other)
    # bounded: the least recently used entry goes first
    keep = [_weights(s, 1, 16, 16, torch.int8)
            for s in range(CP._PACK_CACHE_SIZE + 8)]
    for t in keep:
        CP.packed_weights(t)
    assert len(CP._PACK_CACHE) == CP._PACK_CACHE_SIZE


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)])
def test_plain_versions_take_packed_weights(k, stride):
    """The plain versions give the same result from packed and from HWIO
    weights, in all three functions."""
    rng = np.random.default_rng(k + stride)
    n, hi, ci, co = 2, 6, 24, 40
    pad = (k - 1) // 2
    x = torch.from_numpy(rng.standard_normal((n, hi, hi, ci)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal(co).astype(np.float32))
    w = _weights(3, k, ci, co, torch.bfloat16)
    kw = dict(stride=stride, pad=pad, act="leaky")
    assert torch.equal(
        conv_kernel.conv_bf16(x, CP.pack_conv_weights(w), b, **kw),
        conv_kernel.conv_plain_bf16(x, w, b, **kw))
    wq = _weights(4, k, ci, co, torch.int8)
    scale = torch.full((co,), 0.01)
    assert torch.equal(
        conv_kernel.conv_int8(x, CP.pack_conv_weights(wq), b, scale, 30.0,
                              **kw),
        conv_kernel.conv_plain_int8(x, wq, b, scale, 30.0, **kw))
    ci8 = 32
    xq = torch.from_numpy(rng.integers(-127, 128, (n, hi, hi, ci8)).astype(
        np.int8))
    wq8 = _weights(5, k, ci8, co, torch.int8)
    kw8 = dict(stride=stride, pad=pad)
    assert torch.equal(
        conv_int8_kernel.conv_int8(xq, CP.pack_conv_weights(wq8), scale, b,
                                   20.0, **kw8),
        conv_int8_kernel.conv_int8_plain(xq, wq8, scale, b, 20.0, **kw8))


def test_kernel_weights_checks_type_and_plan():
    w = _weights(1, 3, 16, 32, torch.int8)
    dev = torch.device("cpu")
    p, plan = CP.kernel_weights(w, torch.int8, CP.ConvPlan(64, 64, 2, 1), dev,
                                100)
    assert p is CP.packed_weights(w) and plan == (64, 64, 2, 1)
    assert CP.kernel_weights(p, torch.int8, plan, dev, 100)[0] is p
    with pytest.raises(ValueError, match="packed"):
        CP.kernel_weights(w, torch.bfloat16, plan, dev, 100)
    with pytest.raises(ValueError, match="conv plan"):
        CP.kernel_weights(w, torch.int8, CP.ConvPlan(64, 64, 2, 3), dev, 100)
