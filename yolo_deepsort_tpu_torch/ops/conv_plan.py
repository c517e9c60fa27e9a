"""Tile plans and weight packing of the two implicit-GEMM conv kernels
(kernel 7, ``csrc/conv.cu``; kernel 8, ``csrc/conv_int8.cu``), which share
the main loop of ``csrc/conv_mainloop.cuh``.

The kernels compute a conv as one matrix product: rows M = N * Ho * Wo,
columns Co, depth k * k * Ci walked in steps of 128 bytes (64 bf16 or 128
int8 values). A thread block owns a BM x BN output tile at a time, feeds
``wgmma`` from a ring of ``stages`` tile pairs in shared memory and walks its
share of the tiles (the launch has no more blocks than the card holds at
once); a thread-block cluster of ``split`` blocks may instead share one
tile's depth. Which (BM, BN, stages, split)
a shape gets is decided here, in Python, where the CPU tests reach it, and
handed to the kernel's C entry: ``plan_conv_tiles``.

``wgmma`` reads both operands K-major (the integer form has no other), and
HWIO weights are Co-contiguous, so the weights are packed once per layer to
(Co, ldw) rows, tap-major inside a row and zero up to the pitch ``ldw``:
``pack_conv_weights``. The serving routes pack when they are built and pass
the ``PackedWeights`` on (frozen inference weights: one pack per layer,
outside every timed loop); a caller with raw HWIO weights gets them packed
on the fly through a small cache keyed by the tensor's memory and version
(``packed_weights``).
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import torch

from .conv_plan_table import TUNED_132_SMS

STEP_BYTES = 128          # depth bytes per ring stage and tile row
SMEM_PER_BLOCK = 232448   # 227 KB: the most shared memory a block is given
# (BM, BN) the kernels instantiate: one consumer warpgroup per 64 rows, BN a
# wgmma width (128 x 64 was the fastest at no shape class the sweep timed and
# 64 x 256 at one: both are left out, for the build's time)
TILES = ((64, 64), (64, 128), (128, 128), (128, 256))
SPLITS = (1, 2, 4)        # blocks of a cluster sharing a tile's depth
MAX_STAGES = 8
H100_SM_COUNT = 132       # the card the table of tuned plans was timed on


class ConvPlan(NamedTuple):
    """Output tile (``bm`` x ``bn``), ring depth and the split of the depth
    over a cluster."""

    bm: int
    bn: int
    stages: int
    split: int


def depth_steps(depth: int, elem_bytes: int) -> int:
    """128-byte steps over a depth of ``depth`` elements."""
    return -(-depth * elem_bytes // STEP_BYTES)


def blocks_per_sm(bm: int, bn: int) -> int:
    """Blocks of this tile the kernels let share an SM
    (``conv_mainloop.cuh`` ``Tile::BLOCKS_PER_SM``): two where one consumer
    warpgroup holds at most 64 accumulators a thread."""
    return 2 if bm == 64 and bn <= 128 else 1


def plan_smem_bytes(bm: int, bn: int, stages: int) -> int:
    """Dynamic shared memory of one block, as ``conv_mainloop.cuh`` lays it
    out: 1024 bytes to align the ring, the ring, beside it the epilogue's
    staging of the accumulators (BM rows of at most 128 columns, 4 bytes
    each + 32 a row: a 256-wide tile drains in two passes) and two 8-byte
    barriers per stage."""
    ring = stages * (bm + bn) * STEP_BYTES
    staging = bm * (min(bn, 128) * 4 + 32)
    return 1024 + ring + staging + 16 * stages


def max_stages(bm: int, bn: int, share: int = 1) -> int:
    """The deepest ring (at most MAX_STAGES) that lets ``share`` blocks fit
    an SM's shared memory (each block also costs the SM 1 KB)."""
    budget = SMEM_PER_BLOCK if share == 1 else \
        (SMEM_PER_BLOCK + 1024) // share - 1024
    s = MAX_STAGES
    while s > 2 and plan_smem_bytes(bm, bn, s) > budget:
        s -= 1
    return s


def plan_tiles(plan: ConvPlan, m: int, co: int):
    """The (row range, column range) of every output tile of the plan's
    grid, as the kernel cuts them: ``blockIdx.x`` over rows, ``.y`` over
    columns, ragged at the far edges."""
    return [((r, min(r + plan.bm, m)), (c, min(c + plan.bn, co)))
            for r in range(0, m, plan.bm) for c in range(0, co, plan.bn)]


def plan_blocks(plan: ConvPlan, m: int, co: int,
                sm_count: int = H100_SM_COUNT) -> int:
    """Thread blocks of the plan's launch: no more than the card holds at
    once, each walking its share of the tiles; with a split, one block per
    tile and share of its depth."""
    tiles = -(-m // plan.bm) * -(-co // plan.bn)
    if plan.split > 1:
        return tiles * plan.split
    return min(tiles, sm_count * blocks_per_sm(plan.bm, plan.bn))


def _rule_plan(m: int, co: int, steps: int, sm_count: int,
               quantizing: bool) -> Tuple[int, int, int]:
    """(bm, bn, split) for a shape the table does not hold. The tile: the
    largest of 128 x 128, 64 x 128, 64 x 64 that still gives every SM a
    tile, the smallest where none does; 64-row tiles only where the
    producers quantize (their work bounds that loop, and two such blocks
    share an SM: two producer warpgroups). 128 x 256 comes from the table
    alone. The split: where the tiles fill at most half the card and the
    depth is long, the largest of 4 and 2 that divides the steps, keeps the
    blocks within the SMs and leaves a block 8 steps or more."""
    pick = None
    for bm, bn in ((128, 128), (64, 128), (64, 64)):
        if (quantizing and bm > 64) or (bn > 64 and bn // 2 >= co):
            continue  # or half the tile's columns would be padding
        pick = (bm, bn)
        if -(-m // bm) * -(-co // bn) >= sm_count:
            break
    bm, bn = pick
    tiles = -(-m // bm) * -(-co // bn)
    for split in (4, 2):
        if (steps % split == 0 and tiles * split <= sm_count
                and steps // split >= 8):
            return bm, bn, split
    return bm, bn, 1


@functools.lru_cache(maxsize=None)
def plan_conv_tiles(m: int, co: int, depth: int, elem_bytes: int,
                    sm_count: int = H100_SM_COUNT,
                    quantizing: bool = False) -> ConvPlan:
    """Pick the tile, the ring depth and the depth split for a conv of ``m``
    output pixels, ``co`` output channels and ``depth`` = k * k * Ci
    elements of ``elem_bytes`` (2: bf16, 1: int8) on a card of ``sm_count``
    SMs; ``quantizing`` for kernel 7's int8 modes, whose producers quantize
    the activations in registers.

    On a card of 132 SMs a shape that ``tools/conv_plan_sweep.py`` has timed
    takes the fastest tile and split found there (``conv_plan_table.py``);
    any other shape, and any other card, takes ``_rule_plan``. A split
    divides the depth steps, so every block of a cluster walks the same
    number. The ring is as deep as shared memory allows -- half of it for
    the tiles that go two blocks to an SM -- but no deeper than the steps a
    block walks."""
    if min(m, co, depth) < 1 or elem_bytes not in (1, 2) or sm_count < 1:
        raise ValueError(f"plan_conv_tiles: bad shape {(m, co, depth)}, "
                         f"element size {elem_bytes} or SM count {sm_count}")
    steps = depth_steps(depth, elem_bytes)
    tuned = TUNED_132_SMS.get((m, co, depth, elem_bytes, quantizing)) \
        if sm_count == H100_SM_COUNT else None
    bm, bn, split = tuned or _rule_plan(m, co, steps, sm_count, quantizing)
    stages = max(2, min(max_stages(bm, bn, blocks_per_sm(bm, bn)),
                        steps // split))
    return ConvPlan(bm, bn, stages, split)


def check_plan(plan: ConvPlan, depth: int, elem_bytes: int) -> ConvPlan:
    """Raise on a plan the kernels do not take."""
    bm, bn, stages, split = plan
    steps = depth_steps(depth, elem_bytes)
    if ((bm, bn) not in TILES
            or not 2 <= stages <= MAX_STAGES or not 1 <= split <= 8
            or split > steps
            or plan_smem_bytes(bm, bn, stages) > SMEM_PER_BLOCK):
        raise ValueError(f"conv plan {tuple(plan)} is not one the kernels "
                         f"take ({steps} depth steps)")
    return ConvPlan(bm, bn, stages, split)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(device: torch.device, m: int, co: int, depth: int,
             elem_bytes: int, quantizing: bool = False) -> ConvPlan:
    """``plan_conv_tiles`` for the card ``device`` names."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return plan_conv_tiles(m, co, depth, elem_bytes, _sm_count(index),
                           quantizing)


# ------------------------------------------------------------- packing ----

class PackedWeights(NamedTuple):
    """Conv weights as the kernels read them: ``data`` (Co, ldw), row co
    holding its k * k * Ci values tap-major (dy, dx, ci) and zeros up to the
    pitch, beside the HWIO shape they came from."""

    data: torch.Tensor
    k: int
    ci: int
    co: int


def packed_pitch(depth: int, elem_bytes: int) -> int:
    """Row pitch in elements: the depth rounded up to 16 bytes."""
    per = 16 // elem_bytes
    return -(-depth // per) * per


def pack_conv_weights(w: torch.Tensor) -> PackedWeights:
    """HWIO (k, k, Ci, Co) weights, bf16 or int8, as K-major rows. Plain
    torch; runs once per layer."""
    if w.dim() != 4 or w.shape[0] != w.shape[1] or w.dtype not in (
            torch.bfloat16, torch.int8):
        raise ValueError(f"pack_conv_weights: expected bf16 or int8 HWIO "
                         f"weights, got {w.dtype} {tuple(w.shape)}")
    k, _, ci, co = (int(v) for v in w.shape)
    depth = k * k * ci
    ldw = packed_pitch(depth, w.element_size())
    data = torch.zeros((co, ldw), dtype=w.dtype, device=w.device)
    data[:, :depth] = w.reshape(depth, co).t()
    return PackedWeights(data, k, ci, co)


def unpack_conv_weights(p: PackedWeights) -> torch.Tensor:
    """The HWIO weights a pack came from."""
    depth = p.k * p.k * p.ci
    return p.data[:, :depth].t().reshape(p.k, p.k, p.ci, p.co).contiguous()


_PACK_CACHE: "OrderedDict[Tuple, Tuple[torch.Tensor, PackedWeights]]" = \
    OrderedDict()
_PACK_CACHE_SIZE = 32


def packed_weights(w: torch.Tensor) -> PackedWeights:
    """The packed form of ``w``, packed at the first call with this tensor
    and kept. The key is the tensor's memory, layout, type and version
    counter (an in-place update repacks); an entry holds its tensor, so the
    memory cannot be freed and handed to other weights while the entry
    lives. The least recently used of 32 entries goes first: the cache
    serves callers with a few raw tensors; a route of many layers packs
    for itself (``pack_conv_weights``)."""
    key = (w.data_ptr(), w._version, tuple(w.shape), tuple(w.stride()),
           w.dtype, w.device)
    hit = _PACK_CACHE.get(key)
    if hit is not None:
        _PACK_CACHE.move_to_end(key)
        return hit[1]
    packed = pack_conv_weights(w)
    _PACK_CACHE[key] = (w, packed)
    while len(_PACK_CACHE) > _PACK_CACHE_SIZE:
        _PACK_CACHE.popitem(last=False)
    return packed


def weight_tensor(w) -> torch.Tensor:
    """The tensor behind either form."""
    return w.data if isinstance(w, PackedWeights) else w


def as_hwio(w) -> torch.Tensor:
    """HWIO weights from either form (the plain versions convolve HWIO)."""
    return unpack_conv_weights(w) if isinstance(w, PackedWeights) else w


def weight_geometry(w) -> Tuple[int, int, int, int]:
    """(k, k, Ci, Co) of HWIO or packed weights."""
    if isinstance(w, PackedWeights):
        return (w.k, w.k, w.ci, w.co)
    if w.dim() != 4:
        raise ValueError(f"conv: expected HWIO weights, got "
                         f"{tuple(w.shape)}")
    return tuple(int(v) for v in w.shape)


def kernel_weights(w, dtype: torch.dtype,
                   plan: Optional[ConvPlan], device: torch.device, m: int,
                   quantizing: bool = False
                   ) -> Tuple[PackedWeights, ConvPlan]:
    """What a launch needs from its weights: the packed form (``w`` itself
    when it is one, else from the cache) and the plan (``plan`` checked, or
    the planner's for this card)."""
    p = w if isinstance(w, PackedWeights) else packed_weights(w)
    if p.data.dtype != dtype or not p.data.is_contiguous():
        raise ValueError(f"conv kernel: expected contiguous {dtype} packed "
                         f"weights, got {p.data.dtype}")
    depth, es = p.k * p.k * p.ci, p.data.element_size()
    if plan is None:
        plan = plan_for(device, m, p.co, depth, es, quantizing)
    return p, check_plan(plan, depth, es)
