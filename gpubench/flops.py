"""Operations, bytes and roofline times of the models' convolutions, from
the configuration's layer shapes alone (not from what implements them),
and the published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet,
dense rates, at its 700 W power limit).

A conv at batch N does 2 * N * Ho * Wo * Co * Ci * k * k operations and
moves, at 2 bytes an element (bf16), its input once, its weights once and
its output once. Its roofline time is the larger of operations over the
peak rate and bytes over the memory bandwidth; a model's is the sum over
its convs. ``mfu.*`` and ``*_roofline.*`` read only these functions, so a
later kernel in place of today's is judged on the same work."""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

from .reference import darknet as ref_darknet
from .reference import reid as ref_reid

PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BYTES_PER_ELEMENT = 2  # bf16 activations and weights

# (ci, co, k, stride, hin, win, hout, wout) per conv, one image or crop
Conv = Tuple[int, int, int, int, int, int, int, int]


def conv_ops(c: Conv, n: int = 1) -> float:
    ci, co, k, _, _, _, ho, wo = c
    return 2.0 * n * ho * wo * co * ci * k * k


def conv_bytes(c: Conv, n: int = 1) -> float:
    ci, co, k, _, hi, wi, ho, wo = c
    return BYTES_PER_ELEMENT * (n * (hi * wi * ci + ho * wo * co)
                                + k * k * ci * co)


def roofline_s(convs: Iterable[Conv], n: int) -> float:
    """Least time the chip could take for every conv at batch n, in bf16."""
    return sum(max(conv_ops(c, n) / PEAK_OPS_PER_S["bf16"],
                   conv_bytes(c, n) / HBM_BYTES_PER_S) for c in convs)


def total_ops(convs: Sequence[Conv], n: int = 1) -> float:
    return sum(conv_ops(c, n) for c in convs)


def detector_convs(cfg_text: str, img_size: int):
    """The detector's convs at ``img_size`` from its darknet cfg text."""
    defs = ref_darknet.parse_cfg(cfg_text)[1:]
    return [(c["ci"], c["co"], c["k"], c["stride"], c["hin"], c["win"],
             c["hout"], c["wout"])
            for c in ref_darknet.conv_shapes(defs, img_size)]


def reid_convs():
    """The 512-d ReID net's convs on one 128 x 64 crop."""
    return ref_reid.conv_shapes()
