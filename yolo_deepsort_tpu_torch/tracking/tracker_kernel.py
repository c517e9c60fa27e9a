"""Kernel 3: the fused DeepSORT tracker step (CUDA ``csrc/tracker.cu``,
with the warp JV stage runner of ``csrc/jv_stage.cuh``).

Replaces the TPU kernel ``yolo_deepsort_tpu/tracking/tracker_pallas.py``
(``_tracker_kernel`` via ``tracker_step_fused_batched``). Bound on the H100
by latency: the two JV sweeps per stream are chains of (rows + Dijkstra
steps) dependent steps, nearly one step per row. The design runs the whole
step -- prologue, predict, gate, both solves, update, lifecycle, id
allocation -- in one launch with one block per stream: inputs staged in
shared memory by cp.async, the stage-A costs spread over all threads, warp
0 solving stage A while the other warps build stage B's IoU costs, each
solve one warp with no block barrier in its row loop (see the note at the
top of the .cu file).

The kernel reads the state and the raw detections as they are and builds
what the reference's framework side built before its kernel: the xyah
form, the ``min_confidence`` mask, the cascade levels, both stable orders
and the counts (``kernel_prologue`` is its plain version). Three parts stay
in framework ops around the kernel, as they stayed in XLA: the appearance
einsum against the gallery, the ring-buffer gallery scatter (in place) and
the emitted rows.

``tracker_step_fused_batched`` takes the plain version
(``tracking/tracker.py tracker_step``) for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..config import TrackerConfig
from ..kernels import build
from ..ops import boxes as B
from ..ops.assignment import _LEVEL_INACTIVE
from ..ops.assignment_kernel import stable_rank_order
from ..utils.profiling import span
from .tracker import (
    STATE_CONFIRMED,
    STATE_TENTATIVE,
    TrackerState,
    appearance_cost,
    emit_outputs,
    tracker_step,
    write_gallery,
)

launches = 0  # kernel launches; only the launch below adds to it
# whether the last launch staged its (T, D) blocks in shared memory (False:
# device memory, as at T = D = 256)
last_staged = None

_MAX_BLOCK = 256  # the kernel's threads per block: T and D must fit
_INT_FIELDS = ("state", "hits", "age", "time_since_update", "track_id")


def tracker_step_fused_batched(cfg: TrackerConfig, state: TrackerState,
                               det_tlwh, det_conf, det_feat, det_mask,
                               img_hw: Tuple[int, int]):
    """Batched tracker step: (new_state, outputs (S, T, 5), emit (S, T)).
    Writes ``state.gallery`` in place."""
    with span("ydt.tracker"):
        if det_tlwh.device.type == "cpu":
            return tracker_step(cfg, state, det_tlwh, det_conf, det_feat,
                                det_mask, img_hw)
        return tracker_step_cuda(cfg, state, det_tlwh, det_conf, det_feat,
                                 det_mask, img_hw)


def kernel_prologue(cfg: TrackerConfig, state: TrackerState, det_tlwh,
                    det_conf, det_mask):
    """Plain version of the kernel's prologue: (det_xyah (S, D, 4), det_ok
    (S, D) bool, levels_a, order_a, order_b (S, T) int32, n_a, n_b (S,)
    int32). Stage A: confirmed tracks at level tsu, in stable level order;
    stage B: tentative and just-missed confirmed tracks, one level. The
    orders are exact stable ranks, as the kernel computes them."""
    st, tsu = state.state, state.time_since_update
    det_tlwh = det_tlwh.float()
    det_ok = det_mask.bool() & (det_conf > cfg.min_confidence)
    confirmed = st == STATE_CONFIRMED
    rows_b = (st == STATE_TENTATIVE) | (confirmed & (tsu == 0))
    inactive = torch.full_like(tsu, _LEVEL_INACTIVE, dtype=torch.int32)
    levels_a = torch.where(confirmed, tsu.to(torch.int32), inactive)
    levels_b = torch.where(rows_b, torch.zeros_like(inactive), inactive)
    return (B.tlwh_to_xyah(det_tlwh), det_ok, levels_a,
            stable_rank_order(levels_a), stable_rank_order(levels_b),
            confirmed.sum(-1, dtype=torch.int32),
            rows_b.sum(-1, dtype=torch.int32))


def pack_inputs(cfg: TrackerConfig, state: TrackerState, det_tlwh, det_conf,
                det_feat, det_mask):
    """Framework side before the kernel: the appearance cost, then the
    state and the detections as they are, in the argument order of
    ``kernel_batched`` (no op for inputs already in the kernel's types and
    contiguous, as the kernel's own outputs are)."""
    app = appearance_cost(state, det_feat, cfg).contiguous()  # (S, T, D)
    ints = tuple(getattr(state, f).to(torch.int32).contiguous()
                 for f in _INT_FIELDS)
    return (app, det_tlwh.float().contiguous(),
            det_conf.float().contiguous(), det_mask.bool().contiguous(),
            *ints, state.mean.float().contiguous(),
            state.cov.float().contiguous(),
            state.next_id.to(torch.int32).contiguous())


def kernel_batched(cfg: TrackerConfig, app, det_tlwh, det_conf, det_mask,
                   st, hits, age, tsu, track_id, mean, cov, next_id):
    """Launch the tracker kernel on the buffers of ``pack_inputs``:
    -> (mean (S, T, 8), cov (S, T, 8, 8), ints (7, S, T), next_id (S,))
    where ints holds the planes [state, hits, age, tsu, track_id,
    match_det, det_for_slot]."""
    global launches, last_staged
    s, t, d = app.shape
    if t > _MAX_BLOCK or d > _MAX_BLOCK:
        raise ValueError(f"tracker kernel: max_tracks {t} and detections {d} "
                         f"must be <= {_MAX_BLOCK}")
    bufs = (app, det_tlwh, det_conf, det_mask, st, hits, age, tsu, track_id,
            mean, cov, next_id)
    build.require_cuda("tracker", *bufs)
    f32, i32 = torch.float32, torch.int32
    want = (((s, t, d), f32), ((s, d, 4), f32), ((s, d), f32),
            ((s, d), torch.bool)) + (((s, t), i32),) * 5 + (
        ((s, t, 8), f32), ((s, t, 8, 8), f32), ((s,), i32))
    for i, (buf, (shape, dtype)) in enumerate(zip(bufs, want)):
        if tuple(buf.shape) != shape or buf.dtype != dtype:
            raise ValueError(f"tracker kernel: input {i} is "
                             f"{tuple(buf.shape)} {buf.dtype}, expected "
                             f"{shape} {dtype}")
    dev = app.device
    mean_o = torch.empty_like(mean)
    cov_o = torch.empty_like(cov)
    ints_o = torch.empty((7, s, t), dtype=i32, device=dev)
    next_o = torch.empty_like(next_id)
    scratch = torch.empty((2, s, t, d), dtype=f32, device=dev)
    staged = ctypes.c_int(0)
    lib = build.load()
    err = lib.ydt_tracker_step(
        *(b.data_ptr() for b in bufs), mean_o.data_ptr(), cov_o.data_ptr(),
        ints_o.data_ptr(), next_o.data_ptr(), scratch.data_ptr(), s, t, d,
        float(cfg.max_dist), float(cfg.max_iou_distance), int(cfg.max_age),
        int(cfg.n_init), float(cfg.min_confidence), ctypes.addressof(staged),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("tracker", err)
    launches += 1
    last_staged = bool(staged.value)
    return mean_o, cov_o, ints_o, next_o


def tracker_step_cuda(cfg: TrackerConfig, state: TrackerState, det_tlwh,
                      det_conf, det_feat, det_mask, img_hw):
    s, t = state.state.shape
    d = det_tlwh.shape[1]
    if det_tlwh.shape != (s, d, 4) or det_feat.shape[:2] != (s, d):
        raise ValueError("tracker kernel: detection shapes do not match the "
                         "state's stream axis")
    # the framework side runs before the kernel's own checks: refuse a
    # non-CUDA state or detection batch here
    build.require_cuda("tracker", det_tlwh, det_conf, det_feat, det_mask,
                       state.mean, state.cov, state.gallery, contiguous=False)
    mean_o, cov_o, ints_o, next_id = kernel_batched(
        cfg, *pack_inputs(cfg, state, det_tlwh, det_conf, det_feat, det_mask))

    st2, hits2, age2, tsu2, tid2, match_det, det_for_slot = ints_o.unbind(0)
    # framework side: ring-buffer gallery writes (in place)
    head, count = write_gallery(state, match_det, det_for_slot,
                                det_feat.float(), cfg.nn_budget)
    new_state = TrackerState(
        mean=mean_o, cov=cov_o, track_id=tid2, state=st2, hits=hits2,
        age=age2, time_since_update=tsu2, gallery=state.gallery,
        gallery_head=head, gallery_count=count, next_id=next_id)
    outputs, emit = emit_outputs(mean_o, st2, tsu2, tid2, img_hw)
    return new_state, outputs, emit
