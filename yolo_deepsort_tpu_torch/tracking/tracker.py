"""The DeepSORT tracker as fixed-shape state, batched over streams (port of
yolo_deepsort_tpu/tracking/tracker.py).

``tracker_step`` is one frame of DeepSORT for every stream: KF predict,
gated-cosine matching cascade, IoU matching of tentative and just-missed
tracks, KF update, ring-buffer gallery, lifecycle and id allocation. It
runs on the tensors' device and reads nothing back to the host. It plays
two parts, as ``tracking/tracker.py`` does in the reference:

* the plain version of the fused tracker kernel (K3,
  ``tracker_kernel.py``), against which that kernel is held;
* the unfused step of the facades (``api.py`` ``DeepSort`` and
  ``VideoTracker.track_frame``): framework ops around ONE two-stage JV
  solve for all streams (``ops/assignment_kernel.py``), which launches
  kernel K5 for CUDA tensors and runs the plain solver stream by stream for
  CPU tensors.

``TrackerState`` holds every field with a leading stream axis S. The
gallery (S, T, nn_budget, feat_dim) -- 26 MB per stream at the defaults --
is updated IN PLACE by both the plain step and the kernel wrapper: the
returned state shares the input state's gallery tensor, and only the rows
a frame writes are touched.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import TrackerConfig
from ..device import resolve_device
from ..ops import boxes as B
from ..ops.assignment_kernel import solve_two_stage_assignment_fused
from . import kalman as K

INFTY_COST = 1e5

STATE_FREE = 0
STATE_TENTATIVE = 1
STATE_CONFIRMED = 2


@dataclasses.dataclass
class TrackerState:
    """Per-stream tracker state; every field has a leading (S,) axis."""

    mean: torch.Tensor  # (S, T, 8) f32 Kalman mean (xyah + velocities)
    cov: torch.Tensor  # (S, T, 8, 8) f32
    track_id: torch.Tensor  # (S, T) i32; 0 when free
    state: torch.Tensor  # (S, T) i32 STATE_*
    hits: torch.Tensor  # (S, T) i32
    age: torch.Tensor  # (S, T) i32
    time_since_update: torch.Tensor  # (S, T) i32
    gallery: torch.Tensor  # (S, T, B, F) f32 ring buffer of L2-normed feats
    gallery_head: torch.Tensor  # (S, T) i32 next write slot
    gallery_count: torch.Tensor  # (S, T) i32 valid entries (<= B)
    next_id: torch.Tensor  # (S,) i32, starts at 1


def init_tracker_state(cfg: TrackerConfig, n_streams: int,
                       device=None) -> TrackerState:
    """Fresh state on ``device``: the CUDA card unless the caller names
    another (``resolve_device``)."""
    device = resolve_device(device)
    s, t, b, f = n_streams, cfg.max_tracks, cfg.nn_budget, cfg.feat_dim

    def zi(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return TrackerState(
        mean=torch.zeros((s, t, 8), device=device),
        cov=torch.zeros((s, t, 8, 8), device=device),
        track_id=zi(s, t), state=zi(s, t), hits=zi(s, t), age=zi(s, t),
        time_since_update=zi(s, t),
        gallery=torch.zeros((s, t, b, f), device=device),
        gallery_head=zi(s, t), gallery_count=zi(s, t),
        next_id=torch.ones((s,), dtype=torch.int32, device=device),
    )


def appearance_cost(state: TrackerState, det_feat: torch.Tensor,
                    cfg: TrackerConfig) -> torch.Tensor:
    """min over each track's gallery of (1 - cosine similarity): (S, T, D);
    INFTY_COST for tracks with an empty gallery."""
    sims = torch.einsum("stbf,sdf->stbd", state.gallery, det_feat.float())
    valid = (torch.arange(cfg.nn_budget, device=sims.device)[None, None, :]
             < state.gallery_count[:, :, None])
    sims = torch.where(valid[..., None], sims,
                       torch.full_like(sims, float("-inf")))
    best = sims.max(2).values
    return torch.where(state.gallery_count[..., None] > 0, 1.0 - best,
                       torch.full_like(best, INFTY_COST))


def write_gallery(state: TrackerState, match_det: torch.Tensor,
                  det_for_slot: torch.Tensor, det_feat: torch.Tensor,
                  nn_budget: int):
    """Ring-buffer gallery writes, in place: matched tracks append their
    detection's feature at ``gallery_head``; new tracks write slot 0.
    Returns the new (head, count).

    Every (stream, track) row writes its slot, rows with nothing new
    rewrite the value already there: the index sets have a fixed size, so
    the scatter needs no host sync (a boolean-mask index would read the
    mask's nonzero count back once per index)."""
    s, t = match_det.shape
    sidx = torch.arange(s, device=match_det.device)[:, None].expand(s, t)
    tidx = torch.arange(t, device=match_det.device)[None, :].expand(s, t)

    def put(slot, det, write):
        feat = torch.gather(det_feat, 1, det.clamp(min=0).long()[..., None]
                            .expand(-1, -1, det_feat.shape[-1]))
        old = state.gallery[sidx, tidx, slot]
        state.gallery[sidx, tidx, slot] = torch.where(write[..., None], feat,
                                                      old)

    matched = match_det >= 0
    put(state.gallery_head.long(), match_det, matched)
    head = torch.where(matched, (state.gallery_head + 1) % nn_budget,
                       state.gallery_head)
    count = torch.where(matched,
                        (state.gallery_count + 1).clamp(max=nn_budget),
                        state.gallery_count)
    is_new = det_for_slot >= 0
    put(torch.zeros_like(tidx), det_for_slot, is_new)
    head = torch.where(is_new, torch.full_like(head, 1 % nn_budget), head)
    count = torch.where(is_new, torch.ones_like(count), count)
    return head.to(torch.int32), count.to(torch.int32)


def emit_outputs(mean: torch.Tensor, state: torch.Tensor, tsu: torch.Tensor,
                 track_id: torch.Tensor, img_hw: Tuple[int, int]):
    """Confirmed tracks with tsu <= 1 as int [x1, y1, x2, y2, id] rows
    clipped to the frame: ((S, T, 5) int32, (S, T) bool)."""
    emit = (state == STATE_CONFIRMED) & (tsu <= 1)
    tlwh = B.xyah_to_tlwh(mean[..., :4])
    x, y, w, h = tlwh.unbind(-1)
    height, width = img_hw
    x1 = x.to(torch.int32).clamp(min=0)
    y1 = y.to(torch.int32).clamp(min=0)
    x2 = (x + w).to(torch.int32).clamp(max=width - 1)
    y2 = (y + h).to(torch.int32).clamp(max=height - 1)
    return torch.stack([x1, y1, x2, y2, track_id.to(torch.int32)], -1), emit


def tracker_step(
    cfg: TrackerConfig,
    state: TrackerState,
    det_tlwh: torch.Tensor,  # (S, D, 4) f32
    det_conf: torch.Tensor,  # (S, D) f32
    det_feat: torch.Tensor,  # (S, D, F) f32, L2-normalized
    det_mask: torch.Tensor,  # (S, D) bool
    img_hw: Tuple[int, int],  # (height, width) for output clipping
):
    """One frame of DeepSORT association for every stream.

    Returns (new_state, outputs (S, T, 5) int32 [x1, y1, x2, y2, id],
    emit (S, T) bool). Writes ``state.gallery`` in place."""
    s, t = state.state.shape
    d = det_tlwh.shape[1]
    dev = det_tlwh.device
    det_mask = det_mask & (det_conf > cfg.min_confidence)
    det_xyah = B.tlwh_to_xyah(det_tlwh)

    st0 = state.state
    active = st0 > STATE_FREE
    confirmed = st0 == STATE_CONFIRMED
    tentative = st0 == STATE_TENTATIVE

    # ---- predict
    new_mean, new_cov = K.predict(state.mean, state.cov)
    mean = torch.where(active[..., None], new_mean, state.mean)
    cov = torch.where(active[..., None, None], new_cov, state.cov)
    tsu = state.time_since_update + active.to(torch.int32)
    age = state.age + active.to(torch.int32)

    # ---- stage costs: gated appearance; IoU for the second stage
    app = appearance_cost(state, det_feat, cfg)
    maha = K.gating_distance_matrix(mean, cov, det_xyah)
    gated = torch.where(maha > K.CHI2INV95_4DOF,
                        torch.full_like(app, INFTY_COST), app)
    track_tlwh = B.xyah_to_tlwh(mean[..., :4])
    iou_cost = 1.0 - B.iou_tlwh(track_tlwh, det_tlwh)
    iou_cost = torch.where((tsu > 1)[..., None],
                           torch.full_like(iou_cost, INFTY_COST), iou_cost)
    rows_b_super = tentative | (confirmed & (tsu == 1))

    match_a, match_b = solve_two_stage_assignment_fused(
        gated, tsu - 1, confirmed, det_mask, cfg.max_dist, iou_cost,
        rows_b_super, cfg.max_iou_distance)
    match = torch.where(match_a >= 0, match_a, match_b)
    matched = match >= 0

    # ---- update matched tracks
    meas = torch.gather(det_xyah, 1, match.clamp(min=0).long()[..., None]
                        .expand(-1, -1, 4))
    upd_mean, upd_cov = K.update(mean, cov, meas)
    mean = torch.where(matched[..., None], upd_mean, mean)
    cov = torch.where(matched[..., None, None], upd_cov, cov)
    hits = state.hits + matched.to(torch.int32)
    tsu = torch.where(matched, torch.zeros_like(tsu), tsu)
    trk_state = torch.where(matched & tentative & (hits >= cfg.n_init),
                            torch.full_like(st0, STATE_CONFIRMED), st0)

    # ---- mark missed: tentative miss or stale confirmed -> delete
    deleted = active & ~matched & (tentative | (tsu > cfg.max_age))
    trk_state = torch.where(deleted, torch.zeros_like(trk_state), trk_state)
    track_id = torch.where(deleted, torch.zeros_like(state.track_id),
                           state.track_id)

    # ---- initiate: r-th unmatched detection -> r-th free slot
    taken = torch.zeros((s, d + 1), dtype=torch.bool, device=dev)
    taken.scatter_(1, torch.where(match >= 0, match, d).long(), True)
    unmatched_det = det_mask & ~taken[:, :d]
    free_slot = trk_state == STATE_FREE
    det_rank = torch.cumsum(unmatched_det.to(torch.int32), 1) - 1  # (S, D)
    n_free = free_slot.sum(1, keepdim=True)
    slot_order = torch.argsort((~free_slot).to(torch.int8), dim=1, stable=True)
    can_init = unmatched_det & (det_rank < n_free)
    target = torch.where(
        can_init,
        torch.gather(slot_order, 1, det_rank.clamp(0, t - 1).long()),
        torch.full_like(slot_order[:, :d], t))
    det_for_slot = torch.full((s, t + 1), -1, dtype=torch.int32, device=dev)
    det_for_slot.scatter_(1, target.long(),
                          torch.arange(d, dtype=torch.int32,
                                       device=dev).expand(s, d).contiguous())
    det_for_slot = det_for_slot[:, :t]
    is_new = det_for_slot >= 0
    new_det = det_for_slot.clamp(min=0).long()

    init_mean, init_cov = K.initiate(
        torch.gather(det_xyah, 1, new_det[..., None].expand(-1, -1, 4)))
    mean = torch.where(is_new[..., None], init_mean, mean)
    cov = torch.where(is_new[..., None, None], init_cov, cov)
    trk_state = torch.where(is_new, torch.full_like(trk_state, STATE_TENTATIVE),
                            trk_state)
    track_id = torch.where(
        is_new, state.next_id[:, None] + torch.gather(det_rank, 1, new_det),
        track_id).to(torch.int32)
    hits = torch.where(is_new, torch.ones_like(hits), hits)
    age = torch.where(is_new, torch.ones_like(age), age)
    tsu = torch.where(is_new, torch.zeros_like(tsu), tsu)
    match_det = torch.where(matched, match, -1)
    head, count = write_gallery(state, match_det, det_for_slot, det_feat,
                                cfg.nn_budget)
    next_id = state.next_id + can_init.sum(1, dtype=torch.int32)

    new_state = TrackerState(
        mean=mean, cov=cov, track_id=track_id, state=trk_state.to(torch.int32),
        hits=hits.to(torch.int32), age=age.to(torch.int32),
        time_since_update=tsu.to(torch.int32), gallery=state.gallery,
        gallery_head=head, gallery_count=count,
        next_id=next_id.to(torch.int32))
    outputs, emit = emit_outputs(mean, new_state.state,
                                 new_state.time_since_update, track_id, img_hw)
    return new_state, outputs, emit
