"""Multi-rank serving soak over the stream mesh (port of
``tools/soak_multichip.py``).

One process (rank) per device, one stream per rank, joined as the dryrun
tools join (``tools/dryrun_multihost.py`` ``rank_parser`` / ``join``: NCCL
on the card, gloo with ``--device cpu``). Every rank runs its stream
through ``parallel/streams.py`` ``make_sharded_step`` (the batched step:
kernel 1, the dense crops, kernel 3 and kernel 7 for every conv; no
collective) and, after every step, ``make_global_id_step`` (the mesh's
gathers), for many chunks of K steps, on the honest load
(``tools/honest_load.py``; rank 0's weights and thresholds broadcast to
every rank, so the models are replicated exactly). It checks what
``tools/soak.py`` checks, over every rank's streams, plus the mesh's own
invariants:

  * finite tracker state and gallery counts within budget;
  * a stable confirmed-track population (drift beyond max(4, 50 %) fails);
  * state, outputs and global ids lie on ``mesh.device`` (the reference
    checks that they stay sharded on the stream axis);
  * a lane whose local track id did not change keeps its global id (the
    handoff never relabels a live track).

Each check is one readback: a summary computed on the device and summed
over the ranks with one all-reduce -- [non-finite, confirmed tracks, over
budget, gid changed on a stable lane, streams] -- so every rank reaches the
same verdict.

    python -m yolo_deepsort_tpu_torch.tools.soak_multichip \\
        --coordinator 127.0.0.1:9345 --num-processes 2 --process-id 0 \\
        [--chunks 100] [--device cuda|cpu]

(run every process id at once). Each rank prints one JSON line (the
reference's keys, plus ``rank``, ``route``, ``device`` and ``launches``:
this rank's kernel launches in the timed run) and exits 0 iff no invariant
failed on any rank.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import device_name
from ..kernels.launches import read_launches, zero_launches
from ..tracking.tracker import STATE_CONFIRMED
from .dryrun_multihost import join, rank_parser
from .soak import check, emitted_rows, far_outside


def _all_reduce(x: torch.Tensor, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if mesh.group is not None:
        dist.all_reduce(x, op=op, group=mesh.group)
    return x


@torch.no_grad()
def summarize(mesh, states, gids, prev_tid, prev_gid, nn_budget: int):
    """(5,) float32, summed over the ranks: [ranks with non-finite state,
    confirmed tracks, ranks with a gallery over budget, ranks where a
    stable lane's gid changed, streams]."""
    finite = (torch.isfinite(states.mean).all()
              & torch.isfinite(states.cov).all()
              & torch.isfinite(states.gallery).all())
    tid = states.track_id
    stable = (tid == prev_tid) & (tid > 0)
    changed = (stable & (gids.gid != prev_gid)).any()
    local = torch.stack([
        (~finite).float(),
        (states.state == STATE_CONFIRMED).float().sum(),
        (states.gallery_count > nn_budget).any().float(),
        changed.float(),
        torch.full((), float(tid.shape[0]), device=tid.device)])
    return _all_reduce(local, mesh)


def max_next_id(mesh, states) -> float:
    return _all_reduce(states.next_id.max().float(), mesh,
                       dist.ReduceOp.MAX).item()


@torch.no_grad()
def replicate(mesh, detector, conf_vec: np.ndarray) -> np.ndarray:
    """Rank 0's weights and thresholds on every rank."""
    if mesh.group is None:
        return conf_vec
    for t in list(detector.parameters()) + list(detector.buffers()):
        dist.broadcast(t.data, 0, group=mesh.group)
    conf = torch.from_numpy(conf_vec).to(mesh.device)
    dist.broadcast(conf, 0, group=mesh.group)
    return conf.cpu().numpy()


def soak(args, mesh) -> dict:
    from ..config import DetectorConfig, TrackerConfig
    from ..models.reid import random_reid_params
    from ..parallel.streams import (
        init_global_ids,
        init_stream_states,
        make_global_id_step,
        make_sharded_step,
        relabel_outputs_global,
    )
    from ..weights import reid_from_params
    from .honest_load import bn_weights_and_frames

    n, me, dev = mesh.size, mesh.rank, mesh.device
    s = n  # one stream per rank: the scale-out unit of the design
    hw = (args.frame_h, args.frame_w)
    k = args.frames_per_chunk
    load = bn_weights_and_frames(args.model, args.img_size, k, s, hw,
                                 args.target_dets, device=dev)
    conf_vec = replicate(mesh, load.detector_bf16, load.conf_vec)
    reid = reid_from_params(random_reid_params(0)).to(
        dev, torch.bfloat16, memory_format=torch.channels_last)
    trk_cfg = TrackerConfig(max_dets=32)
    det_cfg = DetectorConfig(img_size=args.img_size,
                             conf_thres=float(conf_vec.mean()))
    step = make_sharded_step(mesh, load.detector_bf16, reid, det_cfg,
                             trk_cfg, hw)
    gid_step = make_global_id_step(mesh, trk_cfg, n_streams_total=s)
    states = init_stream_states(trk_cfg, 1, dev)
    gids = init_global_ids(trk_cfg, 1, dev)
    frames = [load.frames[i % k, me:me + 1].contiguous() for i in range(k)]

    # warm-up: first calls and a confirmed track population
    for i in range(3 * k):
        states, (outputs, emit) = step(states, frames[i % k])
        gids = gid_step(states, gids)
    prev_tid, prev_gid = states.track_id.clone(), gids.gid.clone()
    base = summarize(mesh, states, gids, prev_tid, prev_gid,
                     trk_cfg.nn_budget).tolist()
    base_tracks = base[1] / base[4]
    base_next_id = max_next_id(mesh, states)

    failures, track_counts = [], []
    zero_launches()
    t0 = time.perf_counter()
    for c in range(args.chunks):
        for i in range(k):
            states, (outputs, emit) = step(states, frames[i])
            gids = gid_step(states, gids)
        out_g = relabel_outputs_global(outputs, gids)
        if (c + 1) % args.check_every == 0:
            print(f"[soak] rank {me}: chunk {c + 1}/{args.chunks}",
                  file=sys.stderr, flush=True)
            bad, tracks, over, changed, streams = summarize(
                mesh, states, gids, prev_tid, prev_gid,
                trk_cfg.nn_budget).tolist()
            tracks /= streams
            track_counts.append(tracks)
            failures += check([not bad, tracks, over, None], base_tracks,
                              f"chunk {c}", drift=0.5)
            if not all(t.device == dev for t in (out_g, states.mean,
                                                  gids.gid)):
                failures.append(f"chunk {c}: outputs/state/gids left "
                                f"{dev}")
            if changed:
                failures.append(f"chunk {c}: global id changed on a "
                                "stable track lane")
            prev_tid, prev_gid = states.track_id.clone(), gids.gid.clone()
    if far_outside(emitted_rows(out_g, emit), hw):
        failures.append("final chunk: emitted boxes far outside the frame")
    dt = time.perf_counter() - t0
    launches = read_launches()

    id_growth = max_next_id(mesh, states) - base_next_id
    frames_total = args.chunks * k * s
    return {
        "metric": f"multichip soak fps ({n}-rank stream mesh)",
        "value": round(frames_total / dt, 2),
        "unit": "frames/sec",
        "devices": n,
        "chunks": args.chunks,
        "frames": frames_total,
        "minutes": round(dt / 60, 2),
        "tracks_mean": (round(float(np.mean(track_counts)), 1)
                        if track_counts else None),
        "id_growth_per_chunk": round(id_growth / args.chunks, 2),
        "failures": failures,
        "ok": not failures,
        "rank": me,
        "route": dev.type,
        "backend": "none" if mesh.group is None else dist.get_backend(
            mesh.group),
        "device": device_name(dev),
        "base_tracks": round(base_tracks, 1),
        "checks": len(track_counts),
        "launches": launches,
    }


def run(argv=None) -> dict:
    ap = rank_parser(__doc__)
    ap.add_argument("--chunks", type=int, default=100)
    ap.add_argument("--frames-per-chunk", type=int, default=4)
    ap.add_argument("--model", default="yolov3-tiny")
    ap.add_argument("--img-size", type=int, default=160)
    ap.add_argument("--frame-h", type=int, default=256)
    ap.add_argument("--frame-w", type=int, default=320)
    ap.add_argument("--target-dets", type=int, default=12)
    ap.add_argument("--check-every", type=int, default=10)
    args = ap.parse_args(argv)

    from ..parallel.mesh import make_stream_mesh

    device = join(args)
    try:
        # the default group, also for one rank: the mesh's collectives go
        # through NCCL (gloo) even then
        mesh = make_stream_mesh(device=device)
        if mesh.size != args.num_processes:
            raise ValueError(f"the job has {mesh.size} ranks, not "
                             f"{args.num_processes}")
        return soak(args, mesh)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    rec = run(argv)
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
