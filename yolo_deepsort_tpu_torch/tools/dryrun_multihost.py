"""Multi-rank dryrun of the stream mesh (port of ``tools/dryrun_multihost.py``
and of parts (b)-(c) of ``__graft_entry__.py`` ``dryrun_multichip``).

Runs as one process (rank) of an N-process ``torch.distributed`` job, one
device per rank, and drives the port's real cross-rank paths:

  1. the sharded tracking step (``make_sharded_step``: yolov3-tiny at 96 px
     with seeded weights, this rank's streams) -- zero collectives;
  2. the cross-camera global-ID handoff: tracker steps on every rank's
     streams and the global-id step after each, whose gathers are the only
     cross-rank traffic. An object leaves rank 0's first stream and appears
     on the last rank's last stream: it must keep global id 1.

The last rank prints "... cross-host global-id handoff ok", every other
rank "... tracking + collectives ok". ``--device cuda`` (the default) runs
on the card ``cuda:{process id % cards}`` over NCCL and raises without
one; ``--device cpu`` runs on the CPU over gloo. Run every process id at
once, e.g. rank 0 of 2 on the CPU:

  python -m yolo_deepsort_tpu_torch.tools.dryrun_multihost \\
      --coordinator 127.0.0.1:9345 --num-processes 2 --process-id 0 \\
      --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from ..config import DetectorConfig, TrackerConfig
from ..device import resolve_device
from ..parallel.mesh import make_stream_mesh
from ..parallel.streams import (
    init_global_ids,
    init_stream_states,
    make_global_id_step,
    make_sharded_step,
    relabel_outputs_global,
)
from ..tracking.tracker import STATE_CONFIRMED, tracker_step


def sharded_tracking(mesh, s_loc: int):
    """Part 1: one sharded step over this rank's ``s_loc`` streams."""
    from ..api import Darknet
    from ..models.reid import random_reid_params
    from ..weights import reid_from_params

    det_cfg = DetectorConfig(img_size=96, conf_thres=0.5, nms_thres=0.4,
                             max_boxes=64)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=5)
    frame_hw = (64, 96)
    detector = Darknet("yolov3-tiny", img_size=96, device=mesh.device).module
    reid = reid_from_params(random_reid_params(0)).to(mesh.device)
    step = make_sharded_step(mesh, detector, reid, det_cfg, trk_cfg,
                             frame_hw)
    frames = torch.zeros((s_loc, *frame_hw, 3), dtype=torch.uint8,
                         device=mesh.device)
    states = init_stream_states(trk_cfg, s_loc, mesh.device)
    states, (outputs, emit) = step(states, frames)
    return outputs


def global_id_handoff(mesh, s_loc: int, n_frames: int = 16):
    """Part 2: the handoff scene; -> (gid table, tracker state, relabeled
    outputs, emit) of this rank's streams after the last frame."""
    cfg = TrackerConfig(max_tracks=8, max_dets=4, feat_dim=32, nn_budget=5)
    n = mesh.size * s_loc
    gid_step = make_global_id_step(mesh, cfg, n_streams_total=n)
    states = init_stream_states(cfg, s_loc, mesh.device)
    gids = init_global_ids(cfg, s_loc, mesh.device)
    rng = np.random.default_rng(0)  # one seed everywhere: one appearance
    f_obj = rng.normal(size=32).astype(np.float32)
    f_obj /= np.linalg.norm(f_obj)
    last = mesh.size - 1
    for t in range(n_frames):
        d = cfg.max_dets
        tlwh = np.zeros((s_loc, d, 4), np.float32)
        conf = np.zeros((s_loc, d), np.float32)
        feat = np.zeros((s_loc, d, 32), np.float32)
        mask = np.zeros((s_loc, d), bool)
        # rank 0 / its stream 0 sees the object for t < 10, the last rank's
        # last stream from t >= 8 (two frames of overlap)
        if mesh.rank == 0 and t < 10:
            tlwh[0, 0] = [200 + 5 * t, 300, 40, 80]
            conf[0, 0], feat[0, 0], mask[0, 0] = 0.9, f_obj, True
        if mesh.rank == last and t >= 8:
            tlwh[-1, 0] = [100 + 5 * t, 400, 40, 80]
            conf[-1, 0], feat[-1, 0], mask[-1, 0] = 0.9, f_obj, True
        host = (tlwh, conf, feat, mask)
        tlwh, conf, feat, mask = (torch.from_numpy(a).to(mesh.device)
                                  for a in host)
        states, outputs, emit = tracker_step(cfg, states, tlwh, conf, feat,
                                             mask, (720, 1280))
        gids = gid_step(states, gids)
    out_g = relabel_outputs_global(outputs, gids)
    return (gids.gid.cpu().numpy(), states.state.cpu().numpy(),
            out_g.cpu().numpy(), emit.cpu().numpy())


def rank_parser(doc: str) -> argparse.ArgumentParser:
    """The arguments of one rank of a dryrun job: --coordinator,
    --num-processes, --process-id and --device."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--coordinator", default="127.0.0.1:9345",
                    help="host:port of rank 0's store")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the card over NCCL; cpu: gloo")
    return ap


def join(args) -> torch.device:
    """Join the job as rank ``--process-id``: NCCL on the card ``cuda:{id %
    cards}`` (raises without one) or gloo on the CPU. -> the device."""
    n, me = args.num_processes, args.process_id
    if args.device == "cuda":
        resolve_device("cuda")  # raises without a card
        device = torch.device("cuda", me % torch.cuda.device_count())
        dist.init_process_group("nccl", init_method=f"tcp://"
                                f"{args.coordinator}", world_size=n,
                                rank=me, device_id=device)
    else:
        device = torch.device("cpu")
        dist.init_process_group("gloo", init_method=f"tcp://"
                                f"{args.coordinator}", world_size=n, rank=me)
    return device


def main(argv=None) -> int:
    ap = rank_parser(__doc__)
    ap.add_argument("--streams-per-rank", type=int, default=4)
    args = ap.parse_args(argv)
    n, me, s_loc = args.num_processes, args.process_id, args.streams_per_rank
    if n * s_loc < 2:
        raise ValueError("the handoff needs at least two streams")
    device = join(args)
    try:
        mesh = make_stream_mesh(n, device=device)
        outputs = sharded_tracking(mesh, s_loc)
        print(f"[dryrun] rank {me}: sharded tracking step ok over the "
              f"{n}-rank stream mesh: outputs {tuple(outputs.shape)}",
              flush=True)
        gid, state, out_g, emit = global_id_handoff(mesh, s_loc)
        print(f"[dryrun] rank {me}: global-id handoff step ok: gid table "
              f"{gid.shape}", flush=True)
        if me == n - 1:
            lane = int(np.argmax(state[-1] == STATE_CONFIRMED))
            shown = out_g[-1][emit[-1]][:, 4]  # the emitted rows' ids
            if (state[-1, lane] != STATE_CONFIRMED or gid[-1, lane] != 1
                    or shown.tolist() != [1]):
                raise AssertionError(f"cross-host handoff failed: gids "
                                     f"{gid[-1]}, states {state[-1]}, "
                                     f"emitted ids {shown}")
            print(f"[multihost] rank {me}: cross-host global-id handoff ok "
                  f"-- gid 1 adopted across ranks", flush=True)
        else:
            print(f"[multihost] rank {me}: tracking + collectives ok over "
                  f"{n}-rank mesh ({n * s_loc} streams)", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
