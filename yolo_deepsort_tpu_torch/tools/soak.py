"""Sustained-serving soak (port of ``tools/soak.py``, its device-resident
mode): the serving step for many chunks, with the long-horizon invariants a
deployment relies on checked as it runs.

The step is ``parallel/streams.py`` ``BucketedScannedStep`` on the honest
load (``tools/honest_load.py``: BN-consistent weights, the MOT box prior,
per-stream thresholds calibrated on the frames), bf16 detector and ReID
net, pipelined one chunk deep as the reference runs it: chunk i + 1's
detect stage (kernel 1, kernel 7 for every conv) is enqueued before chunk
i's track stage (the chunk's one stats readback, crops through kernel 2,
the ReID net through kernel 7, K launches of kernel 3).

Every ``--check-every`` chunks one summary computed on the device comes
back as ONE 4-value readback (``summarize``): finite Kalman state,
covariance and gallery; the mean confirmed-track population; any gallery
count over its budget; the largest next id. ``check`` turns it into
failures: non-finite state, a gallery over budget, or a track population
that drifted from the warm-up's by more than max(4, 25 %). The record gives
the sustained frames/s over the whole run (checks included), the track
population's range and the id growth per chunk.

``--ingest`` (decoded video through the native rings) waits for a video
decoder on the card's machine.

    python3 -m yolo_deepsort_tpu_torch.tools.soak [--chunks 100]
        [--scan 16] [--streams 8] [--device cuda|cpu]

Prints one JSON line (the reference's keys, plus ``route``, ``device``,
``stats_readbacks`` and ``launches``: every port kernel's launches in the
timed run); exits 0 iff no invariant failed. ``--device`` defaults to the
card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import device_name, resolve_device
from ..kernels.launches import read_launches, zero_launches
from ..tracking.tracker import STATE_CONFIRMED


@torch.no_grad()
def summarize(states, nn_budget: int) -> torch.Tensor:
    """(4,) float32 on the states' device: [finite (1/0), mean confirmed
    tracks per stream, gallery over budget (1/0), max next id]."""
    finite = (torch.isfinite(states.mean).all()
              & torch.isfinite(states.cov).all()
              & torch.isfinite(states.gallery).all())
    tracks = (states.state == STATE_CONFIRMED).float().sum(-1).mean()
    over = (states.gallery_count > nn_budget).any()
    return torch.stack([finite.float(), tracks, over.float(),
                        states.next_id.max().float()])


def check(summary, base_tracks: float, tag: str, drift: float = 0.25):
    """Failures of one read summary (``summarize(...).tolist()``); a track
    population further than max(4, ``drift`` x base) from ``base_tracks``
    counts as drift."""
    finite, tracks, over, _ = summary
    failures = []
    if not finite:
        failures.append(f"{tag}: non-finite tracker state")
    if over:
        failures.append(f"{tag}: gallery_count over budget")
    if abs(tracks - base_tracks) > max(4.0, drift * base_tracks):
        failures.append(f"{tag}: track population drifted "
                        f"{base_tracks:.1f} -> {tracks:.1f}")
    return failures


def emitted_rows(outputs, emit) -> np.ndarray:
    """The emitted rows of the last frame's outputs, read on the host."""
    return outputs.cpu().numpy()[emit.cpu().numpy()]


def far_outside(rows: np.ndarray, hw) -> bool:
    """Outputs are int32 rows, so a NaN state surfaces as huge cast
    values: bound-check the emitted boxes."""
    return bool(rows.size and (np.abs(rows[:, :4]) > 4 * max(hw)).any())


def soak(step, states, frames, chunks: int, check_every: int,
         nn_budget: int, hw) -> dict:
    """The soak loop on a built ``BucketedScannedStep``: 3 warm-up chunks
    (first calls and a confirmed track population), then ``chunks`` chunks
    of ``frames`` pipelined one chunk deep, checked every ``check_every``.
    -> the measured part of the record: ``secs`` (the timed chunks),
    ``base_tracks``, ``track_counts`` (one a check), ``id_growth``,
    ``failures``, ``stats_readbacks`` and ``launches`` (the timed chunks'),
    and ``states``."""
    for _ in range(3):
        states, (outputs, emit) = step(states, frames)
    base = summarize(states, nn_budget).tolist()
    base_tracks, base_next_id = base[1], base[3]

    failures, track_counts = [], []
    zero_launches()
    readbacks = step.host_readbacks
    t0 = time.perf_counter()
    nxt = step.detect(frames)
    for i in range(chunks):
        cur = nxt
        if i + 1 < chunks:  # no dead detect after the final chunk
            nxt = step.detect(frames)
        states, (outputs, emit) = step.track(states, cur)
        if (i + 1) % check_every == 0:
            summary = summarize(states, nn_budget).tolist()
            track_counts.append(summary[1])
            failures += check(summary, base_tracks, f"chunk {i}")
    if far_outside(emitted_rows(outputs, emit), hw):
        failures.append("final chunk: emitted boxes far outside the frame")
    secs = time.perf_counter() - t0
    launches = read_launches()
    readbacks = step.host_readbacks - readbacks
    id_growth = summarize(states, nn_budget)[3].item() - base_next_id
    return {"secs": secs, "base_tracks": base_tracks,
            "track_counts": track_counts, "id_growth": id_growth,
            "failures": failures, "stats_readbacks": readbacks,
            "launches": launches, "states": states}


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chunks", type=int, default=100)
    p.add_argument("--scan", type=int, default=16)
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--model", default="yolov3")
    p.add_argument("--img-size", type=int, default=416)
    p.add_argument("--target-dets", type=int, default=32)
    p.add_argument("--frame-h", type=int, default=1080)
    p.add_argument("--frame-w", type=int, default=1920)
    p.add_argument("--check-every", type=int, default=10,
                   help="invariant-check cadence (each check is one "
                        "4-value readback)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from ..config import DetectorConfig, TrackerConfig
    from ..models.reid import random_reid_params
    from ..parallel.streams import BucketedScannedStep, init_stream_states
    from ..weights import reid_from_params
    from .honest_load import bn_weights_and_frames

    k, s, hw = args.scan, args.streams, (args.frame_h, args.frame_w)
    load = bn_weights_and_frames(args.model, args.img_size, k, s, hw,
                                 args.target_dets, device=dev)
    reid = reid_from_params(random_reid_params(0)).to(
        dev, torch.bfloat16, memory_format=torch.channels_last)
    trk_cfg = TrackerConfig(max_dets=64)
    det_cfg = DetectorConfig(img_size=args.img_size,
                             conf_thres=float(load.conf_vec.mean()))
    step = BucketedScannedStep(
        load.detector_bf16, reid, det_cfg, trk_cfg, hw,
        buckets=(16, 24, 32, 36, 40, 48),
        conf_thres_per_stream=load.conf_vec)
    res = soak(step, init_stream_states(trk_cfg, s, dev), load.frames,
               args.chunks, args.check_every, trk_cfg.nn_budget, hw)

    counts = res["track_counts"]
    frames_total = args.chunks * k * s
    return {
        "metric": "sustained soak fps/chip",
        "value": round(frames_total / res["secs"], 2),
        "unit": "frames/sec/chip",
        "chunks": args.chunks,
        "frames": frames_total,
        "minutes": round(res["secs"] / 60, 2),
        "tracks_mean": round(float(np.mean(counts)), 1) if counts else None,
        "tracks_min": round(float(np.min(counts)), 1) if counts else None,
        "tracks_max": round(float(np.max(counts)), 1) if counts else None,
        "id_growth_per_chunk": round(res["id_growth"] / args.chunks, 2),
        "failures": res["failures"],
        "ok": not res["failures"],
        "route": dev.type,
        "device": device_name(dev),
        "base_tracks": round(res["base_tracks"], 1),
        "capacity_bucket": step.last_bucket,
        "crop_window": step.last_window,
        "stats_readbacks": res["stats_readbacks"],
        "checks": len(counts),
        "launches": res["launches"],
    }


def main(argv=None) -> int:
    rec = run(argv)
    print(json.dumps(rec))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
