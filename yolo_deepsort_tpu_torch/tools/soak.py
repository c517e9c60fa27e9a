"""Sustained-serving soak (port of ``tools/soak.py``): the serving step for
many chunks, with the long-horizon invariants a deployment relies on
checked as it runs.

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

``--ingest`` runs the same step end to end from decoded video
(``soak_ingest``): S clips written by ``ensure_clips`` (cv2, mp4v, cached
in ``--clip-dir``), S looping cv2 decoder threads feeding the native frame
rings (``runtime/native.py`` ``FramePool``, depth max(2K, 8)) with
backpressure -- a full ring makes its decoder wait, no frame is lost --,
chunk assembly straight into one of two pinned host buffers, the upload,
and the step pipelined one chunk deep. Its record gives the frames/s
including decode and transfer, the decode-only ceiling (S decoders and no
device work for ``--decode-probe-secs``), the share of the run spent
waiting for frames, the decoders' frames/s during the run, the
host-to-device ceiling of one chunk and the resource that bounds the run
(``bound_label``). Its thresholds are recalibrated on each clip's first
frame, one a stream, as the device-resident soak's are: the reference's
ingest step takes only their mean, which lets a stream whose own
threshold lies above the mean through by the hundreds.

    python3 -m yolo_deepsort_tpu_torch.tools.soak [--chunks 100]
        [--scan 16] [--streams 8] [--device cuda|cpu]
    python3 -m yolo_deepsort_tpu_torch.tools.soak --ingest [--clip-dir D]
        [--clip-frames 300] [--decode-probe-secs 6] [--device cuda|cpu]

Prints one JSON line (the reference's keys, plus ``route``, ``device``,
``stats_readbacks`` and ``launches``: every port kernel's launches in the
timed run; ``--ingest`` also ``popping_frac``, the share of the run the
loop spent popping frames from the rings, the BGR->RGB gather); exits 0
iff no invariant failed. ``--device`` defaults to the
card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
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


def ensure_clips(clip_dir, s, hw, n_frames, fps=30.0):
    """S decodable soak clips (a copy of the reference's ``_ensure_clips``):
    a blurred textured background and 16 moving filled boxes, mp4v,
    ``soak_{i}_{h}x{w}_{n_frames}.mp4`` in ``clip_dir``; a clip already
    there is kept. -> their paths."""
    import cv2

    h, w = hw
    os.makedirs(clip_dir, exist_ok=True)
    paths = []
    rng = np.random.default_rng(7)
    for i in range(s):
        path = os.path.join(clip_dir, f"soak_{i}_{h}x{w}_{n_frames}.mp4")
        paths.append(path)
        if os.path.exists(path):
            continue
        bg = rng.integers(40, 160, (h, w, 3), dtype=np.uint8)
        bg = cv2.GaussianBlur(bg, (0, 0), 3)
        n_obj = 16
        px, py = max(w - 80, 1), max(h - 160, 1)  # small test frames too
        pos = rng.uniform(0, [px, py], (n_obj, 2))
        vel = rng.normal(0, 4, (n_obj, 2))
        size = rng.uniform([40, 90], [90, 220], (n_obj, 2))
        size = np.minimum(size, [max(w // 3, 2), max(h // 2, 2)])
        color = rng.integers(0, 255, (n_obj, 3))
        wri = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                              (w, h))
        if not wri.isOpened():
            raise IOError(f"cannot write {path}")
        for _ in range(n_frames):
            frame = bg.copy()
            pos = pos + vel
            pos[:, 0] %= px
            pos[:, 1] %= py
            for o in range(n_obj):
                x, y = int(pos[o, 0]), int(pos[o, 1])
                bw, bh = int(size[o, 0]), int(size[o, 1])
                cv2.rectangle(frame, (x, y), (min(x + bw, w - 1),
                                              min(y + bh, h - 1)),
                              color[o].tolist(), -1)
            wri.write(frame)
        wri.release()
    return paths


def bound_label(achieved, decode_only, decode_during, transfer_ceiling):
    """The resource that bounds an ingest run (the reference's
    ``_bound_label``). ``decode_during``, the frames the decoders pushed per
    second during the run, catches a host where decode, assembly and
    dispatch serialize and no ceiling alone binds."""
    if decode_only < achieved * 1.1:
        return "host-decode"
    if transfer_ceiling < achieved * 1.3:
        return "h2d-transfer"
    if decode_during < achieved * 1.6:
        return "host-serialized (decode+assembly+dispatch on one core)"
    return "chip"


def first_frames_rgb(clips) -> np.ndarray:
    """(S, H, W, 3) uint8: each clip's first decoded frame, RGB."""
    import cv2

    first = []
    for path in clips:
        cap = cv2.VideoCapture(path)
        try:
            ok, frame = cap.read()
        finally:
            cap.release()
        if not ok:
            raise IOError(f"cannot decode {path}")
        first.append(np.ascontiguousarray(frame[:, :, ::-1]))
    return np.stack(first)


def _looping_decode(path, stop: threading.Event, emit) -> None:
    """Decode ``path`` from its start again and again, handing each BGR
    frame to ``emit`` (which returns False to end), until ``stop``."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        since_rewind = 0
        while not stop.is_set():
            ok, frame = cap.read()
            if not ok:
                if since_rewind == 0:
                    raise IOError(f"cannot decode {path}")
                cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
                since_rewind = 0
                continue
            since_rewind += 1
            if not emit(frame):
                return
    finally:
        cap.release()


def decode_only_fps(clips, secs: float) -> float:
    """S looping decoder threads and no device work for ``secs``: the
    frames decoded per second, all streams together."""
    stop = threading.Event()
    counts = [0] * len(clips)

    def count(i):
        def emit(_):
            counts[i] += 1
            return True
        _looping_decode(clips[i], stop, emit)

    threads = [threading.Thread(target=count, args=(i,), daemon=True)
               for i in range(len(clips))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(secs)
    stop.set()
    for t in threads:
        t.join(timeout=3)
    return sum(counts) / (time.perf_counter() - t0)


class Decoders:
    """S looping cv2 decoders feeding ``pool`` (a ``FramePool``) with
    backpressure: a full ring makes its decoder wait (``push_wait``), so no
    frame is lost. ``pushed[i]`` counts stream i's frames in its ring."""

    def __init__(self, clips, pool):
        self.pool = pool
        self.stop = threading.Event()
        self.pushed = [0] * len(clips)
        self.errors = []
        self._threads = [threading.Thread(target=self._run, args=(i, p),
                                          daemon=True)
                         for i, p in enumerate(clips)]

    def _run(self, i, path):
        def emit(frame):
            if not self.pool.push_wait(i, frame, self.stop):
                return False
            self.pushed[i] += 1
            return True
        try:
            _looping_decode(path, self.stop, emit)
        except Exception as e:  # reported by the assembler, which waits
            self.errors.append(f"decoder {i}: {e!r}")
            raise

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def check(self) -> None:
        """Raise when a decoder has died: its stream would never fill."""
        if self.errors or not all(t.is_alive() for t in self._threads):
            raise RuntimeError(f"a decoder ended: {self.errors}")

    def close(self) -> None:
        self.stop.set()
        self.pool.wake()
        for t in self._threads:
            t.join(timeout=3)


class ChunkStage:
    """Two pinned (K, S, H, W, 3) host buffers used in turn. ``assemble``
    fills the next one with K batches popped from the pool (each written
    straight into its slice) and ``upload`` sends it to the device. A
    buffer is refilled only after the event recorded behind its last
    upload: an upload from pinned memory is still in flight when the host
    goes on. On the CPU the upload is a copy."""

    def __init__(self, pool, decoders: Decoders, k: int, dev):
        s, (h, w) = pool.n_streams, pool.shape
        self.pool, self.decoders, self.dev = pool, decoders, dev
        on_card = dev.type == "cuda"
        self.bufs = [torch.empty((k, s, h, w, 3), dtype=torch.uint8,
                                 pin_memory=on_card) for _ in range(2)]
        self.uploaded = [None, None]  # event after each buffer's upload
        self.next = 0

    def assemble(self):
        """Fill the next buffer; -> (seconds spent waiting for frames,
        seconds spent popping them: the ring's BGR->RGB gather)."""
        b = self.next
        if self.uploaded[b] is not None:
            self.uploaded[b].synchronize()
        waited = popping = 0.0
        for chunk_j in self.bufs[b].numpy():
            t0 = time.perf_counter()
            while not self.pool.wait_ready(every=True):
                self.decoders.check()
            t1 = time.perf_counter()
            self.pool.pop_batch(out=chunk_j)
            waited += t1 - t0
            popping += time.perf_counter() - t1
        return waited, popping

    def upload(self) -> torch.Tensor:
        """The buffer ``assemble`` filled last, on the device; the next
        ``assemble`` takes the other buffer."""
        b, self.next = self.next, 1 - self.next
        if self.dev.type != "cuda":
            return self.bufs[b].clone()
        frames = self.bufs[b].to(self.dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.dev))
        self.uploaded[b] = done
        return frames


def h2d_secs(buf: torch.Tensor, dev) -> float:
    """Seconds of one upload of ``buf`` (pinned on the card's path), after
    a first one."""
    def once():
        out = buf.to(dev, non_blocking=True) if dev.type == "cuda" \
            else buf.clone()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    once()
    t0 = time.perf_counter()
    once()
    return time.perf_counter() - t0


def ingest(step, states, stage: ChunkStage, chunks: int, hw,
           tap=None) -> dict:
    """The ingest loop on a built ``BucketedScannedStep`` over a started
    ``ChunkStage``: a warm-up chunk stepped twice, then ``chunks`` chunks
    with chunk i + 1 assembled, uploaded and its detect stage enqueued
    before chunk i's track stage. ``tap(frames)`` sees every uploaded chunk
    in order, the warm-up's first. -> ``secs``, ``waited`` and ``popping``
    (the timed chunks', as ``ChunkStage.assemble``), ``failures``, ``buckets_seen`` {(bucket, window): chunks},
    ``stats_readbacks`` and ``launches`` (the timed chunks'), the final
    ``states`` and the last chunk's ``outputs`` and ``emit``, and
    ``base_next_id``, the largest next id after the warm-up."""
    def uploaded():
        frames = stage.upload()
        if tap is not None:
            tap(frames)
        return frames

    stage.assemble()
    frames = uploaded()
    for _ in range(2):
        states, (outputs, emit) = step(states, frames)
    del frames
    base_next_id = states.next_id.max().item()

    failures, buckets_seen = [], {}
    zero_launches()
    readbacks = step.host_readbacks
    t0 = time.perf_counter()
    # the first chunk's wait is left out of ``waited``, as the reference does
    waited, popping = 0.0, stage.assemble()[1]
    nxt = step.detect(uploaded())
    for i in range(chunks):
        cur = nxt
        if i + 1 < chunks:  # the next chunk's detect runs under this track
            w, p = stage.assemble()
            waited, popping = waited + w, popping + p
            nxt = step.detect(uploaded())
        states, (outputs, emit) = step.track(states, cur)
        key = (step.last_bucket, step.last_window)
        buckets_seen[key] = buckets_seen.get(key, 0) + 1
    rows = emitted_rows(outputs, emit)
    secs = time.perf_counter() - t0
    launches = read_launches()
    if far_outside(rows, hw):
        failures.append("final chunk: emitted boxes far outside the frame")
    if not torch.isfinite(states.mean).all().item():
        failures.append("non-finite tracker state")
    return {"secs": secs, "waited": waited, "popping": popping,
            "failures": failures, "buckets_seen": buckets_seen,
            "stats_readbacks": step.host_readbacks - readbacks,
            "launches": launches, "states": states, "outputs": outputs,
            "emit": emit, "base_next_id": base_next_id}


def soak_ingest(args, dev, tap=None) -> dict:
    """The end-to-end ingest soak (``--ingest``): clips, the decode-only
    ceiling, the honest load recalibrated on the clips, the step, the
    host-to-device ceiling, then the decoders, the rings and ``ingest``
    (``tap`` as there). -> the record."""
    from ..config import DetectorConfig, TrackerConfig
    from ..models.reid import random_reid_params
    from ..parallel.streams import BucketedScannedStep, init_stream_states
    from ..runtime.native import FramePool
    from ..weights import reid_from_params
    from .honest_load import bn_weights_and_frames, calibrate_conf

    k, s, hw = args.scan, args.streams, (args.frame_h, args.frame_w)
    clips = ensure_clips(args.clip_dir, s, hw, args.clip_frames)
    decode_fps = decode_only_fps(clips, args.decode_probe_secs)

    # one frame a stream is enough: the BN capture and the calibration read
    # the first frame of the chunk only, and the decoders give the frames
    load = bn_weights_and_frames(args.model, args.img_size, 1, s, hw,
                                 args.target_dets, device=dev)
    # thresholds recalibrated on what the decoders give: noise frames put
    # the objectness distribution elsewhere than decoded content does
    first = torch.from_numpy(first_frames_rgb(clips)).to(dev)
    conf_vec = calibrate_conf(load.detector_bf16, first, args.img_size,
                              args.target_dets)
    del first
    reid = reid_from_params(random_reid_params(0)).to(
        dev, torch.bfloat16, memory_format=torch.channels_last)
    trk_cfg = TrackerConfig(max_dets=64)
    det_cfg = DetectorConfig(img_size=args.img_size,
                             conf_thres=float(conf_vec.mean()))
    # two rungs of crop windows cover MOT-person crops at 1080p
    step = BucketedScannedStep(
        load.detector_bf16, reid, det_cfg, trk_cfg, hw,
        buckets=(16, 24, 32, 36, 40, 48), conf_thres_per_stream=conf_vec,
        windows=((240, 128), (320, 192)))

    pool = FramePool(s, *hw, depth=max(2 * k, 8))
    decoders = Decoders(clips, pool)
    stage = ChunkStage(pool, decoders, k, dev)
    secs = h2d_secs(stage.bufs[0], dev)  # the loop's own kind of upload
    h2d_gbps = stage.bufs[0].numel() / secs / 1e9
    transfer_ceiling_fps = k * s / secs
    decoders.start()
    try:
        res = ingest(step, init_stream_states(trk_cfg, s, dev), stage,
                     args.chunks, hw, tap)
        pushed_fps = sum(decoders.pushed) / res["secs"]
    finally:
        decoders.close()
        pool.close()

    frames_total = args.chunks * k * s
    fps = frames_total / res["secs"]
    return {
        "metric": "ingest soak fps/chip (incl. host decode + transfer)",
        "value": round(fps, 2),
        "unit": "frames/sec/chip",
        "decode_only_fps": round(decode_fps, 1),
        "chunks": args.chunks,
        "frames": frames_total,
        "minutes": round(res["secs"] / 60, 2),
        "starved_frac": round(res["waited"] / res["secs"], 3),
        "decode_pushed_fps": round(pushed_fps, 1),
        "variants_seen": {f"{b}@{w}": n
                          for (b, w), n in res["buckets_seen"].items()},
        "capacity_bucket": step.last_bucket,
        "dets_bucket_max": step.last_max_count,
        "h2d_gbps": round(h2d_gbps, 2),
        "transfer_ceiling_fps": round(transfer_ceiling_fps, 1),
        "bound": bound_label(fps, decode_fps, pushed_fps,
                             transfer_ceiling_fps),
        "failures": res["failures"],
        "ok": not res["failures"],
        "route": dev.type,
        "device": device_name(dev),
        "stats_readbacks": res["stats_readbacks"],
        "launches": res["launches"],
        "popping_frac": round(res["popping"] / res["secs"], 3),
    }


def parser() -> argparse.ArgumentParser:
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
    p.add_argument("--ingest", action="store_true",
                   help="end-to-end mode: decode real video through the "
                        "native rings instead of device-resident frames")
    p.add_argument("--clip-dir", default=os.path.join(
        tempfile.gettempdir(), "ydt_soak_clips"))
    p.add_argument("--clip-frames", type=int, default=300)
    p.add_argument("--decode-probe-secs", type=float, default=6.0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def run(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.ingest:
        return soak_ingest(args, dev)

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
