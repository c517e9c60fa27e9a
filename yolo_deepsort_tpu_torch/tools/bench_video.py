"""Single-video end-to-end throughput (port of ``tools/bench_video.py``):
the README's first example, measured.

Drives the public ``api.VideoTracker.track(chunk=K)`` generator over a real
encoded clip -- host decode (``runtime/video.py`` ``VideoSource``, cv2), the
chunked device step (``BucketedScannedStep``, pipelined one chunk deep:
kernel 1, kernel 7 for every conv, the windowed crops of kernel 2, K
launches of kernel 3), host drawing -- on the honest load of
``tools/honest_load.py`` (BN-consistent weights, the MOT box prior), with
the objectness threshold calibrated on the clip's first frame. The weights
reach the ``Darknet`` facade as a user's would: written as a ``.weights``
file and read by ``load_darknet_weights``.

The clip is the first of ``tools/soak.py`` ``ensure_clips`` (max(frames,
120) frames, cached in ``--clip-dir``). Two warm passes of ``frames``
frames, the host-to-device ceiling of one chunk (uploaded as the facade
uploads it), the timed pass with per-chunk times, then the per-frame mode
(``track_frame``: kernel 1, kernel 7, kernel 5; median after 8 frames).
``--no-draw`` is parsed and changes nothing, as in the reference.

    python3 -m yolo_deepsort_tpu_torch.tools.bench_video [--chunk 16]
        [--frames 256] [--device cuda|cpu]

Prints one JSON line: the reference's keys, plus ``route``, ``device``,
``conf_thres``, ``dets`` (the timed pass's emitted rows), ``chunks_run``
(the chunks it enqueued: one more than it drew, as the generator runs one
chunk deep) and ``launches`` (every port kernel's launches in it).
``--device`` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from ..device import device_name, resolve_device
from ..kernels.launches import read_launches, zero_launches


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="yolov3")
    p.add_argument("--img-size", type=int, default=416)
    p.add_argument("--frame-h", type=int, default=1080)
    p.add_argument("--frame-w", type=int, default=1920)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--frames", type=int, default=256,
                   help="frames measured per pass (clip loops)")
    p.add_argument("--target-dets", type=int, default=32)
    p.add_argument("--clip-dir", default=os.path.join(
        tempfile.gettempdir(), "ydt_soak_clips"))
    p.add_argument("--no-draw", action="store_true",
                   help="parsed and unused, as in the reference")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def honest_video_model(args, dev, weights_path: str):
    """The clip, and the ``Darknet`` facade on ``dev`` holding the honest
    load (written to ``weights_path`` and loaded from there), with the
    threshold calibrated on the clip's first frame. -> (model, conf_thres,
    clip path)."""
    from ..api import Darknet
    from ..weights import save_darknet_weights
    from .honest_load import bn_weights_and_frames, calibrate_conf
    from .soak import ensure_clips, first_frames_rgb

    hw = (args.frame_h, args.frame_w)
    clip = ensure_clips(args.clip_dir, 1, hw, max(args.frames, 120))[0]
    load = bn_weights_and_frames(args.model, args.img_size, 1, 1, hw,
                                 args.target_dets, device=dev)
    # noise-calibrated thresholds misplace decoded content's objectness
    first = torch.from_numpy(first_frames_rgb([clip])).to(dev)
    conf_vec = calibrate_conf(load.detector_bf16, first, args.img_size,
                              args.target_dets)
    model = Darknet(args.model, img_size=args.img_size, device=dev)
    save_darknet_weights(weights_path, model.header, load.raw,
                         model.plan.defs())
    model.load_darknet_weights(weights_path)
    return model, float(conf_vec.mean()), clip


def run_pass(vt, clip: str, chunk: int, frames: int):
    """One generator pass of ``frames`` frames. -> (frames, emitted rows,
    wall seconds, per-chunk seconds)."""
    n = dets = 0
    chunk_times = []
    gen = vt.track(clip, chunk=chunk)
    t0 = time.perf_counter()
    t_chunk = t0
    for _, outputs in gen:
        n += 1
        dets += len(outputs)
        if n % chunk == 0:
            now = time.perf_counter()
            chunk_times.append(now - t_chunk)
            t_chunk = now
        if n >= frames:
            gen.close()
            break
    return n, dets, time.perf_counter() - t0, chunk_times


def h2d_secs(chunk: int, hw, dev) -> float:
    """Seconds of one (chunk, H, W, 3) uint8 upload as the facade makes it
    (``api._upload``: pinned, then copied without a wait), after a first
    one."""
    import numpy as np

    from ..api import _upload

    probe = np.zeros((chunk, *hw, 3), np.uint8)

    def once():
        out = _upload(probe, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    once()
    t0 = time.perf_counter()
    once()
    return time.perf_counter() - t0


def bench(args, dev, model, conf_thres: float, clip: str) -> dict:
    from ..api import VideoTracker

    vt = VideoTracker(model, tracked_classes=None, conf_thres=conf_thres,
                      half=True)
    # two warm passes: the state differs across passes, so pass 2 can take
    # (bucket, window) variants pass 1 never built
    for _ in range(2):
        run_pass(vt, clip, args.chunk, args.frames)

    secs = h2d_secs(args.chunk, (args.frame_h, args.frame_w), dev)
    h2d_gbps = args.chunk * args.frame_h * args.frame_w * 3 / secs / 1e9
    transfer_ceiling = args.chunk / secs

    zero_launches()
    chunks_before = vt.chunks_run
    n, dets, dt, chunk_times = run_pass(vt, clip, args.chunk, args.frames)
    launches = read_launches()
    chunks_run = vt.chunks_run - chunks_before

    # per-frame mode: warm, then the median after 8 frames
    vt.reset()
    gen = vt.track(clip)
    frame_times = []
    t_prev = time.perf_counter()
    for i, _ in enumerate(gen):
        now = time.perf_counter()
        frame_times.append(now - t_prev)
        t_prev = now
        if i + 1 >= min(64, args.frames):
            gen.close()
            break
    warm = sorted(frame_times[8:])
    frame_p50 = warm[len(warm) // 2] if warm else 0.0

    ct = sorted(chunk_times)
    med = ct[len(ct) // 2] if ct else float("inf")
    return {
        "metric": "single-video end-to-end fps (decode+device+draw)",
        "value": round(n / dt, 2),
        "unit": "frames/sec",
        "steady_fps": round(args.chunk / med, 2),
        "chunk_p50_ms": round(med * 1000, 1),
        "slow_chunks": sum(1 for t in chunk_times if t > 2 * med),
        "chunk": args.chunk,
        "frames": n,
        "tracks_per_frame": round(dets / max(n, 1), 1),
        "per_frame_mode_steady_fps": round(1.0 / max(frame_p50, 1e-9), 2),
        "h2d_gbps": round(h2d_gbps, 3),
        "transfer_ceiling_fps": round(transfer_ceiling, 1),
        # first-order transfer bound: the ceiling within a small multiple
        # of the achieved chunk rate
        "transfer_bound": transfer_ceiling < (args.chunk / med) * 4.0,
        "clip": clip,
        "route": dev.type,
        "device": device_name(dev),
        "conf_thres": conf_thres,
        "dets": dets,
        "chunks_run": chunks_run,
        "launches": launches,
    }


def run(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        model, conf_thres, clip = honest_video_model(
            args, dev, os.path.join(tmp, f"{args.model}.weights"))
    return bench(args, dev, model, conf_thres, clip)


def main(argv=None) -> int:
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
