"""Tracing / profiling / observability (port of
yolo_deepsort_tpu/utils/profiling.py).

  * ``StageTimer``: named host-side stage timers with EMA + totals (a copy:
    host clock, as in the reference; on the card a stage that ends without
    a synchronize is timed as enqueued),
  * ``FpsMeter``: EMA frames per second (a copy),
  * ``PipelineStats``: structured counters (frames, detections,
    active/confirmed tracks, emitted tracks, id high-water mark) read from
    the port's ``TrackerState``, whose fields carry a leading stream axis,
  * ``device_trace``: context manager around ``torch.profiler`` that
    writes a Chrome trace when a profile dir is given (no-op otherwise),
  * ``span``: the serving steps' stage ranges (``ydt.*``), and the
    detector's module ranges (``ydt.det.*``), live only while a torch
    profiler records (``device_trace``, or any other).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class StageTimer:
    """Named wall-clock stage timers: ``with timer("detect"): ...``."""

    def __init__(self, ema: float = 0.9):
        self._ema_w = ema
        self.ema: Dict[str, float] = {}
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1
            prev = self.ema.get(name, dt)
            self.ema[name] = self._ema_w * prev + (1 - self._ema_w) * dt

    def summary(self) -> str:
        rows = []
        for name in self.total:
            n = self.count[name]
            rows.append(
                f"{name}: {self.total[name] / max(n, 1) * 1000:.2f} ms avg "
                f"({self.ema.get(name, 0) * 1000:.2f} ms ema, n={n})"
            )
        return " | ".join(rows)


class FpsMeter:
    """EMA frames-per-second (the reference's FPS overlay source)."""

    def __init__(self, ema: float = 0.9):
        self._ema_w = ema
        self._last: Optional[float] = None
        self.fps = 0.0

    def tick(self, frames: int = 1) -> float:
        now = time.perf_counter()
        if self._last is not None:
            inst = frames / max(now - self._last, 1e-9)
            self.fps = (
                inst if self.fps == 0.0
                else self._ema_w * self.fps + (1 - self._ema_w) * inst
            )
        self._last = now
        return self.fps


@dataclasses.dataclass
class PipelineStats:
    """Structured per-pipeline counters, updated from tracker outputs.

    ``update`` takes one step of S streams: ``det_mask`` (S, D) or (D,),
    the port's ``TrackerState`` (``state`` (S, T), ``next_id`` (S,); a
    single stream's (T,) and scalar are read as S = 1) and ``emit_mask``,
    as tensors on any device or numpy arrays. A step counts S frames;
    detections, emitted, active and confirmed tracks are summed over the
    streams; ``lane_saturated_frames`` counts the streams whose every track
    lane was occupied; ``max_track_id`` is the largest id any stream has
    given (ids are per stream). At S = 1 this is the reference's counting
    exactly."""

    frames: int = 0
    detections: int = 0
    emitted_tracks: int = 0
    max_track_id: int = 0
    active_tracks: int = 0
    confirmed_tracks: int = 0
    # no-silent-caps telemetry: frames where every track lane was occupied
    # (a new detection on such a frame could not have started a track) and
    # NMS-capacity drops fed in from BucketedScannedStep.saturation()
    lane_saturated_frames: int = 0
    sat_nms_topk: int = 0
    sat_nms_dets: int = 0

    def update(self, det_mask, tracker_state, emit_mask) -> None:
        st = _host(tracker_state.state)
        st = st.reshape(-1, st.shape[-1])  # (S, T)
        next_id = _host(tracker_state.next_id).reshape(-1)  # (S,)
        self.frames += st.shape[0]
        self.detections += int(_host(det_mask).sum())
        self.emitted_tracks += int(_host(emit_mask).sum())
        self.active_tracks = int((st > 0).sum())
        self.confirmed_tracks = int((st == 2).sum())
        self.lane_saturated_frames += int((st > 0).all(-1).sum())
        self.max_track_id = max(self.max_track_id, int(next_id.max()) - 1)

    def absorb_saturation(self, sat: Dict[str, int]) -> None:
        """Fold BucketedScannedStep.saturation() counters in (cumulative
        totals there; store the latest totals here)."""
        self.sat_nms_topk = int(sat.get("sat_nms_topk", 0))
        self.sat_nms_dets = int(sat.get("sat_nms_dets", 0))

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


_NO_SPAN = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch profiler records now: the check ``span`` makes."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    torch profiler records, so the range lies in the same trace, on the
    same clock, as the card's kernels it launches; otherwise one shared null
    context (one check, nothing constructed). The serving steps' names
    start with ``ydt.``."""
    if recording():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def device_trace(profile_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` around the block (host ops, and the card's kernels
    when CUDA is available), written on exit as a Chrome trace
    ``trace_<date>_<time>_<pid>.json`` in ``profile_dir``; inert when
    profile_dir is None."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    name = f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(profile_dir, name))
