"""The system under test: ``yolo_deepsort_tpu_torch``'s serving steps,
built from the run's inputs through the program's public loaders, and the
timed loops that drive them.

* Chunk mixes: ``parallel/streams.py`` ``BucketedScannedStep`` pipelined
  one chunk deep (the detect stage of chunk i + 1 is enqueued before the
  track stage of chunk i, as the program's soak runs it); each chunk's
  emitted tracks are copied to pinned host memory behind its track stage
  and read one chunk later. A frame counts once its tracks are on the
  host.
* K=1 mixes: ``make_batched_step`` in a closed loop, one caller, one frame
  of every stream a step; each step's rows and emit mask are read back
  before the next step starts.

A sampled chunk or step keeps copies of the tracker state before and after
it (made on the device, in stream order, between two calls), what its
detector decoded and what its tracker was handed (``observe``), and its
emitted rows, for ``compare.py``."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from . import trace

# TrackerState field -> the name compare.py / reference/tracker.py read
STATE_FIELDS = {"mean": "mean", "cov": "cov", "track_id": "track_id",
                "state": "state", "hits": "hits", "age": "age",
                "time_since_update": "tsu", "gallery": "gallery",
                "gallery_head": "head", "gallery_count": "count",
                "next_id": "next_id"}


@contextlib.contextmanager
def observe(smp: Dict, streams_n: int):
    """While active, the serving steps' NMS entry (``batched_nms_with_stats``
    / ``batched_nms`` of ``parallel.streams``) and tracker entry
    (``tracker_step_fused_batched``) record their inputs into ``smp``: the
    detector's decoded rows of every stream in the frames at the positions
    ``smp["record"]`` lists (default: the first), with their thresholds,
    and for every frame the detections (tlwh, confidence, mask) and ReID
    features the tracker was handed. Installed only around sampled chunks
    and steps; the copies are made on the device, in stream order."""
    from yolo_deepsort_tpu_torch.parallel import streams

    saved = {n: getattr(streams, n) for n in (
        "batched_nms_with_stats", "batched_nms",
        "tracker_step_fused_batched")}

    def nms_entry(name):
        def observed(decoded, conf, *args):
            smp["decoded"] = {f: decoded[f * streams_n:(f + 1) * streams_n]
                              .clone() for f in smp.get("record", [0])}
            thr = torch.as_tensor(conf, dtype=torch.float32)
            smp["nms_conf"] = (thr.expand(streams_n) if thr.dim() == 0
                               else thr[:streams_n]).clone()
            return saved[name](decoded, conf, *args)
        return observed

    def tracker_entry(cfg, state, det_tlwh, det_conf, det_feat, det_mask,
                      img_hw):
        smp["inputs"].append((det_tlwh, det_conf, det_feat, det_mask))
        return saved["tracker_step_fused_batched"](
            cfg, state, det_tlwh, det_conf, det_feat, det_mask, img_hw)

    smp.setdefault("inputs", [])
    streams.batched_nms_with_stats = nms_entry("batched_nms_with_stats")
    streams.batched_nms = nms_entry("batched_nms")
    streams.tracker_step_fused_batched = tracker_entry
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(streams, name, fn)


def _observed(smp: Optional[Dict], streams_n: int):
    return observe(smp, streams_n) if smp is not None else (
        contextlib.nullcontext())


def clone_state(st):
    return dataclasses.replace(st, **{f.name: getattr(st, f.name).clone()
                                      for f in dataclasses.fields(st)})


def state_arrays(st) -> Dict[str, np.ndarray]:
    return {v: getattr(st, k).cpu().numpy() for k, v in STATE_FIELDS.items()}


def build(cfg: Dict, traffic: Dict, cfg_path: str, raw: Dict, reid_sd: Dict,
          device, route: str = "stated", frames_s=None):
    """-> make_step(thresholds) -> (step, fresh tracker states), the
    detector and the ReID net, in the configuration's dtype, built through
    the program's public loaders, and the steps' conv route of the
    detector (``conv_impl``, resolved by the steps' own resolver from the
    same arguments; None: the model's own convs). ``route="int8"``
    switches on the program's own int8 paths (W8A8 backbone convs through
    kernel 7's int8 mode, calibrated on the frames, and the int8-resident
    ReID embed through kernel 8): the lower-precision control;
    ``route="stated"`` runs the configuration as stated."""
    from yolo_deepsort_tpu_torch.cfg.parse import parse_model_config
    from yolo_deepsort_tpu_torch.config import DetectorConfig, TrackerConfig
    from yolo_deepsort_tpu_torch.models.darknet import build_network
    from yolo_deepsort_tpu_torch.models.reid import params_from_state_dict
    from yolo_deepsort_tpu_torch.parallel.streams import (
        BucketedScannedStep, _make_conv_impl, init_stream_states,
        make_batched_step)
    from yolo_deepsort_tpu_torch.weights import (darknet_from_raw,
                                                 reid_from_params)

    det, trk = cfg["detect"], cfg["tracker"]
    plan = build_network(parse_model_config(cfg_path), cfg["img_size"])
    raw_np = {i: {k: v.cpu().numpy() for k, v in layer.items()}
              for i, layer in raw.items()}
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg["dtype"]]
    detector = darknet_from_raw(plan, raw_np).to(
        device, dtype, memory_format=torch.channels_last)
    params = params_from_state_dict({k: v.cpu().numpy()
                                     for k, v in reid_sd.items()})
    reid = reid_from_params(params).to(device, dtype,
                                       memory_format=torch.channels_last)
    trk_cfg = TrackerConfig(**trk)
    kw = {}
    if route == "int8":
        from yolo_deepsort_tpu_torch.models.quantize import (
            quantize_reid_params_resident)
        from yolo_deepsort_tpu_torch.models.quantize_darknet import (
            quantize_darknet_from_frames)
        from yolo_deepsort_tpu_torch.weights import (
            reid_int8_package_to_torch)

        f32 = darknet_from_raw(plan, raw_np).to(device)
        calib = torch.randn((64, 128, 64, 3), generator=torch.Generator(
            device="cpu").manual_seed(0)).numpy()
        kw = dict(use_pallas_conv=True, embed_int8="resident_pallas",
                  backbone_int8_pkg=quantize_darknet_from_frames(
                      f32, frames_s, cfg["img_size"]))
        reid = reid_int8_package_to_torch(
            quantize_reid_params_resident(params, calib, device), device)
        del f32
    elif route != "stated":
        raise ValueError(f"unknown route {route!r}")
    hw = tuple(traffic["frame_hw"])

    def make_step(thresholds):
        states = init_stream_states(trk_cfg, traffic["streams"], device)
        if traffic["kind"] == "k1":
            det_cfg = DetectorConfig(
                img_size=cfg["img_size"], conf_thres=thresholds[0],
                nms_thres=det["nms_thres"], max_boxes=det["max_boxes"],
                max_dets=trk["max_dets"], half=dtype == torch.bfloat16)
            return make_batched_step(
                detector, reid, det_cfg, trk_cfg, hw, cap=traffic["cap"],
                crop_window=tuple(traffic["crop_window"]), **kw), states
        det_cfg = DetectorConfig(
            img_size=cfg["img_size"], nms_thres=det["nms_thres"],
            max_boxes=det["max_boxes"], max_dets=trk["max_dets"],
            half=dtype == torch.bfloat16)
        return BucketedScannedStep(
            detector, reid, det_cfg, trk_cfg, hw,
            buckets=tuple(cfg["buckets"]), conf_thres_per_stream=thresholds,
            windows=tuple(tuple(w) for w in cfg["windows"]), **kw), states

    conv_impl = _make_conv_impl(kw.get("use_pallas_conv", False),
                                kw.get("backbone_int8_pkg"))
    return make_step, detector, reid, conv_impl


@torch.no_grad()
def capture(detector, conv_impl, frames: torch.Tensor, img_size: int):
    """The program's detector run once more, eagerly, on frames (N, H, W, 3)
    uint8 as the serving steps run it -- their letterbox, then the forward
    with their conv route -- with every module's output captured: -> (the
    letterboxed input (N, S, S, 3), the decoded rows (N, B, 5 + C), every
    module's output as ``Darknet.forward(capture_all_layers=True)`` gives
    them)."""
    from yolo_deepsort_tpu_torch.ops.letterbox_kernel import (
        letterbox_batch_fused)

    dtype = next(detector.parameters()).dtype
    xs = letterbox_batch_fused(frames, img_size, out_dtype=dtype)
    decoded, layers = detector(xs, capture_all_layers=True,
                               conv_impl=conv_impl)
    return xs, decoded, layers


class HostRows:
    """Pinned host buffers for a step's (rows, emit) and the event after
    their copy; on the CPU a plain copy."""

    def __init__(self, rows: torch.Tensor, emit: torch.Tensor):
        pin = rows.is_cuda
        self.rows = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=pin)
        self.emit = torch.empty(emit.shape, dtype=emit.dtype, pin_memory=pin)
        self.event = torch.cuda.Event() if pin else None

    def start(self, rows, emit) -> None:
        if self.event is not None:
            self.event.synchronize()  # the previous copy into this buffer
        self.rows.copy_(rows, non_blocking=True)
        self.emit.copy_(emit, non_blocking=True)
        if self.event is not None:
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return self.rows.numpy().copy(), self.emit.numpy().copy()


@dataclasses.dataclass
class Window:
    """What a timed loop leaves: units (chunks or steps) and frames
    completed, its seconds, per-unit host detail, the samples, and the
    tracker states it ends with."""

    units: int = 0
    frames: int = 0
    secs: float = 0.0
    latency_s: List[float] = dataclasses.field(default_factory=list)
    enqueue_s: List[float] = dataclasses.field(default_factory=list)
    buckets: List[int] = dataclasses.field(default_factory=list)
    counts: List[int] = dataclasses.field(default_factory=list)
    windows: List[tuple] = dataclasses.field(default_factory=list)
    samples: List[Dict] = dataclasses.field(default_factory=list)
    states: object = None


def _due(sample_at: List[float], elapsed: float) -> bool:
    if sample_at and elapsed >= sample_at[0]:
        sample_at.pop(0)
        return True
    return False


def _sample(frame_ids: List[int], pick) -> Dict:
    """A new sample of a unit whose frames are the variants ``frame_ids``:
    decoded rows are kept of its first frame and of one more drawn by
    ``pick`` (a numpy generator)."""
    record = [0]
    if len(frame_ids) > 1:
        record.append(int(pick.integers(1, len(frame_ids))))
    return {"frame_ids": list(frame_ids), "record": record}


def chunk_window(step, states, frames, seconds: float,
                 sample_at: Optional[List[float]] = None, spans=False,
                 max_units: Optional[int] = None, frame_ids=None,
                 pick=None) -> Window:
    """Run chunks of ``frames`` (K, S, H, W, 3), the variants
    ``frame_ids``, pipelined one deep until ``seconds`` have passed (or
    ``max_units`` chunks), then drain. ``sample_at``: seconds into the
    window at which the next chunk to be detected is sampled."""
    sample_at = sorted(sample_at or [])
    k, s = frames.shape[0], frames.shape[1]
    w = Window()
    ring: List[HostRows] = []
    pending: deque = deque()
    t0 = time.perf_counter()

    def collect(i, buf, smp):
        rows, emit = buf.wait()
        w.frames += k * s
        if smp is not None:
            smp.update(outputs=rows, emit=emit)

    def detect(elapsed):
        smp = _sample(frame_ids, pick) if _due(sample_at, elapsed) else None
        with trace.span("detect", spans), _observed(smp, s):
            return step.detect(frames), smp

    nxt = detect(0.0)
    i = 0
    while True:
        cur, smp = nxt
        elapsed = time.perf_counter() - t0
        last = elapsed >= seconds or (max_units and i + 1 >= max_units)
        if not last:
            nxt = detect(elapsed)
        with trace.span("readback", spans):
            if cur[4][1] is not None:
                cur[4][1].synchronize()
        if smp is not None:
            smp["pre"] = clone_state(states)
        with trace.span("track", spans), _observed(smp, s):
            states, (rows, emit) = step.track(states, cur)
        if smp is not None:
            smp["post"] = clone_state(states)
        w.buckets.append(step.last_bucket)
        w.counts.append(step.last_max_count)
        w.windows.append(step.last_window)
        with trace.span("read_out", spans):
            if len(ring) < 3:  # three buffers in turn: one read a chunk late
                ring.append(HostRows(rows, emit))
            buf = ring[i % 3]
            buf.start(rows, emit)
            pending.append((i, buf, smp))
            while len(pending) > 1:
                collect(*pending.popleft())
        if smp is not None:
            w.samples.append(smp)
        i += 1
        if last:
            break
    with trace.span("read_out", spans):
        while pending:
            collect(*pending.popleft())
    w.secs = time.perf_counter() - t0
    w.units, w.states = i, states
    return w


def k1_window(step, states, frames, seconds: float,
              sample_at: Optional[List[float]] = None, spans=False,
              max_units: Optional[int] = None, frame_ids=None,
              pick=None) -> Window:
    """Closed loop of K=1 steps until ``seconds`` have passed (or
    ``max_units`` steps); step i serves ``frames[i % V]`` of the variants
    (V, S, H, W, 3). Each step is timed from its call to its rows on the
    host; a sampled step's state copies are made and waited for outside
    that time."""
    sample_at = sorted(sample_at or [])
    w = Window()
    host: Optional[HostRows] = None
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds or (max_units and w.units >= max_units):
            break
        v = w.units % frames.shape[0]
        frames_s = frames[v]
        smp = None
        if _due(sample_at, elapsed):
            smp = dict(_sample([v], pick), pre=clone_state(states))
            _sync(frames_s)
        t_call = time.perf_counter()
        with trace.span("k1_step", spans), _observed(smp, frames_s.shape[0]):
            states, (rows, emit) = step(states, frames_s)
        t_ret = time.perf_counter()
        with trace.span("read_out", spans):
            if host is None:
                host = HostRows(rows, emit)
            host.start(rows, emit)
            out = host.wait()
        t_done = time.perf_counter()
        w.latency_s.append(t_done - t_call)
        w.enqueue_s.append(t_ret - t_call)
        w.units += 1
        w.frames += frames_s.shape[0]
        if smp is not None:
            smp["post"] = clone_state(states)
            smp["outputs"], smp["emit"] = out[0][None], out[1][None]
            _sync(frames_s)
            w.samples.append(smp)
    w.secs = time.perf_counter() - t0
    w.states = states
    return w


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
