"""Public facades (port of yolo_deepsort_tpu/api.py): ``Darknet``,
``ImageDetector``, ``VideoDetector``, ``Extractor``, ``DeepSort`` and
``VideoTracker``, with the reference's call contracts --
``DeepSort.update(bbox_xywh, confidences, ori_img) -> [x1, y1, x2, y2,
track_id]`` rows, ``VideoTracker.track_frame`` / ``track_frames`` /
``track``.

``Darknet``, ``Extractor`` and ``DeepSort`` take ``device=``. With none
given they run on the CUDA card (``device.py``); the CPU is taken only when
the caller asks (``device="cpu"``, or the reference's ``use_cuda=False``),
and a CUDA device that does not exist raises -- nothing falls back to the
CPU. ``ImageDetector``, ``VideoDetector`` and
``VideoTracker`` run on their model's device. On the card the per-frame
steps launch the port's kernels: the letterbox (K1) and the two-stage JV
match (K5) in ``track_frame``, K5 in ``DeepSort.update``, and the
letterbox, the windowed crops (K2) and the fused tracker step (K3) in the
chunked ``track_frames``.

One wait per call: ``DeepSort.update`` and ``VideoTracker.track_frame``
upload their inputs through pinned memory, enqueue the whole step, and read
the emitted rows back once (a pinned copy and an event wait), counted in
``host_readbacks``. In between nothing synchronizes: no ``.item()``, no
``nonzero``, no boolean-mask indexing on the device.

Nothing here imports ``cv2`` or PIL at module level: the video IO and the
drawing helpers import them inside the functions that need them, and the
``Extractor`` resizes crops on the device.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import os
import time
from collections import OrderedDict
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import weights as W
from .cfg import COCO_NAMES, parse_model_config
from .cfg.architectures import ARCHITECTURES
from .config import DetectorConfig, TrackerConfig
from .device import resolve_device
from .models.darknet import Darknet as DarknetModule
from .models.darknet import NetworkPlan, build_network
from .models.reid import feat_dim_of, load_reid_checkpoint, random_reid_params
from .ops import boxes as B
from .ops.crops import (
    CROP_H,
    CROP_W,
    REID_MEAN,
    REID_STD,
    crop_and_normalize,
    device_constant,
)
from .ops.letterbox import letterbox_nearest_batch, rescale_boxes
from .ops.letterbox_kernel import letterbox_batch_fused
from .ops.nms import batched_nms, roi_nms_mask
from .parallel.streams import (
    BucketedScannedStep,
    _frame_boxes,
    class_filter,
    make_scanned_step_bucketed,
)
from .tracking.tracker import TrackerState, init_tracker_state, tracker_step
from .utils.checkpoint import load_pytree, save_pytree

MAX_GEOMETRIES = 8  # chunked steps kept per VideoTracker, one per (h, w)


def _memory_format(device: torch.device):
    # channels_last on the card, where the letterbox kernel's NHWC output
    # feeds it without a copy; the CPU keeps the layout its tests hold
    return (torch.channels_last if device.type == "cuda"
            else torch.contiguous_format)


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To the card through pinned memory and
    without waiting: a copy from pageable memory synchronizes the stream."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _readback(t: torch.Tensor) -> np.ndarray:
    """The one wait of a facade call: a pinned copy queued behind the
    call's work, and a wait on an event recorded after it."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    done.synchronize()
    return host.numpy()


def _emitted_rows(outputs: torch.Tensor, emit: torch.Tensor) -> List:
    """(..., T, 5) outputs and (..., T) emit -> one int64 (n, 5) array of
    emitted [x1, y1, x2, y2, id] rows per leading index, in one readback."""
    packed = torch.cat([outputs, emit.to(outputs.dtype)[..., None]], -1)
    host = _readback(packed.reshape(-1, *packed.shape[-2:]))
    return [frame[frame[:, 5] > 0, :5].astype(np.int64) for frame in host]


def _reid_params(model_path: Optional[str]):
    """The checkpoint at ``model_path`` when it exists, else the reference
    package's seeded random params (its facades do the same)."""
    if model_path and os.path.exists(model_path):
        return load_reid_checkpoint(model_path)
    return random_reid_params(seed=0)


def _save_state(path: str, state: TrackerState) -> None:
    """One stream's tracker state in the reference package's file layout
    (field names, no stream axis), so either package reads the other's."""
    save_pytree(path, {f.name: getattr(state, f.name)[0]
                       for f in dataclasses.fields(TrackerState)})


def _load_state(path: str, cfg: TrackerConfig,
                device: torch.device) -> TrackerState:
    d = load_pytree(path)
    fresh = init_tracker_state(cfg, 1, device)
    fields = {}
    for f in dataclasses.fields(TrackerState):
        want = getattr(fresh, f.name)
        got = torch.from_numpy(np.asarray(d[f.name]))[None]
        if got.shape != want.shape:
            raise ValueError(f"tracker state {f.name}: {tuple(got.shape)} "
                             f"in the file, {tuple(want.shape)} expected")
        fields[f.name] = got.to(device=device, dtype=want.dtype)
    return TrackerState(**fields)


class Darknet:
    """cfg-driven detector (reference: yolo3/models.py Darknet) on one
    device. ``source`` is a .cfg path or a built-in architecture name
    ('yolov3', 'yolov3-tiny', 'yolov4'). The weights are the reference
    package's seeded ``random_raw_params`` until ``load_darknet_weights``.

    ``module`` is the float32 ``nn.Module``; ``module_for(dtype)`` is the
    copy a facade computes with in ``dtype``."""

    def __init__(self, source: str, img_size: Optional[int] = None,
                 num_classes: int = 80, device=None):
        if source in ARCHITECTURES:
            module_defs = ARCHITECTURES[source](
                num_classes=num_classes, img_size=img_size or
                (608 if source == "yolov4" else 416))
        else:
            module_defs = parse_model_config(source)
        self.plan: NetworkPlan = build_network(module_defs, img_size=img_size)
        self.img_size = self.plan.img_size
        self.num_classes = self.plan.num_classes
        self.device = resolve_device(device)
        self.header = np.array([0, 2, 0, 0, 0], np.int32)
        self.raw_params = W.random_raw_params(self.plan.defs())
        self._reload()

    def _reload(self) -> None:
        folded = W.fold_inference_params(self.raw_params, self.plan.defs())
        module = DarknetModule(self.plan)
        module.load_params(W.darknet_params_from_folded(folded))
        self.module = module.eval().to(
            self.device, memory_format=_memory_format(self.device))
        self._by_dtype = {torch.float32: self.module}

    def module_for(self, dtype: torch.dtype) -> DarknetModule:
        if dtype not in self._by_dtype:
            self._by_dtype[dtype] = copy.deepcopy(self.module).to(dtype)
        return self._by_dtype[dtype]

    def load_darknet_weights(self, weights_path: str,
                             cutoff: Optional[int] = None) -> "Darknet":
        header, raw = W.load_darknet_weights(weights_path, self.plan.defs(),
                                             cutoff=cutoff)
        self.header = header
        self.raw_params.update(raw)
        self._reload()
        return self

    def save_darknet_weights(self, path: str,
                             cutoff: Optional[int] = None) -> None:
        W.save_darknet_weights(path, self.header, self.raw_params,
                               self.plan.defs(), cutoff=cutoff)

    @torch.no_grad()
    def __call__(self, x_nhwc) -> torch.Tensor:
        """Letterboxed (N, S, S, 3) input in [0, 1] -> decoded detections
        (N, boxes, 5+C) in network-input pixels, float32."""
        return self.module(torch.as_tensor(x_nhwc).to(self.device))


class ImageDetector:
    """Single-image detection (reference: yolo3/detect/img_detect.py).

    ``detect`` returns (K, 7) float32 rows (x1, y1, x2, y2, obj_conf,
    cls_conf, cls_pred) in original image coordinates. Runs on the
    model's device; ``half`` computes in bfloat16. ``interp`` is the
    letterbox's resampling: "bilinear" is kernel 1 on the card, "nearest"
    plain torch ops (the reference's own route for it)."""

    def __init__(self, model: Darknet,
                 class_names: Optional[Sequence[str]] = None,
                 conf_thres: float = 0.5, nms_thres: float = 0.4,
                 max_dets: int = 64, interp: str = "bilinear",
                 half: bool = False, font_path: Optional[str] = None):
        if interp not in ("bilinear", "nearest"):
            raise ValueError(f"interp must be 'bilinear' or 'nearest', not "
                             f"{interp!r}")
        self.model = model
        self.interp = interp
        self.font_path = font_path
        self.class_names = (list(class_names) if class_names
                            else list(COCO_NAMES))
        self.cfg = DetectorConfig(
            img_size=model.img_size, conf_thres=conf_thres,
            nms_thres=nms_thres, max_dets=max_dets, half=half)
        self.compute_dtype = torch.bfloat16 if half else torch.float32
        self.host_readbacks = 0

    @torch.no_grad()
    def detect(self, img_rgb: np.ndarray) -> np.ndarray:
        h, w = img_rgb.shape[:2]
        cfg = self.cfg
        frame = _upload(img_rgb[None], self.model.device)
        letterbox = (letterbox_batch_fused if self.interp == "bilinear"
                     else letterbox_nearest_batch)
        x = letterbox(frame, cfg.img_size, self.compute_dtype)
        dets = self.model.module_for(self.compute_dtype)(x)
        boxes7, mask = batched_nms(dets, cfg.conf_thres, cfg.nms_thres,
                                   cfg.max_boxes, cfg.max_dets)
        orig = rescale_boxes(boxes7[0, :, :4], cfg.img_size, h, w)
        rows = torch.cat([orig, boxes7[0, :, 4:], mask[0, :, None].float()],
                         1)
        host = _readback(rows)
        self.host_readbacks += 1
        return host[host[:, 7] > 0, :7]

    def draw(self, img_rgb: np.ndarray, detections: np.ndarray) -> np.ndarray:
        return draw_detections(img_rgb, detections, self.class_names,
                               font_path=self.font_path)


class VideoDetector:
    """Video detection loop (reference: yolo3/detect/video_detect.py): a
    generator of (annotated_frame_rgb, detections) with ``skip_frames``
    (detect every Nth frame, reuse the boxes between), optional mp4 output,
    live display and an FPS overlay."""

    def __init__(self, image_detector: ImageDetector):
        self.detector = image_detector

    def detect(self, video_path: str | int, output_path: Optional[str] = None,
               real_show: bool = False, skip_frames: int = 0):
        from .runtime.video import VideoSource, VideoWriter, show_frame

        source = VideoSource(video_path)
        writer = (VideoWriter(output_path, source.fps, source.size)
                  if output_path else None)
        detections = np.zeros((0, 7), np.float32)
        t_last = time.time()
        try:
            for i, frame_bgr in enumerate(source):
                frame_rgb = np.ascontiguousarray(frame_bgr[:, :, ::-1])
                if skip_frames <= 0 or i % (skip_frames + 1) == 0:
                    detections = self.detector.detect(frame_rgb)
                annotated = draw_detections(frame_rgb, detections,
                                            self.detector.class_names)
                now = time.time()
                annotated = draw_fps(annotated, 1.0 / max(now - t_last, 1e-6))
                t_last = now
                out_bgr = np.ascontiguousarray(annotated[:, :, ::-1])
                if writer:
                    writer.write(out_bgr)
                if real_show:
                    show_frame(out_bgr)
                yield annotated, detections
        finally:
            source.release()
            if writer:
                writer.release()


class Extractor:
    """ReID feature extractor (reference:
    deep_sort/deep/feature_extractor.py): ``__call__(im_crops)`` takes a
    list of HWC uint8 RGB crops of any size and returns (N, feat_dim)
    float32 L2-normalized features.

    Each crop is resized to 64x128 on the device -- bilinear, half-pixel
    centres, no antialias, rounded to uint8 like ``cv2.INTER_LINEAR`` --
    then /255 and ImageNet-normalized. ``max_batch`` is kept for the
    reference's signature, where it caps the padding of its jit cache;
    nothing is padded here, and padding does not change the rows."""

    def __init__(self, model_path: Optional[str] = None, use_cuda: bool = True,
                 max_batch: int = 256, device=None):
        self.device = resolve_device(device, use_cuda)
        self.max_batch = max_batch
        params = _reid_params(model_path)
        self.feat_dim = feat_dim_of(params)
        self.net = W.reid_from_params(params).to(self.device)

    def _resize(self, crop: np.ndarray) -> torch.Tensor:
        x = _upload(crop, self.device).permute(2, 0, 1)[None].float()
        r = F.interpolate(x, size=(CROP_H, CROP_W), mode="bilinear",
                          align_corners=False, antialias=False)
        return torch.floor(r + 0.5).clamp(0, 255)[0].permute(1, 2, 0)

    @torch.no_grad()
    def __call__(self, im_crops: Sequence[np.ndarray]) -> np.ndarray:
        if not len(im_crops):
            return np.zeros((0, self.feat_dim), np.float32)
        batch = torch.stack([self._resize(c) for c in im_crops])
        mean = device_constant(REID_MEAN, self.device)
        std = device_constant(REID_STD, self.device)
        return self.net((batch / 255.0 - mean) / std).cpu().numpy()


class DeepSort:
    """Tracking facade (reference: deep_sort/deep_sort.py):
    ``update(bbox_xywh, confidences, ori_img)`` takes (cx, cy, w, h) pixel
    boxes and returns int64 rows [x1, y1, x2, y2, track_id].

    Per call: dense crops of the frame, the ReID embed (float32), the ROI
    NMS when ``nms_max_overlap < 1``, then ``tracker_step``, whose two-stage
    match is kernel K5 on the card."""

    def __init__(self, model_path: Optional[str] = None,
                 max_dist: float = 0.2, min_confidence: float = 0.3,
                 nms_max_overlap: float = 1.0, max_iou_distance: float = 0.7,
                 max_age: int = 70, n_init: int = 3, nn_budget: int = 100,
                 use_cuda: bool = True, max_tracks: int = 128,
                 max_dets: int = 64, device=None):
        self.device = resolve_device(device, use_cuda)
        reid_params = _reid_params(model_path)
        self.cfg = TrackerConfig(
            max_tracks=max_tracks, max_dets=max_dets,
            feat_dim=feat_dim_of(reid_params), nn_budget=nn_budget,
            max_dist=max_dist, min_confidence=min_confidence,
            nms_max_overlap=nms_max_overlap,
            max_iou_distance=max_iou_distance, max_age=max_age,
            n_init=n_init)
        self.reid = W.reid_from_params(reid_params).to(self.device)
        self.state: TrackerState = init_tracker_state(self.cfg, 1,
                                                      self.device)
        self.host_readbacks = 0

    def reset(self) -> None:
        self.state = init_tracker_state(self.cfg, 1, self.device)

    def save_state(self, path: str) -> None:
        """Checkpoint the tracker state (the reference package's layout)."""
        _save_state(path, self.state)

    def load_state(self, path: str) -> None:
        self.state = _load_state(path, self.cfg, self.device)

    @torch.no_grad()
    def update(self, bbox_xywh: np.ndarray, confidences: Sequence[float],
               ori_img: np.ndarray) -> np.ndarray:
        h, w = ori_img.shape[:2]
        d = self.cfg.max_dets
        n = min(len(confidences), d)
        bbox_xywh = np.asarray(bbox_xywh, np.float32).reshape(-1, 4)[:n]
        tlwh = np.zeros((d, 4), np.float32)
        tlwh[:n, 0] = bbox_xywh[:, 0] - bbox_xywh[:, 2] / 2
        tlwh[:n, 1] = bbox_xywh[:, 1] - bbox_xywh[:, 3] / 2
        tlwh[:n, 2:] = bbox_xywh[:, 2:]
        conf = np.zeros((d,), np.float32)
        conf[:n] = np.asarray(confidences, np.float32)[:n]
        mask = np.zeros((d,), bool)
        mask[:n] = True

        dev = self.device
        frame = _upload(ori_img, dev)
        tlwh, conf, mask = (_upload(a[None], dev) for a in (tlwh, conf, mask))
        crops = crop_and_normalize(frame, B.tlwh_to_xyxy(tlwh[0]))
        feats = self.reid(crops)
        if self.cfg.nms_max_overlap < 1.0:
            mask = mask & roi_nms_mask(tlwh[0], conf[0], mask[0],
                                       self.cfg.nms_max_overlap)[None]
        self.state, outputs, emit = tracker_step(
            self.cfg, self.state, tlwh, conf, feats[None], mask, (h, w))
        self.host_readbacks += 1
        return _emitted_rows(outputs, emit)[0]


class VideoTracker:
    """Detection + DeepSORT tracking over video (the reference's tracking
    entry point), on the model's device; ``half`` computes the detector and
    the ReID net in bfloat16.

    ``track_frame`` runs one frame: letterbox (K1) -> Darknet -> NMS ->
    class filter -> clip -> dense crops -> ReID -> ``tracker_step`` (K5).
    ``track_frames`` runs K frames of one stream through the bucketed
    serving step (``parallel/streams.py``: K1, K2, K3), with the same
    association math."""

    def __init__(self, model: Darknet, reid_model_path: Optional[str] = None,
                 class_names: Optional[Sequence[str]] = None,
                 tracked_classes: Optional[Iterable[str]] = ("person",),
                 conf_thres: float = 0.5, nms_thres: float = 0.4,
                 tracker_config: Optional[TrackerConfig] = None,
                 half: bool = False, font_path: Optional[str] = None):
        self.model = model
        self.device = model.device
        self.font_path = font_path
        self.class_names = (list(class_names) if class_names
                            else list(COCO_NAMES))
        self.det_cfg = DetectorConfig(
            img_size=model.img_size, conf_thres=conf_thres,
            nms_thres=nms_thres, half=half)
        self.compute_dtype = torch.bfloat16 if half else torch.float32
        reid_params = _reid_params(reid_model_path)
        self.trk_cfg = dataclasses.replace(
            tracker_config or TrackerConfig(),
            feat_dim=feat_dim_of(reid_params))
        self.reid = W.reid_from_params(reid_params).to(
            self.device, self.compute_dtype,
            memory_format=_memory_format(self.device))
        self.tracked_class_ids = (
            np.array([self.class_names.index(c) for c in tracked_classes],
                     np.int32) if tracked_classes else None)
        self._tracked = class_filter(self.tracked_class_ids, self.device)
        self.state: TrackerState = init_tracker_state(self.trk_cfg, 1,
                                                      self.device)
        self._chunk_steps: "OrderedDict[Tuple[int, int], BucketedScannedStep]"
        self._chunk_steps = OrderedDict()
        self.host_readbacks = 0

    def reset(self) -> None:
        self.state = init_tracker_state(self.trk_cfg, 1, self.device)

    def save_state(self, path: str) -> None:
        """Checkpoint the tracker state (resume mid-video)."""
        _save_state(path, self.state)

    def load_state(self, path: str) -> None:
        self.state = _load_state(path, self.trk_cfg, self.device)

    @torch.no_grad()
    def track_frame(self, frame_rgb: np.ndarray) -> np.ndarray:
        """One frame -> int64 rows [x1, y1, x2, y2, track_id]."""
        h, w = frame_rgb.shape[:2]
        det_cfg, trk_cfg = self.det_cfg, self.trk_cfg
        size = det_cfg.img_size
        frame = _upload(frame_rgb[None], self.device)
        x = letterbox_batch_fused(frame, size, self.compute_dtype)
        decoded = self.model.module_for(self.compute_dtype)(x)
        boxes7, mask = batched_nms(decoded, det_cfg.conf_thres,
                                   det_cfg.nms_thres, det_cfg.max_boxes,
                                   trk_cfg.max_dets)
        if self._tracked is not None:
            mask = mask & self._tracked(boxes7)
        xyxy, tlwh = _frame_boxes(boxes7, size, h, w)  # clipped to the frame
        crops = crop_and_normalize(frame[0], xyxy[0],
                                   compute_dtype=self.compute_dtype)
        feats = self.reid(crops)
        # the reference glue feeds the CLASS confidence (column 5) into the
        # tracker's min_confidence filter
        self.state, outputs, emit = tracker_step(
            trk_cfg, self.state, tlwh, boxes7[..., 5], feats[None], mask,
            (h, w))
        self.host_readbacks += 1
        return _emitted_rows(outputs, emit)[0]

    def _chunk_step(self, h: int, w: int) -> BucketedScannedStep:
        """The bucketed step of one frame geometry (a bounded LRU). Its
        capacity ladder is denser than the stream default: a single video's
        detection count sits wherever the scene puts it."""
        step = self._chunk_steps.get((h, w))
        if step is None:
            cap = self.trk_cfg.max_dets
            step = make_scanned_step_bucketed(
                self.model.module_for(self.compute_dtype), self.reid,
                self.det_cfg, self.trk_cfg, (h, w),
                buckets=tuple(b for b in (8, 16, 24, 32, 40, 48, 64)
                              if b < cap),
                tracked_class_ids=self.tracked_class_ids)
            self._chunk_steps[(h, w)] = step
            while len(self._chunk_steps) > MAX_GEOMETRIES:
                self._chunk_steps.popitem(last=False)
        self._chunk_steps.move_to_end((h, w))
        return step

    def _track_frames_async(self, frames_rgb: np.ndarray):
        """Enqueue one chunk; returns its device (outputs, emit). The state
        advances at once; the caller drains the outputs when it likes, so
        host decode and drawing of the next chunk overlap this chunk's
        track stage."""
        k, h, w = frames_rgb.shape[:3]
        frames = _upload(frames_rgb, self.device)[:, None]  # (K, 1, H, W, 3)
        self.state, (outputs, emit) = self._chunk_step(h, w)(self.state,
                                                             frames)
        return outputs, emit

    def _drain_chunk(self, outputs, emit) -> list:
        self.host_readbacks += 1
        return _emitted_rows(outputs[:, 0], emit[:, 0])

    def track_frames(self, frames_rgb: np.ndarray) -> list:
        """Chunked mode: K frames (K, H, W, 3) uint8 of ONE stream in one
        chunk; returns K int64 [x1, y1, x2, y2, track_id] arrays in order."""
        return self._drain_chunk(*self._track_frames_async(frames_rgb))

    def track(self, video_path: str | int, output_path: Optional[str] = None,
              real_show: bool = False, skip_frames: int = 0, chunk: int = 0):
        """Generator over (annotated_frame_rgb, outputs).

        ``skip_frames``: run the step every (skip_frames+1)-th frame and
        reuse the last outputs between (skipped frames do not age the
        tracker). ``chunk > 1``: buffer frames and run them ``chunk`` at a
        time through ``track_frames``, one chunk deep (chunk i is enqueued
        before chunk i-1 is drained and drawn); a shorter tail runs frame by
        frame. The two are mutually exclusive."""
        from .runtime.video import VideoSource, VideoWriter, show_frame

        if chunk > 1 and skip_frames > 0:
            raise ValueError("chunk and skip_frames are mutually exclusive")
        source = VideoSource(video_path)
        writer = (VideoWriter(output_path, source.fps, source.size)
                  if output_path else None)
        t_last = time.time()
        outputs = np.zeros((0, 5), np.int64)

        def emit(frame_rgb, outputs):
            nonlocal t_last
            annotated = draw_tracks(frame_rgb, outputs,
                                    font_path=self.font_path)
            now = time.time()
            annotated = draw_fps(annotated, 1.0 / max(now - t_last, 1e-6))
            t_last = now
            out_bgr = np.ascontiguousarray(annotated[:, :, ::-1])
            if writer:
                writer.write(out_bgr)
            if real_show:
                show_frame(out_bgr)
            return annotated

        try:
            if chunk > 1:
                buf: List[np.ndarray] = []
                pending = None  # (frames, device outputs, device emit)
                for frame_bgr in source:
                    buf.append(np.ascontiguousarray(frame_bgr[:, :, ::-1]))
                    if len(buf) == chunk:
                        handles = self._track_frames_async(np.stack(buf))
                        if pending is not None:
                            pf, po, pe = pending
                            for f, o in zip(pf, self._drain_chunk(po, pe)):
                                yield emit(f, o), o
                        pending = (buf, *handles)
                        buf = []
                if pending is not None:
                    pf, po, pe = pending
                    for f, o in zip(pf, self._drain_chunk(po, pe)):
                        yield emit(f, o), o
                for f in buf:  # tail: per frame, same math
                    o = self.track_frame(f)
                    yield emit(f, o), o
                return
            for i, frame_bgr in enumerate(source):
                frame_rgb = np.ascontiguousarray(frame_bgr[:, :, ::-1])
                if skip_frames <= 0 or i % (skip_frames + 1) == 0:
                    outputs = self.track_frame(frame_rgb)
                yield emit(frame_rgb, outputs), outputs
        finally:
            source.release()
            if writer:
                writer.release()


# ---------------------------------------------------------------- drawing

_PALETTE = np.array(
    [[230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
     [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
     [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255]],
    np.uint8,
)


def _color_for(idx: int) -> Tuple[int, int, int]:
    return tuple(int(c) for c in _PALETTE[idx % len(_PALETTE)])


@functools.lru_cache(maxsize=16)
def _truetype(font_path: str, size: int):
    from PIL import ImageFont

    return ImageFont.truetype(font_path, size)


def _draw_labels(out: np.ndarray, labels, font_path: Optional[str],
                 font_size: int = 18) -> np.ndarray:
    """Text labels: with ``font_path`` through PIL truetype (as the
    reference's img_detect.py draws), else cv2's Hershey font."""
    if font_path:
        from PIL import Image, ImageDraw

        font = _truetype(font_path, font_size)
        im = Image.fromarray(out)
        d = ImageDraw.Draw(im)
        for text, (x, y), color in labels:
            d.text((x, max(y - font_size - 2, 0)), text, fill=color, font=font)
        return np.asarray(im)
    import cv2

    for text, (x, y), color in labels:
        cv2.putText(out, text, (x, max(y - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.55, color, 2, cv2.LINE_AA)
    return out


def draw_detections(img_rgb: np.ndarray, detections: np.ndarray,
                    class_names: List[str],
                    font_path: Optional[str] = None) -> np.ndarray:
    """Box + class-name overlay (reference: img_detect.py drawing)."""
    import cv2

    out = img_rgb.copy()
    labels = []
    for row in detections:
        x1, y1, x2, y2 = (int(v) for v in row[:4])
        cls = int(row[6])
        color = _color_for(cls)
        cv2.rectangle(out, (x1, y1), (x2, y2), color, 2)
        labels.append((f"{class_names[cls]} {row[4]:.2f}", (x1, y1), color))
    return _draw_labels(out, labels, font_path)


def draw_tracks(img_rgb: np.ndarray, outputs: np.ndarray,
                font_path: Optional[str] = None) -> np.ndarray:
    import cv2

    out = img_rgb.copy()
    labels = []
    for x1, y1, x2, y2, tid in outputs:
        color = _color_for(int(tid))
        cv2.rectangle(out, (int(x1), int(y1)), (int(x2), int(y2)), color, 2)
        labels.append((f"id {int(tid)}", (int(x1), int(y1)), color))
    return _draw_labels(out, labels, font_path)


def draw_fps(img_rgb: np.ndarray, fps: float) -> np.ndarray:
    import cv2

    cv2.putText(img_rgb, f"FPS: {fps:.1f}", (10, 26),
                cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 255, 0), 2, cv2.LINE_AA)
    return img_rgb
