"""Multi-stream serving steps: the bucketed chunked detect -> track step,
the monolithic chunk step it is measured against, the single-frame
low-latency step, and the stream mesh's sharded step and cross-camera
global ids (port of yolo_deepsort_tpu/parallel/streams.py).

A chunk is K frames of S streams, (K, S, H, W, 3) uint8 on the device.

* Detect stage (``make_scanned_detect_stage``): fused letterbox (kernel 1)
  -> Darknet forward + YOLO decode -> weighted-merge NMS over all K*S frames
  at full detection capacity, plus a 5-int stats vector. With
  ``tracked_class_ids`` only detections of those classes are tracked: the
  crop-extent stats cover those rows only, the count covers all.
* One host readback of the stats picks the capacity bucket and the ReID
  crop window (``BucketedScannedStep.track``).
* Track stage (``make_scanned_track_stage``): rescale -> windowed crops
  (``make_chunk_crops``: kernel 2, or kernel 6 under
  ``YDT_CROPS_LAYOUT=interleaved``, on the frames the reference's crop gate
  takes; the dense crop entry on the others) -> ReID embed -> a K-frame
  Python loop of the fused tracker step (kernel 3), one launch per frame.

``make_scanned_step`` is the reference's monolithic chunk step: the same
stages with no readback, at the worst-case capacity and with dense crops.
It and its per-frame body ``fused_frame_step`` share their stateless
stages (``_make_detect_embed``).

``make_batched_step`` is the K=1 step: one frame of every stream per call,
no readback inside the step -- capacity is a static ``cap``; on the card its
detector is replayed from a CUDA graph (``DetectorGraph``); a bf16 embed's
crops are one launch of the dense crop entry, an f32 embed's crop window is
guarded on the device. Both steps can route whitelisted backbone
convs through the tensor-core conv kernel (kernel 7, ``_make_conv_impl``),
the backbone's residual chains through the fused chain kernel (kernel 9,
``_make_block_impl``: one launch per chain) and run the ReID embed in int8
(``embed_int8``, ``_make_embed``: the int8-resident route launches kernel 8
once per quantized conv).

Over the stream mesh (``parallel/mesh.py``: one rank per device, each
holding S_total / size streams), ``make_sharded_step`` is each rank's
batched step with no collective, ``make_global_id_step`` aliases tracks
across cameras into global ids (``GlobalIDState``; between its rounds
``assign_provisional_gids``, then ``relabel_outputs_global``), and
``make_cross_camera_matcher`` matches queries against every rank's
galleries; these two gather over ``mesh.group`` and are plain torch ops, as
the reference leaves them to XLA.

The models are ``nn.Module``s already on the target device and dtype (with
an int8 embed route, ``reid`` is the quantized package instead); the kernel
wrappers launch their CUDA kernels for CUDA tensors and run their plain
PyTorch versions for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DetectorConfig, TrackerConfig
from ..device import resolve_device
from ..models.darknet import Darknet
from ..models.reid import ReIDNet
from ..ops import conv_kernel
from ..ops.crops import (
    crop_and_normalize,
    crop_and_normalize_batch,
    crop_and_normalize_windowed,
    crop_window_bounds,
)
from ..ops.crops_kernel import (
    crop_and_normalize_dense,
    crop_and_normalize_fused,
    crops_pallas_order_supported,
)
from ..ops.letterbox import rescale_boxes
from ..ops.letterbox_kernel import letterbox_batch_fused
from ..ops.nms import batched_nms, batched_nms_with_stats
from ..tracking.tracker import (
    STATE_CONFIRMED,
    TrackerState,
    init_tracker_state,
    tracker_step,
)
from ..tracking.tracker_kernel import tracker_step_fused_batched
from ..utils.profiling import span
from .mesh import StreamMesh, all_gather, make_stream_mesh  # noqa: F401


def _make_conv_impl(use_pallas_conv, backbone_int8_pkg):
    """Resolve the backbone conv route of the serving steps (the argument
    keeps the reference's name).

    use_pallas_conv: False (library convs) | True (the tensor-core conv
    kernel on every eligible layer; on CPU tensors its plain version) |
    "plain-twin" (the arithmetically identical plain int8 route,
    ``models/quantize_darknet.make_plain_int8_conv_impl``, for accuracy
    gates; requires backbone_int8_pkg) | a dict {"bf16": frozenset, "int8":
    frozenset} as ``ops/conv_kernel.load_conv_whitelist`` returns it
    (per-layer routing: only those layers leave the library conv; int8
    layers also need their entry in backbone_int8_pkg, else they run the
    bf16 kernel)."""
    if not use_pallas_conv:
        return None
    from ..ops.conv_kernel import make_backbone_conv_impl

    if isinstance(use_pallas_conv, dict):
        wl = (frozenset(use_pallas_conv.get("bf16", ()))
              | frozenset(use_pallas_conv.get("int8", ())))
        return make_backbone_conv_impl(layer_whitelist=wl,
                                       int8_pkg=backbone_int8_pkg)
    if use_pallas_conv == "plain-twin":
        if backbone_int8_pkg is None:
            raise ValueError("plain-twin conv route requires "
                             "backbone_int8_pkg")
        from ..models.quantize_darknet import make_plain_int8_conv_impl

        return make_plain_int8_conv_impl(backbone_int8_pkg)
    if use_pallas_conv is not True:
        raise ValueError(f"unknown conv route {use_pallas_conv!r}")
    return make_backbone_conv_impl(int8_pkg=backbone_int8_pkg)


def _make_block_impl(plan, use_resblock, backbone_int8_pkg):
    """Resolve the fused residual-chain route (``ops/resblock_kernel.py``;
    the argument keeps the reference's name and values).

    use_resblock: False (off) | True (bf16 chains) | "int8" (W8A8 chains for
    chains whose blocks all have BOTH convs in backbone_int8_pkg, bf16
    chains otherwise; requires the package) | a dict {"chains": [start
    indices], "int8": bool} restricting the route to those chains. On CPU
    tensors a chain runs the kernel's plain version. Composable with a conv
    route: ``Darknet.forward`` consults ``block_impl`` first (it claims whole
    residual spans), ``conv_impl`` sees the remaining layers."""
    if not use_resblock:
        return None
    from ..ops.resblock_kernel import make_resblock_impl

    if isinstance(use_resblock, dict):
        unknown = set(use_resblock) - {"chains", "int8"}
        if unknown:
            raise ValueError(f"unknown resblock route keys {sorted(unknown)}")
        int8 = bool(use_resblock.get("int8"))
        if int8 and backbone_int8_pkg is None:
            raise ValueError("int8 resblock route requires backbone_int8_pkg")
        wl = use_resblock.get("chains")
        return make_resblock_impl(
            plan, int8_pkg=backbone_int8_pkg if int8 else None,
            chain_whitelist=None if wl is None else frozenset(wl))
    if use_resblock == "int8":
        if backbone_int8_pkg is None:
            raise ValueError("int8 resblock route requires backbone_int8_pkg")
        return make_resblock_impl(plan, int8_pkg=backbone_int8_pkg)
    if use_resblock is not True:
        raise ValueError(f"unknown resblock route {use_resblock!r}")
    return make_resblock_impl(plan)


def _resolve_reid(reid, embed_int8):
    """The ReID net as the embed route reads it (the argument keeps the
    reference's name and values).

    embed_int8: False (``reid`` is the ``nn.Module``) | True (per-layer
    W8A8, no kernel; ``reid`` is the ``models/quantize.quantize_reid_params``
    package) | "resident" (the plain version of the int8-resident dataflow)
    | "resident_pallas" (kernel 8 on every quantized conv; on CPU tensors
    its plain version); the resident routes take the
    ``quantize_reid_params_resident`` package. A package may be numpy
    (converted here, onto the CUDA card) or already converted by
    ``weights.reid_int8_package_to_torch``."""
    if not embed_int8:
        if isinstance(reid, dict):
            raise ValueError("an int8 ReID package needs an embed_int8 route")
        return reid
    if embed_int8 not in (True, "resident", "resident_pallas"):
        raise ValueError(f"unknown embed route {embed_int8!r}")
    from ..models.quantize import is_torch_package
    from ..weights import reid_int8_package_to_torch

    resident = embed_int8 is not True
    if not isinstance(reid, dict) or ("front" in reid) != resident:
        raise ValueError(
            f"embed_int8={embed_int8!r} takes the package of models/quantize."
            f"{'quantize_reid_params_resident' if resident else 'quantize_reid_params'}"
            " as reid")
    return reid if is_torch_package(reid) else reid_int8_package_to_torch(reid)


def _make_embed(reid, embed_int8):
    """-> (embed(crops (N, 128, 64, 3)) -> (N, F) f32 features, the dtype
    the crops are made in, the device the net lies on)."""
    reid = _resolve_reid(reid, embed_int8)
    if not embed_int8:
        def embed(crops):
            with span("ydt.embed"):
                return reid(crops)
        return embed, reid.stem.weight.dtype, reid.stem.weight.device
    from ..models import quantize as Q

    if embed_int8 is True:
        def embed(crops):
            with span("ydt.embed"):
                return Q.reid_apply_int8(reid, crops)
    else:
        def embed(crops):
            with span("ydt.embed"):
                return Q.reid_apply_int8_resident(
                    reid, crops, use_pallas=embed_int8 == "resident_pallas")
    return embed, Q.package_front_dtype(reid), Q.package_device(reid)


def init_stream_states(trk_cfg: TrackerConfig, n_streams: int,
                       device=None) -> TrackerState:
    """Fresh tracker state for ``n_streams`` streams (ids are per stream),
    on the CUDA card unless ``device`` names another."""
    return init_tracker_state(trk_cfg, n_streams, device)


def class_filter(class_ids, device):
    """``tracked_class_ids`` -> fn(boxes7 (..., 7)) -> (...) bool, True for
    rows whose class is tracked (None: every row). The ids are copied to
    the device once, here, not per call."""
    if class_ids is None:
        return None
    ids = torch.as_tensor(np.asarray(class_ids, np.int32), device=device)

    def tracked(boxes7):
        cls = boxes7[..., 6].to(torch.int32)
        return (cls[..., None] == ids).any(-1)

    return tracked


def _frame_boxes(boxes7, size: int, h: int, w: int):
    """Letterboxed xyxy -> clipped frame xyxy (..., 4) and tlwh (..., 4)."""
    xyxy = rescale_boxes(boxes7[..., :4], size, h, w)
    x1 = xyxy[..., 0].clamp(0, w - 1)
    y1 = xyxy[..., 1].clamp(0, h - 1)
    x2 = xyxy[..., 2].clamp(0, w - 1)
    y2 = xyxy[..., 3].clamp(0, h - 1)
    return (torch.stack([x1, y1, x2, y2], -1),
            torch.stack([x1, y1, x2 - x1, y2 - y1], -1))


def make_scanned_detect_stage(
    detector: Darknet,
    det_cfg: DetectorConfig,
    trk_cfg: TrackerConfig,
    frame_hw: Tuple[int, int],
    conf_thres_per_stream: Optional[Sequence[float]] = None,
    tracked_class_ids=None,
    use_pallas_conv=False,  # backbone conv route, see _make_conv_impl
    backbone_int8_pkg=None,  # models/quantize_darknet package (int8 layers)
    use_resblock=False,  # fused residual-chain route, see _make_block_impl
):
    """Returns detect(frames (K, S, H, W, 3) uint8) -> (boxes7 (K*S, D, 7),
    mask (K*S, D), stats (5,) int32). stats = [max per-frame count
    (survivors the max_dets output dropped included), max crop height,
    max crop width over valid rows of tracked classes, NMS top-k drops,
    NMS max_dets drops]. Valid rows are a contiguous score-descending
    prefix, so any capacity >= the count keeps every detection."""
    h, w = frame_hw
    size = det_cfg.img_size
    param = next(detector.parameters())
    dtype = param.dtype
    # copied to the device once: a copy per call would synchronize the stream
    thr = (None if conf_thres_per_stream is None else torch.as_tensor(
        np.asarray(conf_thres_per_stream, np.float32), device=param.device))
    tracked = class_filter(tracked_class_ids, param.device)
    conv_impl = _make_conv_impl(use_pallas_conv, backbone_int8_pkg)
    block_impl = _make_block_impl(detector.plan, use_resblock,
                                  backbone_int8_pkg)

    @torch.no_grad()
    def detect(frames: torch.Tensor):
        k, s = frames.shape[0], frames.shape[1]
        flat = frames.reshape(k * s, h, w, 3)
        xs = letterbox_batch_fused(flat, size, out_dtype=dtype)
        decoded = detector(xs, conv_impl=conv_impl, block_impl=block_impl)
        conf = det_cfg.conf_thres if thr is None else thr.repeat(k)
        boxes7, mask, sat = batched_nms_with_stats(
            decoded, conf, det_cfg.nms_thres, det_cfg.max_boxes,
            trk_cfg.max_dets)
        max_count = (mask.sum(-1, dtype=torch.int32) + sat[:, 1]).max()
        # only tracked rows' crops are ever embedded
        consumed = mask if tracked is None else mask & tracked(boxes7)
        xyxy = rescale_boxes(boxes7[..., :4], size, h, w)
        x1, y1, x2, y2 = crop_window_bounds(xyxy, h, w)
        zero = torch.zeros_like(y1)
        ch = torch.where(consumed, y2 - y1, zero)
        cw = torch.where(consumed, x2 - x1, zero)
        stats = torch.stack([max_count, ch.max(), cw.max(), sat[:, 0].sum(),
                             sat[:, 1].sum()]).to(torch.int32)
        return boxes7, mask, stats

    return detect


def dense_crops(frames, boxes_xyxy, dtype, batched=False):
    """The reference's ``vmap(crop_and_normalize)`` over a frame batch:
    (B, H, W, 3) uint8, (B, D, 4) clipped xyxy -> (B, D, 128, 64, 3) f32,
    in the dense (XLA) rounding order over the whole frame. bf16: one
    launch of the dense crop entry (``crop_and_normalize_dense``; on CPU
    tensors its plain version). Other dtypes: ``crop_and_normalize`` frame
    by frame, or with ``batched`` ``crop_and_normalize_batch``, one set of
    ops over the batch, bit-equal to it (held at f32 on the CPU and the
    card) but with an X-pass intermediate B times as large, so only the
    monolithic step takes it."""
    if dtype == torch.bfloat16:
        return crop_and_normalize_dense(frames, boxes_xyxy.contiguous())
    if batched:
        return crop_and_normalize_batch(frames, boxes_xyxy, dtype)
    return torch.stack([
        crop_and_normalize(frames[i], boxes_xyxy[i], compute_dtype=dtype)
        for i in range(frames.shape[0])])


def make_chunk_crops(frame_hw: Tuple[int, int],
                     crop_window: Optional[Tuple[int, int]], dtype):
    """The track stage's ReID crops: crops(frames (B, H, W, 3), boxes_xyxy
    (B, D, 4)) -> (B, D, 128, 64, 3) f32, rounded as the reference's
    bucketed step rounds them on its TPU backend. ``crop_window`` (win_h,
    win_w) must cover every consumed detection's integer crop (the detect
    stage's stats guarantee it); a full-frame window is the dense path.

    bf16 with a window, on a frame the reference's crop gate takes
    (``crops_pallas_order_supported``: H % 8 == 0 and W % 128 == 0, as
    1080p, 720p and 4K are): kernel 2 (kernel 6 under
    ``YDT_CROPS_LAYOUT=interleaved``), the Pallas rounding order. Any other
    bf16 crops -- a frame the gate refuses, or no window -- are one launch
    of the dense entry (``dense_crops``): the reference makes them in the
    dense order, and its windowed form equals its dense form whenever every
    crop fits. Other dtypes: the windowed resampler frame by frame, or
    without a window ``dense_crops`` (``compute_dtype`` honoured)."""
    h, w = frame_hw
    if crop_window is not None and crop_window[0] >= h and crop_window[1] >= w:
        crop_window = None  # a full-frame window is the dense path
    bf16 = dtype == torch.bfloat16
    if crop_window is None or (bf16
                               and not crops_pallas_order_supported(h, w)):
        return lambda frames, boxes_xyxy: dense_crops(frames, boxes_xyxy,
                                                      dtype)
    wh, ww = crop_window
    if bf16:
        return lambda frames, boxes_xyxy: crop_and_normalize_fused(
            frames, boxes_xyxy.contiguous(), wh, ww)
    return lambda frames, boxes_xyxy: torch.stack([
        crop_and_normalize_windowed(frames[i], boxes_xyxy[i], wh, ww,
                                    compute_dtype=dtype)
        for i in range(frames.shape[0])])


def make_scanned_track_stage(
    reid: ReIDNet,
    det_cfg: DetectorConfig,
    trk_cfg: TrackerConfig,
    frame_hw: Tuple[int, int],
    cap: int,
    crop_window: Optional[Tuple[int, int]] = None,
    tracked_class_ids=None,
    embed_int8=False,  # the ReID embed's int8 route, see _resolve_reid
):
    """Returns track(states, frames (K, S, H, W, 3), boxes7, mask) ->
    (states, (outputs (K, S, T, 5), emit (K, S, T))) at detection capacity
    ``cap``. ``crop_window`` (win_h, win_w) must cover every valid
    detection's integer crop (the detect stage's stats guarantee it). The
    crops are made in the dtype of the embed's front (an int8-resident
    embed: bf16) as ``make_chunk_crops`` says: a bf16 window takes kernel 2
    on the frames the reference's crop gate takes, the dense entry on the
    others and without a window; an f32 embed keeps the f32 resamplers, so
    the compute dtype is honoured."""
    h, w = frame_hw
    size = det_cfg.img_size
    cfg_c = dataclasses.replace(trk_cfg, max_dets=cap)
    embed, dtype, device = _make_embed(reid, embed_int8)
    tracked = class_filter(tracked_class_ids, device)
    crops_of = make_chunk_crops(frame_hw, crop_window, dtype)

    @torch.no_grad()
    def track(states: TrackerState, frames, boxes7, mask):
        k, s = frames.shape[0], frames.shape[1]
        flat = frames.reshape(k * s, h, w, 3)
        b7 = boxes7[:, :cap]
        m = mask[:, :cap]
        if tracked is not None:
            m = m & tracked(b7)
        boxes_xyxy, tlwh = _frame_boxes(b7, size, h, w)
        with span("ydt.crops"):
            crops = crops_of(flat, boxes_xyxy)
        feats = embed(crops.reshape(k * s * cap, *crops.shape[2:]))
        feats = feats.reshape(k, s, cap, -1)
        per_frame = lambda a: a.reshape(k, s, *a.shape[1:])  # noqa: E731
        tlwh, conf, m = per_frame(tlwh), per_frame(b7[..., 5]), per_frame(m)
        outputs, emits = [], []
        for f in range(k):  # the K-frame scan: one kernel launch per frame
            states, out, emit = tracker_step_fused_batched(
                cfg_c, states, tlwh[f], conf[f], feats[f], m[f], (h, w))
            outputs.append(out)
            emits.append(emit)
        return states, (torch.stack(outputs), torch.stack(emits))

    return track


def make_k1_crops(frame_hw: Tuple[int, int],
                  crop_window: Optional[Tuple[int, int]], dtype):
    """The K=1 step's ReID crops: crops(frames (S, H, W, 3), boxes_xyxy
    (S, D, 4), mask (S, D)) -> (S, D, 128, 64, 3) f32, the reference step's
    value on both sides of its window guard.

    bf16, and any dtype without a window: ``dense_crops`` (at bf16 one
    launch of the dense crop entry over the whole frame). The
    reference rounds in the dense (XLA) order on both branches of its
    ``lax.cond``, and its windowed form equals its dense form whenever the
    guard takes it, so the window changes nothing here.
    Other dtypes: the windowed resampler with an exactness guard on the
    device -- the windowed crops equal the dense ones bit for bit only when
    every consumed crop fits the window. The reference branches on that
    with ``lax.cond``; a branch on a device value would cost a host sync
    here, so both forms are computed and ``torch.where`` selects on the
    device flag."""
    h, w = frame_hw
    win = None
    if crop_window is not None and dtype != torch.bfloat16:
        win = (min(crop_window[0], h), min(crop_window[1], w))
        win = None if win == (h, w) else win
    if win is None:
        return lambda frames, boxes_xyxy, mask: dense_crops(frames,
                                                            boxes_xyxy, dtype)

    def guarded(frames, boxes_xyxy, mask):
        wh, ww = win
        x1i, y1i, x2i, y2i = crop_window_bounds(boxes_xyxy, h, w)
        fits = (~mask | (((y2i - y1i) <= wh) & ((x2i - x1i) <= ww))).all()
        windowed = torch.stack([
            crop_and_normalize_windowed(frames[i], boxes_xyxy[i], wh, ww,
                                        compute_dtype=dtype)
            for i in range(frames.shape[0])])
        return torch.where(fits, windowed,
                           dense_crops(frames, boxes_xyxy, dtype))

    return guarded


# The K=1 step's detector graphs, counted beside the kernels' launches
# (``kernels/launches.py``); only ``DetectorGraph`` adds to them.
detector_graph_launches = 0  # detector forwards replayed from a graph
detector_capture_launches = 0  # detector forwards captured in a graph
detector_eager_launches = 0  # detector forwards on the card run eagerly


class DetectorGraph:
    """The K=1 step's detector forward: ``graph(xs)`` -> decoded rows,
    ``detector(xs, conv_impl=conv_impl, block_impl=block_impl)`` bit for
    bit. On the card it is replayed from a CUDA graph, one launch in place
    of one a device op; CPU tensors run the forward as it is.

    The graph reads a static input, into which ``xs`` is copied (one device
    copy), and writes a static output, which the call returns: the caller
    reads it on the current stream before its next call enqueues the next
    replay behind that. The graph is keyed on what the code can observe:
    the device, ``xs``'s shape and dtype, the memory and version counter of
    every detector parameter (``load_params``, an in-place update and
    ``.to`` change them) and the float32 math modes of the library convs. A
    call with a new key drops the graph and runs eagerly, which fills the
    kernels' packed-weight caches and the conv planner; the next call with
    that key captures, on a memory pool of the graph's own, and replays. No
    capture starts while a torch profiler records: that call runs eagerly.

    The kernels' launch counters count at capture, not at replay; but
    ``conv_mish``, the conv kernel's launches that run mish, counts the
    forwards that run: the capture's count is kept and taken back, and
    every replay (the capturing call's own included) adds it."""

    def __init__(self, detector: Darknet, conv_impl=None, block_impl=None):
        self.detector = detector
        self.conv_impl, self.block_impl = conv_impl, block_impl
        # the layers that hold parameters, walked once: a walk of the module
        # tree would cost the step ~0.15 ms, their parameter dicts ~0.05
        self.layers = [m for m in detector.modules() if m._parameters]
        self.key = None
        self.graph = self.x = self.out = None
        self.mish = 0  # mish conv launches the graph holds

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        return self.detector(xs, conv_impl=self.conv_impl,
                             block_impl=self.block_impl)

    def key_of(self, xs: torch.Tensor) -> tuple:
        return (xs.device, xs.shape, xs.dtype,
                torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.deterministic,
                tuple((p.data_ptr(), p._version) for m in self.layers
                      for p in m._parameters.values() if p is not None))

    def __call__(self, xs: torch.Tensor) -> torch.Tensor:
        global detector_graph_launches, detector_eager_launches
        if xs.device.type != "cuda":
            return self.forward(xs)
        key = self.key_of(xs)
        if key != self.key or (self.graph is None
                               and torch._C._autograd._profiler_enabled()):
            if key != self.key:  # the key is warm after this eager call
                self.key, self.graph, self.x, self.out = key, None, None, None
            detector_eager_launches += 1
            return self.forward(xs)
        if self.graph is None:
            self.capture(xs)
        with span("ydt.detector"):
            self.x.copy_(xs)
            self.graph.replay()
        detector_graph_launches += 1
        conv_kernel.launches_mish += self.mish
        return self.out

    def capture(self, xs: torch.Tensor) -> None:
        global detector_capture_launches
        self.x = torch.empty_like(xs)
        graph = torch.cuda.CUDAGraph()
        mish = conv_kernel.launches_mish
        # thread-local: other threads (the runtime's frame producers) may
        # call CUDA while this one captures
        with torch.cuda.device(xs.device), torch.cuda.graph(
                graph, stream=torch.cuda.Stream(xs.device),
                capture_error_mode="thread_local"):
            self.out = self.forward(self.x)
        self.graph = graph
        self.mish = conv_kernel.launches_mish - mish
        conv_kernel.launches_mish = mish  # the replay after it counts them
        detector_capture_launches += 1


def make_batched_step(
    detector: Darknet,
    reid: ReIDNet,
    det_cfg: DetectorConfig,
    trk_cfg: TrackerConfig,
    frame_hw: Tuple[int, int],
    tracked_class_ids=None,
    with_validity: bool = False,
    cap: Optional[int] = None,  # NMS and tracker at the top-``cap`` by score
    crop_window: Optional[Tuple[int, int]] = None,  # windowed ReID crops
    embed_int8=False,  # the ReID embed's int8 route, see _resolve_reid
    use_pallas_conv=False,  # backbone conv route, see _make_conv_impl
    backbone_int8_pkg=None,  # models/quantize_darknet package (int8 layers)
    use_resblock=False,  # fused residual-chain route, see _make_block_impl
):
    """Single-frame multi-stream step: step(states, frames (S, H, W, 3)
    uint8) -> (states, (outputs (S, T, 5), emit (S, T))). The models are
    shared; tracker state is per stream. The compute dtype is the models'.

    ``with_validity`` adds a (S,) bool ``frame_valid`` argument: a stream
    whose decode failed this step keeps its tracker state unchanged (no
    aging, no deletions: the frame never happened) and emits nothing, while
    the healthy streams proceed. The gallery is written in place, so an
    invalid stream's detections are masked before the tracker step (no
    detection, no gallery write) and its other fields are taken from the
    old state afterwards.

    Low-latency mode: ``cap`` runs NMS and the tracker at capacity ``cap``
    (NMS emits score-descending, so a frame with more real detections drops
    its lowest-scoring ones), and ``crop_window`` routes an f32 embed's
    ReID crops through the windowed resampler with an exactness guard on the
    device; a bf16 embed's crops are one launch of the dense crop entry
    whatever the window (``make_k1_crops``).

    The step launches the letterbox (K1), with a conv route the conv kernel
    (K7) once per routed layer, with ``use_resblock`` the chain kernel (K9)
    once per routed chain, with a bf16 embed the dense crops, with
    ``embed_int8="resident_pallas"`` the int8 conv kernel (K8) once per
    quantized ReID conv, and the fused tracker step (K3), and reads nothing
    back. On the card the detector's launches are replayed from a CUDA
    graph (``DetectorGraph``) from the second call with the same input and
    weights on; the stages after it run eagerly."""
    h, w = frame_hw
    size = det_cfg.img_size
    cfg_c = trk_cfg
    if cap is not None and cap < trk_cfg.max_dets:
        cfg_c = dataclasses.replace(trk_cfg, max_dets=cap)
    d = cfg_c.max_dets
    conv_impl = _make_conv_impl(use_pallas_conv, backbone_int8_pkg)
    block_impl = _make_block_impl(detector.plan, use_resblock,
                                  backbone_int8_pkg)
    param = next(detector.parameters())
    det_dtype = param.dtype
    embed, reid_dtype, _ = _make_embed(reid, embed_int8)
    tracked = class_filter(tracked_class_ids, param.device)
    crops_of = make_k1_crops(frame_hw, crop_window, reid_dtype)
    detect = DetectorGraph(detector, conv_impl, block_impl)

    @torch.no_grad()
    def run(states: TrackerState, frames: torch.Tensor, frame_valid=None):
        with span("ydt.k1_step"):
            return body(states, frames, frame_valid)

    def body(states, frames, frame_valid):
        s = frames.shape[0]
        xs = letterbox_batch_fused(frames, size, out_dtype=det_dtype)
        decoded = detect(xs)
        # NMS at the ``cap`` capacity directly: its rows are a contiguous
        # score-descending prefix, so the first ``cap`` equal a run at
        # max_dets sliced, in cap-many steps instead of max_dets-many
        boxes7, mask = batched_nms(decoded, det_cfg.conf_thres,
                                   det_cfg.nms_thres, det_cfg.max_boxes, d)
        if tracked is not None:
            mask = mask & tracked(boxes7)
        if frame_valid is not None:
            mask = mask & frame_valid[:, None]
        boxes_xyxy, tlwh = _frame_boxes(boxes7, size, h, w)
        with span("ydt.crops"):
            crops = crops_of(frames, boxes_xyxy, mask)
        feats = embed(crops.reshape(s * d, *crops.shape[2:])).reshape(s, d, -1)
        new, outputs, emit = tracker_step_fused_batched(
            cfg_c, states, tlwh, boxes7[..., 5], feats, mask, (h, w))
        if frame_valid is None:
            return new, (outputs, emit)
        kept = {}
        for f in dataclasses.fields(TrackerState):
            a, b = getattr(new, f.name), getattr(states, f.name)
            if f.name == "gallery":  # written in place; untouched rows above
                kept[f.name] = a
            else:
                valid = frame_valid.reshape((-1,) + (1,) * (a.dim() - 1))
                kept[f.name] = torch.where(valid, a, b)
        return TrackerState(**kept), (outputs, emit & frame_valid[:, None])

    if not with_validity:
        return lambda states, frames: run(states, frames)
    return run


def _make_detect_embed(detector: Darknet, reid: ReIDNet,
                       det_cfg: DetectorConfig, trk_cfg: TrackerConfig,
                       frame_hw: Tuple[int, int], tracked_class_ids=None):
    """The stateless stages of ``make_scanned_step`` and
    ``fused_frame_step``: detect_embed(frames (B, H, W, 3) uint8,
    letterboxed=None, decoded=None, with_feats=True) -> (tlwh (B, D, 4),
    conf (B, D), mask (B, D), xyxy (B, D, 4), feats (B, D, F) or None).
    Letterbox (kernel 1) -> Darknet forward and decode -> NMS at
    ``trk_cfg.max_dets`` -> rescale, clip and class filter -> the dense
    crops of all B*D rows (``dense_crops``, batched) -> one ReID embed.
    ``letterboxed`` (B, size, size, 3) replaces the letterbox, ``decoded``
    (B, N, 5+C) the letterbox and the forward."""
    h, w = frame_hw
    size = det_cfg.img_size
    param = next(detector.parameters())
    embed, reid_dtype, _ = _make_embed(reid, False)
    tracked = class_filter(tracked_class_ids, param.device)

    @torch.no_grad()
    def detect_embed(frames, letterboxed=None, decoded=None,
                     with_feats=True):
        if decoded is None:
            if letterboxed is None:
                letterboxed = letterbox_batch_fused(frames, size,
                                                    out_dtype=param.dtype)
            decoded = detector(letterboxed)
        boxes7, mask = batched_nms(decoded, det_cfg.conf_thres,
                                   det_cfg.nms_thres, det_cfg.max_boxes,
                                   trk_cfg.max_dets)
        if tracked is not None:
            mask = mask & tracked(boxes7)
        xyxy, tlwh = _frame_boxes(boxes7, size, h, w)
        feats = None
        if with_feats:
            crops = dense_crops(frames, xyxy, reid_dtype, batched=True)
            b, d = crops.shape[:2]
            feats = embed(crops.reshape(b * d, *crops.shape[2:]))
            feats = feats.reshape(b, d, -1)
        return tlwh, boxes7[..., 5], mask, xyxy, feats

    return detect_embed


def fused_frame_step(
    detector: Darknet,
    reid: ReIDNet,
    det_cfg: DetectorConfig,
    trk_cfg: TrackerConfig,
    frame_hw: Tuple[int, int],
    state: TrackerState,
    frame_rgb: torch.Tensor,  # (H, W, 3) uint8
    tracked_class_ids=None,  # optional (C,) class ids
    letterboxed: Optional[torch.Tensor] = None,  # (size, size, 3) input
    decoded: Optional[torch.Tensor] = None,  # (N, 5+C) network output
    return_dets=False,  # False | True | "boxes", as in the reference
):
    """One stream, one frame (the reference's per-stream body):
    ``_make_detect_embed``'s stages at B = 1, then associate. The compute
    dtypes are the models' own (the crops follow the ReID net's; a bf16
    net's are one launch of the dense crop entry). ``state`` is a
    one-stream ``TrackerState`` (S = 1). ``letterboxed`` replaces the
    letterbox (kernel 1, one frame) with a given input; ``decoded`` also
    skips the backbone. Returns, as the reference does:
      * return_dets=False: (state, (outputs (T, 5), emit (T,))), through
        ``tracker_step`` (on the card: kernel 5 once);
      * return_dets=True: (tlwh (D, 4), conf (D,), feats (D, F), mask (D,)),
        the stateless half;
      * return_dets="boxes": (tlwh, conf, mask, xyxy (D, 4)), before the
        crops and the embed."""
    detect_embed = _make_detect_embed(detector, reid, det_cfg, trk_cfg,
                                      frame_hw, tracked_class_ids)
    tlwh, conf, mask, xyxy, feats = detect_embed(
        frame_rgb[None],
        None if letterboxed is None else letterboxed[None],
        None if decoded is None else decoded.reshape(1, *decoded.shape[-2:]),
        with_feats=return_dets != "boxes")
    if return_dets == "boxes":
        return tlwh[0], conf[0], mask[0], xyxy[0]
    if return_dets:
        return tlwh[0], conf[0], feats[0], mask[0]
    with torch.no_grad():
        state, outputs, emit = tracker_step(trk_cfg, state, tlwh, conf,
                                            feats, mask, frame_hw)
    return state, (outputs[0], emit[0])


def make_scanned_step(
    detector: Darknet,
    reid: ReIDNet,
    det_cfg: DetectorConfig,
    trk_cfg: TrackerConfig,
    frame_hw: Tuple[int, int],
    n_frames: int,
    tracked_class_ids=None,
    use_fused_tracker=None,  # None | True: kernel 3; False: tracker_step
):
    """The monolithic K-frame step (the reference's ``make_scanned_step``):
    step(states, frames (K, S, H, W, 3) uint8) -> (states, (outputs (K, S,
    T, 5), emit (K, S, T))), ``n_frames`` = K, the chunk it is built for
    (as in the reference, the frames' leading axis is what runs).

    ``_make_detect_embed``'s stages run as one K*S batch at the worst-case
    capacity ``trk_cfg.max_dets`` (kernel 1 once; a bf16 ReID net's crops
    one launch of the dense crop entry), then the tracker over the K frames
    in a Python loop: ``use_fused_tracker`` None or True the fused step
    (kernel 3, ``tracker_step_fused_batched``), False ``tracker_step``
    (kernel 5), once per frame. The port's kernel 3 takes any
    ``max_tracks`` up to 256, so the reference's ``max_tracks % 8 == 0``
    condition is not needed (on CPU tensors both branches are
    ``tracker_step``). The compute dtypes are the models' own; the step
    reads nothing back. Not taken from the reference: ``compute_dtype``,
    ``use_pallas_letterbox`` (the port's letterbox is always kernel 1) and
    ``donate_state`` (the gallery is written in place)."""
    del n_frames
    h, w = frame_hw
    detect_embed = _make_detect_embed(detector, reid, det_cfg, trk_cfg,
                                      frame_hw, tracked_class_ids)
    fused = use_fused_tracker is None or bool(use_fused_tracker)
    associate = tracker_step_fused_batched if fused else tracker_step

    @torch.no_grad()
    def step(states: TrackerState, frames: torch.Tensor):
        k, s = frames.shape[0], frames.shape[1]
        per_frame = lambda a: a.reshape(k, s, *a.shape[1:])  # noqa: E731
        tlwh, conf, mask, _, feats = (per_frame(a) for a in detect_embed(
            frames.reshape(k * s, h, w, 3)))
        outputs, emits = [], []
        for f in range(k):  # the K-frame scan: one kernel launch per frame
            states, out, emit = associate(trk_cfg, states, tlwh[f], conf[f],
                                          feats[f], mask[f], (h, w))
            outputs.append(out)
            emits.append(emit)
        return states, (torch.stack(outputs), torch.stack(emits))

    return step


class BucketedScannedStep:
    """The serving step: detection at full capacity, one readback of the
    chunk's stats, then the track stage at the smallest capacity bucket and
    crop window that hold every detection. Track-stage variants are built
    lazily per (bucket, window) and reused; tracker state layouts do not
    depend on the bucket, so states flow across buckets unchanged."""

    def __init__(
        self,
        detector: Darknet,
        reid: ReIDNet,
        det_cfg: DetectorConfig,
        trk_cfg: TrackerConfig,
        frame_hw: Tuple[int, int],
        buckets: Tuple[int, ...] = (8, 16, 32),
        conf_thres_per_stream=None,
        windows: Optional[Tuple[Tuple[int, int], ...]] = (
            (160, 96), (240, 128), (320, 192), (640, 384),
        ),
        tracked_class_ids=None,
        embed_int8=False,  # the ReID embed's int8 route, see _resolve_reid
        use_pallas_conv=False,  # backbone conv route, see _make_conv_impl
        backbone_int8_pkg=None,  # models/quantize_darknet package
        use_resblock=False,  # residual-chain route, see _make_block_impl
    ):
        h, w = frame_hw
        self._reid = _resolve_reid(reid, embed_int8)  # converted once
        self._embed_int8 = embed_int8
        self._det_cfg, self._trk_cfg = det_cfg, trk_cfg
        self._frame_hw = frame_hw
        self._class_ids = tracked_class_ids
        self._detect = make_scanned_detect_stage(
            detector, det_cfg, trk_cfg, frame_hw,
            conf_thres_per_stream=conf_thres_per_stream,
            tracked_class_ids=tracked_class_ids,
            use_pallas_conv=use_pallas_conv,
            backbone_int8_pkg=backbone_int8_pkg, use_resblock=use_resblock)
        self._buckets = tuple(sorted(
            {b for b in buckets if b < trk_cfg.max_dets} | {trk_cfg.max_dets}))
        ladder = [(min(wh, h), min(ww, w)) for wh, ww in (windows or ())]
        self._windows = tuple(sorted(set(ladder) | {(h, w)}))
        self._track = {}
        self.last_bucket: Optional[int] = None
        self.last_max_count: Optional[int] = None
        self.last_window: Optional[Tuple[int, int]] = None
        self.last_crop_hw: Optional[Tuple[int, int]] = None
        self.sat_nms_topk = 0
        self.sat_nms_dets = 0
        self.sat_bucket_chunks = 0
        self.host_readbacks = 0

    def saturation(self) -> dict:
        """Cumulative capacity-saturation counters (all 0 = nothing capped)."""
        return {"sat_nms_topk": self.sat_nms_topk,
                "sat_nms_dets": self.sat_nms_dets,
                "sat_bucket_chunks": self.sat_bucket_chunks}

    def _bucket_for(self, count: int) -> int:
        for b in self._buckets:
            if count <= b:
                return b
        return self._buckets[-1]

    def _window_for(self, max_h: int, max_w: int) -> Tuple[int, int]:
        for wh, ww in self._windows:
            if max_h <= wh and max_w <= ww:
                return (wh, ww)
        return self._windows[-1]

    def detect(self, frames: torch.Tensor):
        """Enqueue the detect stage; returns a handle for ``track``:
        (frames, boxes7, mask, stats, readback). On the card the stats are
        copied into pinned host memory behind the stage, with an event
        after the copy: ``track`` then waits for this chunk's detect stage
        only, not for work enqueued after it (the next chunk's detect)."""
        with span("ydt.chunk.detect"):
            boxes7, mask, stats = self._detect(frames)
            if stats.is_cuda:
                host = torch.empty(stats.shape, dtype=stats.dtype,
                                   pin_memory=True)
                host.copy_(stats, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(stats.device))
            else:
                host, done = stats, None
        return (frames, boxes7, mask, stats, (host, done))

    def track(self, states: TrackerState, handle):
        """Read the chunk's stats (the one host sync, counted in
        ``host_readbacks``), pick the bucket and window, run the track
        stage. A handle of (frames, boxes7, mask, stats) alone reads the
        stats with a plain copy."""
        frames, boxes7, mask, stats = handle[:4]
        with span("ydt.chunk.stats_wait"):
            host, done = handle[4] if len(handle) > 4 else (stats.cpu(), None)
            if done is not None:
                done.synchronize()
            self.host_readbacks += 1
            count, max_h, max_w, drop_topk, drop_dets = (
                int(v) for v in host.tolist())
        with span("ydt.chunk.track"):
            cap = self._bucket_for(count)
            win = self._window_for(max_h, max_w)
            self.last_bucket, self.last_max_count = cap, count
            self.last_window, self.last_crop_hw = win, (max_h, max_w)
            self.sat_nms_topk += drop_topk
            self.sat_nms_dets += drop_dets
            if count > self._buckets[-1]:
                self.sat_bucket_chunks += 1
            fn = self._track.get((cap, win))
            if fn is None:
                fn = self._track[(cap, win)] = make_scanned_track_stage(
                    self._reid, self._det_cfg, self._trk_cfg, self._frame_hw,
                    cap, crop_window=win, tracked_class_ids=self._class_ids,
                    embed_int8=self._embed_int8)
            return fn(states, frames, boxes7, mask)

    def __call__(self, states: TrackerState, frames: torch.Tensor):
        return self.track(states, self.detect(frames))


def make_scanned_step_bucketed(detector: Darknet, reid: ReIDNet,
                               det_cfg: DetectorConfig,
                               trk_cfg: TrackerConfig,
                               frame_hw: Tuple[int, int],
                               buckets: Tuple[int, ...] = (8, 16, 32),
                               tracked_class_ids=None,
                               conf_thres_per_stream=None,
                               windows: Optional[Tuple[Tuple[int, int], ...]] = (
                                   (160, 96), (240, 128), (320, 192),
                                   (640, 384)),
                               embed_int8=False, use_pallas_conv=False,
                               backbone_int8_pkg=None, use_resblock=False,
                               ) -> BucketedScannedStep:
    """The bucketed serving step (the reference's constructor function)."""
    return BucketedScannedStep(
        detector, reid, det_cfg, trk_cfg, frame_hw, buckets=buckets,
        conf_thres_per_stream=conf_thres_per_stream, windows=windows,
        tracked_class_ids=tracked_class_ids, embed_int8=embed_int8,
        use_pallas_conv=use_pallas_conv, backbone_int8_pkg=backbone_int8_pkg,
        use_resblock=use_resblock)


# ---------------------------------------------------------------------------
# The stream mesh: sharded serving and cross-camera global ids. One process
# (rank) per device holds its S_loc = S_total / size streams
# (``parallel/mesh.py``); the hot path has no collective, the global-id
# step and the matcher gather over ``mesh.group``.


def make_sharded_step(mesh: StreamMesh, detector: Darknet, reid: ReIDNet,
                      det_cfg: DetectorConfig, trk_cfg: TrackerConfig,
                      frame_hw: Tuple[int, int], tracked_class_ids=None,
                      use_pallas_letterbox: bool = False):
    """Stream-parallel serving over the mesh: step(states, frames (S_loc, H,
    W, 3) uint8) -> (states, (outputs (S_loc, T, 5), emit (S_loc, T))) for
    this rank's streams. The models are replicated, each rank holding its
    own copy on ``mesh.device``; each rank runs its streams' whole pipeline
    with zero collectives (the reference's ``vmap(fused_frame_step)`` under
    ``jit`` sharding): ``make_batched_step`` at no cap, one launch of each
    kernel for all local streams. The compute dtype is the models'.
    ``use_pallas_letterbox`` keeps the reference's signature; the port's
    letterbox is always kernel 1."""
    del use_pallas_letterbox
    param = next(detector.parameters())
    if param.device != mesh.device:
        raise ValueError(f"rank {mesh.rank} computes on {mesh.device}, but "
                         f"the detector lies on {param.device}")
    return make_batched_step(detector, reid, det_cfg, trk_cfg, frame_hw,
                             tracked_class_ids=tracked_class_ids)


def shared_gallery_distance(mesh: StreamMesh, local_feats: torch.Tensor):
    """Cross-camera shared-gallery helper: every rank's ReID features,
    concatenated on dim 0 in rank order (one tiled gather)."""
    return all_gather(mesh, local_feats, tiled=True)


class GlobalIDState(NamedTuple):
    """Cross-camera aliasing table, lane-aligned with ``TrackerState``.

    ``gid`` (S, T) int32: the global id reported for each track lane;
    ``owner`` (S, T) int32: the local track_id the gid was assigned for --
    when a lane is recycled (track_id changes) the gid resets to that
    track's provisional global id."""

    gid: torch.Tensor
    owner: torch.Tensor


def init_global_ids(trk_cfg: TrackerConfig, n_streams: int,
                    device=None) -> GlobalIDState:
    """An empty table on the CUDA card unless ``device`` names another."""
    z = torch.zeros((n_streams, trk_cfg.max_tracks), dtype=torch.int32,
                    device=resolve_device(device))
    return GlobalIDState(gid=z, owner=z.clone())


def relabel_outputs_global(outputs: torch.Tensor, gids: GlobalIDState):
    """Replace the local track-id column of lane-aligned tracker outputs
    (..., T, 5) with the global ids (S, T)."""
    gid = gids.gid[..., None].expand(outputs[..., :1].shape)
    return torch.cat([outputs[..., :4], gid.to(outputs.dtype)], -1)


def _provisional(track_id, gids: GlobalIDState, n_streams_total: int,
                 stream_idx):
    """Fresh or recycled lanes take their provisional gid
    ``(track_id - 1) * n_streams_total + global stream index + 1``."""
    prov = torch.where(track_id > 0,
                       (track_id - 1) * n_streams_total + stream_idx[:, None]
                       + 1, torch.zeros_like(track_id))
    fresh = (track_id != gids.owner) | (gids.gid == 0)
    return GlobalIDState(gid=torch.where(fresh, prov, gids.gid),
                         owner=track_id.clone())


def assign_provisional_gids(track_id: torch.Tensor, gids: GlobalIDState,
                            n_streams_total: int,
                            stream_offset: int = 0) -> GlobalIDState:
    """Local (collective-free) half of the global-ID protocol: fresh or
    recycled lanes of ``track_id`` (S_loc, T), global streams
    ``stream_offset + arange(S_loc)``, get their provisional unique gid at
    once, so emitted rows never show gid 0 between handoff rounds."""
    stream_idx = stream_offset + torch.arange(
        track_id.shape[0], dtype=torch.int32, device=track_id.device)
    return _provisional(track_id, gids, n_streams_total, stream_idx)


def _candidate_distances(gallery, gallery_count, queries):
    """(S, T, Q): 1 - the best cosine similarity of each track's gallery
    (S, T, B, F) rows to each query (Q, F), rows past ``gallery_count`` out
    (a track with none gives inf). The (S, T, B, Q) similarities are one
    f32 product; the mask is written into it in place."""
    sims = torch.einsum("stbf,qf->stbq", gallery, queries)
    b = gallery.shape[2]
    stale = (torch.arange(b, device=gallery.device)[None, None, :]
             >= gallery_count[:, :, None])
    sims.masked_fill_(stale[..., None], float("-inf"))
    return 1.0 - sims.amax(2)


def _global_best(mesh: StreamMesh, dist, values, first: int, n: int):
    """Per query column of ``dist`` (L local candidates, Q): the smallest
    distance over every rank's candidates and the ``values`` (L,) entry of
    the candidate that gives it (the first on ties: lowest local index,
    then lowest rank), for columns ``first .. first + n``. A column with
    no finite distance gives inf and candidate 0's value, as the
    reference's argmin does."""
    local_best = dist.argmin(0)
    ld = dist.gather(0, local_best[None])[0]
    lval = values[local_best]
    all_ld = all_gather(mesh, ld, tiled=False)  # (ranks, Q)
    all_lval = all_gather(mesh, lval, tiled=False)
    win = all_ld.argmin(0)[None]
    g_dist = all_ld.gather(0, win)[0, first:first + n]
    g_val = all_lval.gather(0, win)[0, first:first + n]
    return g_dist, g_val


def make_global_id_step(mesh: StreamMesh, trk_cfg: TrackerConfig,
                        n_streams_total: int,
                        match_thresh: Optional[float] = None):
    """Cross-camera global-ID handoff over the stream mesh: step(states,
    gids) -> GlobalIDState for this rank's S_loc = n_streams_total /
    mesh.size streams (the global streams ``rank * S_loc + arange(S_loc)``).

    Each call:
      1. assigns provisional global ids to fresh or recycled lanes;
      2. gathers every rank's queries (tiled, three gathers): each
         track's freshest gallery row at ``(gallery_head - 1) % B``,
         whether it is a confirmed track with a gallery, and its global
         stream (the reference also gathers the queries' gids, which it
         never reads);
      3. scores this rank's confirmed tracks against ALL queries (cosine,
         min over each ring buffer; same-stream pairs and invalid queries
         at inf), takes the local argmin per query, gathers the local bests
         (stacked, two gathers) and takes the global argmin;
      4. where the best cross-camera distance is below ``match_thresh``
         (default ``trk_cfg.max_dist``), a lane ADOPTS the smaller positive
         gid: min-adoption is commutative and idempotent, so repeated calls
         converge to the oldest id across the camera set.

    The step only reads ``states`` and returns new tensors. It reads
    nothing back to the host; the similarities are one f32 product (TF32
    stays off, as PyTorch's default has it)."""
    if n_streams_total % mesh.size:
        raise ValueError(f"{n_streams_total} streams do not divide over "
                         f"{mesh.size} ranks")
    thresh = trk_cfg.max_dist if match_thresh is None else match_thresh
    s_per = n_streams_total // mesh.size
    offset = mesh.rank * s_per

    @torch.no_grad()
    def step(states: TrackerState, gids: GlobalIDState) -> GlobalIDState:
        s_loc, t = states.track_id.shape
        if s_loc != s_per:
            raise ValueError(f"rank {mesh.rank} holds {s_loc} streams, the "
                             f"mesh gives it {s_per}")
        stream_idx = offset + torch.arange(
            s_loc, dtype=torch.int32, device=states.track_id.device)
        new = _provisional(states.track_id, gids, n_streams_total,
                           stream_idx)
        gallery = states.gallery
        b, f = gallery.shape[2], gallery.shape[3]
        q_loc = s_loc * t
        last = torch.remainder(states.gallery_head - 1, b).long()
        q_feat = torch.gather(gallery, 2,
                              last[..., None, None].expand(s_loc, t, 1, f))
        q_ok = ((states.state == STATE_CONFIRMED)
                & (states.gallery_count > 0)).reshape(q_loc)
        my_qgid = new.gid.reshape(q_loc)
        all_q = all_gather(mesh, q_feat.reshape(q_loc, f), tiled=True)
        all_qok = all_gather(mesh, q_ok, tiled=True)
        all_qstream = all_gather(
            mesh, stream_idx[:, None].expand(s_loc, t).reshape(q_loc),
            tiled=True)

        dist = _candidate_distances(gallery, states.gallery_count, all_q)
        dist.masked_fill_(~q_ok.reshape(s_loc, t)[..., None], float("inf"))
        # same-stream candidates never alias (handoff is cross-camera)
        dist.masked_fill_(stream_idx[:, None, None] == all_qstream,
                          float("inf"))
        dist.masked_fill_(~all_qok, float("inf"))
        my_dist, my_best = _global_best(mesh, dist.reshape(q_loc, -1),
                                        new.gid.reshape(q_loc),
                                        offset * t, q_loc)
        adopt = (q_ok & (my_dist < thresh) & (my_best > 0)
                 & (my_best < my_qgid))
        return GlobalIDState(
            gid=torch.where(adopt, my_best, my_qgid).reshape(s_loc, t),
            owner=new.owner)

    return step


def make_cross_camera_matcher(mesh: StreamMesh, trk_cfg: TrackerConfig):
    """Global re-identification across the stream mesh: match(states
    (S_loc, ...), query_feats (S_loc, D, F), query_mask (S_loc, D)) ->
    (best_track_id (S_loc, D), best_distance (S_loc, D)) for this rank's
    queries: the track id of the closest confirmed track on ANY rank
    (cosine distance, min over each track's gallery), -1 and inf where the
    query is masked or finds no confirmed track. One tiled gather of the
    queries, two stacked gathers of the per-rank bests."""
    del trk_cfg  # the reference's signature; the shapes come with the state

    @torch.no_grad()
    def match(states: TrackerState, query_feats: torch.Tensor,
              query_mask: torch.Tensor):
        s_loc, d, f = query_feats.shape
        q_loc = s_loc * d
        all_q = all_gather(mesh, query_feats.reshape(q_loc, f).float(),
                           tiled=True)
        dist = _candidate_distances(states.gallery, states.gallery_count,
                                    all_q)
        dist.masked_fill_((states.state != STATE_CONFIRMED)[..., None],
                          float("inf"))
        my_dist, my_id = _global_best(
            mesh, dist.reshape(-1, all_q.shape[0]),
            states.track_id.reshape(-1), mesh.rank * q_loc, q_loc)
        ok = query_mask.reshape(q_loc) & torch.isfinite(my_dist)
        my_id = torch.where(ok, my_id, torch.full_like(my_id, -1))
        my_dist = torch.where(ok, my_dist,
                              torch.full_like(my_dist, float("inf")))
        return my_id.reshape(s_loc, d), my_dist.reshape(s_loc, d)

    return match
