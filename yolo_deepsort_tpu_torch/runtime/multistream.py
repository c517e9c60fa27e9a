"""Multi-stream tracking runtime: N videos -> one batched device step (port
of yolo_deepsort_tpu/runtime/multistream.py).

One decode thread per video feeds the native C++ frame pool
(``runtime/native.py``); the consumer loop pops contiguous RGB batches and
drives the single-frame multi-stream step (``parallel/streams.py``
``make_batched_step``) with per-stream failure isolation: a stream that
stalls or ends freezes its tracker state while the rest proceed.

The tracker runs on the model's device (``api.Darknet(device=...)``: the
CUDA card unless the caller asked for the CPU). On the card the pool
assembles each batch directly in pinned host memory, the batch and its
validity flags go up without a wait, and outputs come back by one pinned
copy and an event wait per step, counted in ``host_readbacks``.

With ``global_ids`` the streams are cameras of one scene: every
``global_id_every`` steps the global-id step (``make_global_id_step`` on a
mesh of one rank) aliases tracks across streams, ``assign_provisional_gids``
runs between its rounds, and the outputs' id column carries the global ids,
relabeled on the device before the step's one readback.

A producer whose ring is full, and the loop when no frame is ready, wait on
the pool (``FramePool.push_wait``, ``wait_ready``) instead of retrying.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import weights as W
from ..api import _memory_format, _readback
from ..config import DetectorConfig, TrackerConfig
from ..parallel.streams import (
    assign_provisional_gids,
    init_global_ids,
    init_stream_states,
    make_batched_step,
    make_global_id_step,
    make_stream_mesh,
    relabel_outputs_global,
)
from .native import FramePool


class MultiStreamTracker:
    """Track multiple same-resolution videos concurrently on one device."""

    def __init__(
        self,
        model,  # api.Darknet
        video_paths: Sequence[str],
        reid_params,  # folded HWIO ReID param tree
        frame_hw: Tuple[int, int],
        tracker_config: Optional[TrackerConfig] = None,
        det_config: Optional[DetectorConfig] = None,
        tracked_class_ids=None,
        half: bool = True,
        ring_depth: int = 8,
        global_ids: bool = False,
        global_id_every: int = 4,
    ):
        self.model = model
        self.device = model.device
        self.paths = list(video_paths)
        self.s = len(self.paths)
        self.frame_hw = frame_hw
        self.trk_cfg = tracker_config or TrackerConfig()
        self.det_cfg = det_config or DetectorConfig(img_size=model.img_size)
        dtype = torch.bfloat16 if half else torch.float32
        on_card = self.device.type == "cuda"
        shape = (self.s, frame_hw[0], frame_hw[1], 3)
        # the pool writes each batch straight into the upload's staging
        # buffer; a step ends with its readback wait, so the buffer is free
        # again before the next pop overwrites it
        self._stage = torch.empty(shape, dtype=torch.uint8,
                                  pin_memory=on_card)
        self._valid_stage = torch.empty((self.s,), dtype=torch.bool,
                                        pin_memory=on_card)
        self._stage_np = self._stage.numpy()
        self.pool = FramePool(self.s, frame_hw[0], frame_hw[1],
                              depth=ring_depth)
        reid = W.reid_from_params(reid_params).to(
            self.device, dtype, memory_format=_memory_format(self.device))
        self.step = make_batched_step(
            model.module_for(dtype), reid, self.det_cfg, self.trk_cfg,
            frame_hw, tracked_class_ids=tracked_class_ids,
            with_validity=True)
        self.states = init_stream_states(self.trk_cfg, self.s, self.device)
        self.host_readbacks = 0
        # cross-CAMERA global identities: every ``global_id_every`` steps
        # tracks whose appearance matches across streams alias to one id
        # (min-adoption, convergent); the table stays on the device
        self.gid_state = None
        self._gid_every = max(1, global_id_every)
        if global_ids:
            mesh = make_stream_mesh(1, device=self.device)  # co-resident
            self._gid_step = make_global_id_step(mesh, self.trk_cfg,
                                                 n_streams_total=self.s)
            self.gid_state = init_global_ids(self.trk_cfg, self.s,
                                             self.device)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def _push(self, stream: int, frame_bgr: np.ndarray) -> bool:
        """Push one frame, waiting while the stream's ring is full. False
        once the loop has stopped: the producer then ends."""
        return self.pool.push_wait(stream, frame_bgr, self._stop)

    def _decoder(self, stream: int, path: str):
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if frame.shape[:2] != tuple(self.frame_hw):
                    frame = cv2.resize(frame, tuple(self.frame_hw)[::-1])
                if not self._push(stream, frame):
                    return
        finally:
            cap.release()
            self.pool.mark_finished(stream)

    def run(self, max_steps: Optional[int] = None):
        """Generator of (outputs (S, T, 5) int32, emit (S, T) bool,
        valid (S,) bool) per batched step."""
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._decoder, args=(i, p), daemon=True)
            for i, p in enumerate(self.paths)
        ]
        for t in self._threads:
            t.start()

        steps = 0
        try:
            while max_steps is None or steps < max_steps:
                _, valid, n = self.pool.pop_batch(out=self._stage_np)
                if n == 0:
                    if all(self.pool.finished(i) for i in range(self.s)):
                        break
                    self.pool.wait_ready()
                    continue
                self._valid_stage.copy_(torch.from_numpy(valid))
                frames = self._stage.to(self.device, non_blocking=True)
                frame_valid = self._valid_stage.to(self.device,
                                                   non_blocking=True)
                self.states, (outputs, emit) = self.step(
                    self.states, frames, frame_valid)
                if self.gid_state is not None:
                    if steps % self._gid_every == 0:
                        self.gid_state = self._gid_step(self.states,
                                                        self.gid_state)
                    else:  # fresh lanes still get ids between rounds
                        self.gid_state = assign_provisional_gids(
                            self.states.track_id, self.gid_state,
                            n_streams_total=self.s)
                    outputs = relabel_outputs_global(outputs, self.gid_state)
                packed = torch.cat(
                    [outputs, emit.to(outputs.dtype)[..., None]], -1)
                host = _readback(packed)
                self.host_readbacks += 1
                steps += 1
                yield (np.array(host[..., :5]), host[..., 5] > 0, valid)
        finally:
            self._stop.set()
            self.pool.wake()
            for t in self._threads:
                t.join(timeout=2.0)

    def stats(self) -> Dict[str, int]:
        return {
            "dropped": sum(self.pool.dropped(i) for i in range(self.s)),
        }

    def close(self):
        self.pool.close()
