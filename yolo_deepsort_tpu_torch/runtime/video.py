"""Host video IO: decode with background prefetch, encode, display (copy of
yolo_deepsort_tpu/runtime/video.py).

Decode runs in a daemon thread feeding a bounded queue, so the device does
not wait on the demuxer. ``cv2`` is imported inside each function: the
package imports without it, and only these host helpers need it."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


class VideoSource:
    """Iterator over BGR frames with a prefetch thread."""

    def __init__(self, path: str | int, prefetch: int = 8):
        import cv2

        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"cannot open video source {path!r}")
        self.fps = self._cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.size = (
            int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        )
        self.frame_count = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _reader(self):
        while not self._stop.is_set():
            ok, frame = self._cap.read()
            if not ok:
                break
            self._q.put(frame)
        self._q.put(None)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self._q.get()
            if frame is None:
                return
            yield frame

    def release(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
        self._cap.release()


class VideoWriter:
    """mp4v writer (reference uses cv2.VideoWriter with mp4v)."""

    def __init__(self, path: str, fps: float, size: Tuple[int, int]):
        import cv2

        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        self._writer = cv2.VideoWriter(path, fourcc, fps, size)

    def write(self, frame_bgr: np.ndarray):
        self._writer.write(frame_bgr)

    def release(self):
        self._writer.release()


def show_frame(frame_bgr: np.ndarray, window: str = "yolo_deepsort_tpu"):
    import cv2

    cv2.imshow(window, frame_bgr)
    cv2.waitKey(1)
