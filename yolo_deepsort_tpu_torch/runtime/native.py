"""ctypes binding of the native frame-ring runtime, ``native/frame_ring.cpp``
(the port's own copy of yolo_deepsort_tpu/runtime/native.py).

The shared library is built at first use with g++ into ``native/build/``
(git-ignored), under a name keyed by a hash of the source and the flags, so
a library built from another source or on another machine's flags is never
picked up. A build that fails raises: there is no quiet fallback.

Importing this module builds nothing; ``FramePool(...)`` does.

Waiting (the port's own, not the reference's): a producer that finds its
ring full waits in ``push_wait`` until a pop frees a slot, and a consumer
waits in ``wait_ready`` until a push or a finished stream gives it
something to do. Neither retries in a loop. The waits time out after
``WAIT_SECS`` only as a safety net, since every change notifies.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "frame_ring.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "native", "build")
# no -march=native: the library may be carried to another machine with the
# tree, and the ring's work is memcpy-bound
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

WAIT_SECS = 0.5  # longest wait on a condition; every change notifies


def library_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(repr(_FLAGS).encode())
    return os.path.join(_BUILD_DIR,
                        f"libframe_ring_port_{h.hexdigest()[:16]}.so")


def _load() -> ctypes.CDLL:
    """Build if needed, then load once per process; raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                subprocess.run(["g++"] + _FLAGS + [_SRC, "-o", tmp],
                               check=True, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError("native frame_ring: g++ not found") from e
            except subprocess.CalledProcessError as e:
                raise RuntimeError("native frame_ring: build failed:\n"
                                   + e.stderr) from e
            os.replace(tmp, path)  # atomic: a concurrent loader sees all
        lib = ctypes.CDLL(path)
        lib.fr_create.restype = ctypes.c_void_p
        lib.fr_create.argtypes = [ctypes.c_int] * 4
        lib.fr_destroy.argtypes = [ctypes.c_void_p]
        lib.fr_push.restype = ctypes.c_int
        lib.fr_push.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p]
        lib.fr_mark_finished.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fr_available.restype = ctypes.c_int
        lib.fr_available.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fr_finished.restype = ctypes.c_int
        lib.fr_finished.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fr_dropped.restype = ctypes.c_uint64
        lib.fr_dropped.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fr_pop_batch.restype = ctypes.c_int
        lib.fr_pop_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return _lib


class FramePool:
    """Multi-stream SPSC frame rings with fused BGR->RGB batch assembly.

    Producers (decode threads) call ``push(stream, frame_bgr)``; the compute
    loop calls ``pop_batch()`` to gather one contiguous (S, H, W, 3) RGB
    batch. The copy/swizzle runs in C++ off the GIL. ``pop_batch(out=)``
    lets the caller have the batch assembled in its own buffer (pinned
    memory, for the upload to the card)."""

    def __init__(self, n_streams: int, height: int, width: int,
                 depth: int = 8):
        lib = _load()
        self._lib = lib
        self.n_streams = n_streams
        self.shape = (height, width)
        self.depth = depth
        # one lock under which a ring's fullness or readiness is checked
        # and waited on, so a pop or push between the check and the wait is
        # never missed
        lock = threading.Lock()
        self._space = threading.Condition(lock)  # a pop freed slots
        self._ready = threading.Condition(lock)  # a push, or a stream ended
        self._pool = ctypes.c_void_p(
            lib.fr_create(n_streams, height, width, depth))
        self._batch = np.empty((n_streams, height, width, 3), np.uint8)
        self._valid = np.empty((n_streams,), np.uint8)

    def push(self, stream: int, frame_bgr: np.ndarray) -> bool:
        frame_bgr = np.ascontiguousarray(frame_bgr, dtype=np.uint8)
        if frame_bgr.shape != (*self.shape, 3):
            raise ValueError(f"frame {frame_bgr.shape}, pool {self.shape}")
        ok = self._lib.fr_push(
            self._pool, stream, frame_bgr.ctypes.data_as(ctypes.c_void_p))
        return bool(ok)

    def push_wait(self, stream: int, frame_bgr: np.ndarray,
                  stop: threading.Event) -> bool:
        """``push``, waiting while the ring is full. False when ``stop`` was
        set before the frame went in (``wake`` ends the wait at once)."""
        while not self.push(stream, frame_bgr):
            with self._space:
                if stop.is_set():
                    return False
                if self.available_frames(stream) >= self.depth:
                    self._space.wait(WAIT_SECS)
        with self._ready:
            self._ready.notify_all()
        return True

    def wait_ready(self, every: bool = False,
                   timeout: float = WAIT_SECS) -> bool:
        """Wait until every stream (``every``) or any stream has a frame,
        or, without ``every``, until every stream has finished; at most
        ``timeout`` seconds. -> whether that holds."""
        def ready():
            have = [self.available_frames(i) > 0
                    for i in range(self.n_streams)]
            if every:
                return all(have)
            return any(have) or all(self.finished(i)
                                    for i in range(self.n_streams))

        with self._ready:
            return self._ready.wait_for(ready, timeout)

    def wake(self) -> None:
        """Wake every waiting producer and consumer (after a stop)."""
        with self._space:
            self._space.notify_all()
            self._ready.notify_all()

    def mark_finished(self, stream: int) -> None:
        self._lib.fr_mark_finished(self._pool, stream)
        with self._ready:
            self._ready.notify_all()

    def available_frames(self, stream: int) -> int:
        return self._lib.fr_available(self._pool, stream)

    def finished(self, stream: int) -> bool:
        return bool(self._lib.fr_finished(self._pool, stream))

    def dropped(self, stream: int) -> int:
        return int(self._lib.fr_dropped(self._pool, stream))

    def _checked(self, out: np.ndarray) -> np.ndarray:
        want = (self.n_streams, *self.shape, 3)
        if (out.shape != want or out.dtype != np.uint8
                or not out.flags.c_contiguous):
            raise ValueError(f"a batch buffer must be a C-contiguous uint8 "
                             f"array of shape {want}")
        return out

    def pop_batch(self, consume: bool = True, out: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
        """-> (batch_rgb (S, H, W, 3), valid (S,) bool, n_valid), written
        into ``out`` (a C-contiguous uint8 array of that shape) when given,
        else into the pool's own buffer. Invalid stream slots keep their
        previous contents (mask them downstream). A consuming pop wakes the
        producers."""
        batch = self._batch if out is None else self._checked(out)
        n = self._lib.fr_pop_batch(
            self._pool, batch.ctypes.data_as(ctypes.c_void_p),
            self._valid.ctypes.data_as(ctypes.c_void_p), 1 if consume else 0)
        if n and consume:
            with self._space:
                self._space.notify_all()
        return batch, self._valid.astype(bool), int(n)

    def close(self) -> None:
        if self._pool:
            self._lib.fr_destroy(self._pool)
            self._pool = ctypes.c_void_p(0)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
