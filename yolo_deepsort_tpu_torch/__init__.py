"""yolo_deepsort_tpu_torch -- the PyTorch/CUDA port of yolo_deepsort_tpu.

The JAX package beside it (``yolo_deepsort_tpu``) is the reference; this
package mirrors its module paths (``api.py``, ``ops/``, ``models/``,
``tracking/``, ``parallel/streams.py``, ``utils/``, ``runtime/``) so each
module's counterpart is found by path. Plain tensor code is PyTorch; the
TPU kernels of the ported paths (letterbox, windowed ReID crops, the fused
tracker step, the JV cascade and two-stage solvers, the backbone conv in
bf16 and int8) are hand-written CUDA C++ for Hopper (``csrc/``), built with nvcc at first use
(``kernels/build.py``). Every kernel wrapper takes its plain PyTorch version
for CPU tensors only; for CUDA tensors it launches the kernel or raises.

Public API (the reference's surface, ``api.py``):
  - Darknet                       -- cfg-driven detector model
  - ImageDetector / VideoDetector -- detection wrappers
  - VideoTracker                  -- detection + tracking over video
  - DeepSort                      -- tracker facade: update(xywh, conf, img)
  - Extractor                     -- standalone ReID feature extractor
They run on the CUDA card unless ``device="cpu"`` is passed (``device.py``).
The multi-stream steps are in ``parallel/streams.py``
(``BucketedScannedStep``, ``make_batched_step``) and
``runtime/multistream.py`` (``MultiStreamTracker``).

This package imports neither jax nor the JAX package: the jax-free pieces
it shares with it (``config.py``, ``cfg/``, the darknet weight IO in
``weights.py``, ``utils/checkpoint.py``, ``runtime/video.py``) are copies,
held equal to the originals by the tests.
"""

__version__ = "0.1.0"


def __getattr__(name):  # lazy: importing the package loads no model code
    if name in ("DeepSort", "Darknet", "Extractor", "ImageDetector",
                "VideoDetector", "VideoTracker"):
        from . import api

        return getattr(api, name)
    if name in ("TrackerConfig", "DetectorConfig"):
        from . import config

        return getattr(config, name)
    raise AttributeError(name)
