"""Time ``MultiStreamTracker`` fed by its own cv2 decoders with full frame
rings and with rings that hold every frame, in this checkout or in another
one.

    python3 yolo_deepsort_tpu_torch/tools/ring_clocks.py CLIP [CLIP ...]
        [--root DIR] [--depths 8 23 23 8]

One stream a clip (all of one size), yolov3-416 in bfloat16 on the card,
with well-conditioned seeded weights (``specs/weights_np.py``) loaded
through the facade from a ``.weights`` file and the objectness threshold
that lets TARGET_DETS candidates of the first clip's first frame
through. For each ring depth of ``--depths``, in order, the tracker runs
every clip to its end: the host-clock ms of each step after the first
WARM_STEPS (the median kept), the frames each stream delivered, the steps
and the full-ring rejections (``stats()["dropped"]``: each failed push of a
producer whose ring was full). A depth below the clips' length fills the
rings once the decoders outrun the steps; a depth of at least that length
holds every frame.

``--root`` imports the package from another checkout -- an earlier commit
unpacked beside this one -- so that two versions of the rings' producers
and consumer are timed on one card by one script, called in turns. Run it
as a file, as above (with ``-m`` Python would import this checkout's
package before ``--root`` is read). Needs the card. Prints one JSON line,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

TARGET_DETS = 32  # the smoke's calibration target
WARM_STEPS = 3  # first steps of each run left out of the times


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("clips", nargs="+")
    ap.add_argument("--root", default=None,
                    help="the checkout whose package is timed (default: "
                         "this one)")
    ap.add_argument("--depths", type=int, nargs="+", default=[8, 23, 23, 8])
    args = ap.parse_args(argv)
    root = Path(args.root).resolve() if args.root else \
        Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))

    import cv2
    import torch

    from specs.weights_np import random_darknet_weights
    from yolo_deepsort_tpu_torch import api
    from yolo_deepsort_tpu_torch.config import DetectorConfig
    from yolo_deepsort_tpu_torch.models.reid import random_reid_params
    from yolo_deepsort_tpu_torch.ops.letterbox import letterbox_batch
    from yolo_deepsort_tpu_torch.runtime.multistream import MultiStreamTracker

    if not torch.cuda.is_available():
        raise SystemExit("ring_clocks: needs the card")
    dev = torch.device("cuda")
    cap = cv2.VideoCapture(args.clips[0])
    ok, first = cap.read()
    cap.release()
    if not ok:
        raise SystemExit(f"ring_clocks: cannot decode {args.clips[0]}")
    hw = first.shape[:2]

    model = api.Darknet("yolov3", img_size=416, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "yolov3-416.weights")
        with open(path, "wb") as f:
            f.write(random_darknet_weights(model.plan.defs(), seed=0,
                                           well_conditioned=True))
        model.load_darknet_weights(path)
    with torch.no_grad():
        rgb = torch.from_numpy(np.ascontiguousarray(first[None, :, :, ::-1]))
        x = letterbox_batch(rgb.to(dev), 416).to(torch.bfloat16)
        obj = model.module_for(torch.bfloat16)(x)[0, :, 4].float()
    thr = float(torch.sort(obj, descending=True).values[TARGET_DETS - 1])

    runs = []
    for depth in args.depths:
        mst = MultiStreamTracker(
            model, args.clips, random_reid_params(0), hw,
            det_config=DetectorConfig(img_size=416, conf_thres=thr),
            ring_depth=depth)
        seen = np.zeros(len(args.clips), int)
        times, steps, last = [], 0, time.perf_counter()
        for _, _, valid in mst.run():
            now = time.perf_counter()
            if steps >= WARM_STEPS:
                times.append((now - last) * 1e3)
            last = now
            seen += valid
            steps += 1
        dropped = mst.stats()["dropped"]
        mst.close()
        runs.append({"ring_depth": depth, "steps": steps,
                     "ms_per_step_median": float(np.median(times)),
                     "frames_per_stream": seen.tolist(),
                     "full_ring_rejections": dropped})
    rec = {"root": str(root), "card": card_line(),
           "device": torch.cuda.get_device_name(dev),
           "streams": len(args.clips), "frame_hw": list(hw),
           "threshold": thr, "runs": runs}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
