"""Multi-camera tracking with GLOBAL identities (port of
``examples/track_multicamera.py``).

Tracks several same-resolution videos concurrently through the batched
device step; the cross-camera aliasing step periodically matches
confirmed-track appearance galleries, so an object seen by several cameras
reports ONE global id. Decodes the clips with ``cv2``.

    python3 -m yolo_deepsort_tpu_torch.examples.track_multicamera
        cam0.mp4 cam1.mp4 [...] [--cfg yolov3]
        [--weights weights/yolov3.weights] [--reid-ckpt weights/ckpt.t7]
        [--height 1080] [--width 1920] [--device cuda|cpu]
"""

import argparse
import os
import sys

from ..api import Darknet
from ..config import TrackerConfig
from ..models.reid import load_reid_checkpoint, random_reid_params
from ..runtime.multistream import MultiStreamTracker


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("videos", nargs="+")
    p.add_argument("--cfg", default="yolov3")
    p.add_argument("--weights", default=None)
    p.add_argument("--reid-ckpt", default=None)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    model = Darknet(args.cfg, img_size=args.img_size, device=args.device)
    if args.weights:
        model.load_darknet_weights(args.weights)
    if args.reid_ckpt and os.path.exists(args.reid_ckpt):
        reid_params = load_reid_checkpoint(args.reid_ckpt)
    else:
        reid_params = random_reid_params(seed=0)

    mst = MultiStreamTracker(
        model,
        args.videos,
        reid_params,
        (args.height, args.width),
        tracker_config=TrackerConfig(),
        global_ids=True,
    )
    try:
        for step, (outputs, emit, valid) in enumerate(
            mst.run(max_steps=args.max_steps)
        ):
            for cam in range(len(args.videos)):
                rows = outputs[cam][emit[cam]]
                for x1, y1, x2, y2, gid in rows:
                    print(f"step {step} cam {cam}: global id {int(gid)} "
                          f"at [{int(x1)},{int(y1)},{int(x2)},{int(y2)}]")
            if step % 50 == 0:
                print(f"-- step {step}, drops: {mst.stats()['dropped']}",
                      file=sys.stderr)
    finally:
        mst.close()


if __name__ == "__main__":
    main()
