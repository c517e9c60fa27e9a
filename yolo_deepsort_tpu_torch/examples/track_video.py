"""Video tracking (port of ``examples/track_video.py``; the reference
README's VideoTracker usage). Reads and writes clips with ``cv2``.

    python3 -m yolo_deepsort_tpu_torch.examples.track_video VIDEO
        [--cfg config/yolov3.cfg] [--weights weights/yolov3.weights]
        [--reid weights/ckpt.t7] [--out tracked.mp4] [--classes person car]
        [--device cuda|cpu]
"""

import argparse

from ..api import Darknet, VideoTracker


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("video")
    p.add_argument("--cfg", default="yolov3")
    p.add_argument("--weights", default=None)
    p.add_argument("--reid", default=None)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--conf-thres", type=float, default=0.5)
    p.add_argument("--classes", nargs="*", default=["person"])
    p.add_argument("--out", default="tracked.mp4")
    p.add_argument("--show", action="store_true")
    p.add_argument("--half", action="store_true", help="bfloat16 compute")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    model = Darknet(args.cfg, img_size=args.img_size, device=args.device)
    if args.weights:
        model.load_darknet_weights(args.weights)
    tracker = VideoTracker(
        model,
        reid_model_path=args.reid,
        tracked_classes=args.classes or None,
        conf_thres=args.conf_thres,
        half=args.half,
    )

    n = 0
    for frame, tracks in tracker.track(args.video, output_path=args.out,
                                       real_show=args.show):
        n += 1
        if n % 50 == 0:
            print(f"frame {n}: {len(tracks)} tracks")
    print(f"{n} frames -> {args.out}")


if __name__ == "__main__":
    main()
