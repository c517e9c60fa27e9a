"""Batch detection over a folder of images (port of
``examples/detect_folder.py``; the reference's detect.py / ImageFolder
flow).

    python3 -m yolo_deepsort_tpu_torch.examples.detect_folder IMAGE_DIR
        [--cfg config/yolov3.cfg] [--weights weights/yolov3.weights]
        [--out-dir output/] [--device cuda|cpu]
"""

import argparse
import os

import numpy as np

from ..api import Darknet, ImageDetector
from ..data.datasets import ImageFolder


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image_dir")
    p.add_argument("--cfg", default="yolov3")
    p.add_argument("--weights", default=None)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--conf-thres", type=float, default=0.5)
    p.add_argument("--nms-thres", type=float, default=0.4)
    p.add_argument("--out-dir", default="output")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    from PIL import Image

    model = Darknet(args.cfg, img_size=args.img_size, device=args.device)
    if args.weights:
        model.load_darknet_weights(args.weights)
    detector = ImageDetector(model, conf_thres=args.conf_thres,
                             nms_thres=args.nms_thres)

    folder = ImageFolder(args.image_dir, img_size=model.img_size)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in folder.files:
        img = np.asarray(Image.open(path).convert("RGB"))
        dets = detector.detect(img)
        out_path = os.path.join(args.out_dir, os.path.basename(path))
        Image.fromarray(detector.draw(img, dets)).save(out_path)
        print(f"{os.path.basename(path)}: {len(dets)} detections -> {out_path}")


if __name__ == "__main__":
    main()
