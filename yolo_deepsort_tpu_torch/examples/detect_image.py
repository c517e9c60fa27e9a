"""Single-image detection (port of ``examples/detect_image.py``; the
reference README's ImageDetector usage).

    python3 -m yolo_deepsort_tpu_torch.examples.detect_image IMAGE
        [--cfg config/yolov3.cfg] [--weights weights/yolov3.weights]
        [--out out.jpg] [--device cuda|cpu]
"""

import argparse

import numpy as np

from ..api import Darknet, ImageDetector


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image")
    p.add_argument("--cfg", default="yolov3")
    p.add_argument("--weights", default=None)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--conf-thres", type=float, default=0.5)
    p.add_argument("--nms-thres", type=float, default=0.4)
    p.add_argument("--out", default="detections.jpg")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    from PIL import Image

    model = Darknet(args.cfg, img_size=args.img_size, device=args.device)
    if args.weights:
        model.load_darknet_weights(args.weights)
    detector = ImageDetector(model, conf_thres=args.conf_thres,
                             nms_thres=args.nms_thres)

    img = np.asarray(Image.open(args.image).convert("RGB"))
    dets = detector.detect(img)
    for x1, y1, x2, y2, obj, cls_conf, cls in dets:
        name = detector.class_names[int(cls)]
        print(f"{name:>16} {obj:.2f}  [{x1:.0f}, {y1:.0f}, {x2:.0f}, {y2:.0f}]")
    Image.fromarray(detector.draw(img, dets)).save(args.out)
    print(f"{len(dets)} detections -> {args.out}")


if __name__ == "__main__":
    main()
