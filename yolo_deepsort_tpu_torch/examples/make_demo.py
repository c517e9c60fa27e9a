"""Synthesize a demo clip: moving objects tracked by the DeepSORT facade,
ids drawn on every frame (port of ``examples/make_demo.py``). Writes the
clip with ``cv2``.

    python3 -m yolo_deepsort_tpu_torch.examples.make_demo
        [--out data/samples/synthetic_demo.mp4] [--frames 120]
        [--width 640] [--height 360] [--device cuda|cpu]
"""

import argparse
import os

import numpy as np

from ..api import DeepSort, draw_tracks


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="data/samples/synthetic_demo.mp4")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--objects", type=int, default=5)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    from ..runtime.video import VideoWriter

    rng = np.random.default_rng(0)
    h, w, n = args.height, args.width, args.objects
    colors = rng.integers(60, 255, (n, 3))
    # object sizes scale down with the frame so tiny demo frames stay valid
    max_bw = max(8, min(44, w // 6))
    max_bh = max(12, min(90, h // 3))
    size = rng.uniform([max_bw * 0.6, max_bh * 0.6], [max_bw, max_bh], (n, 2))
    pos = rng.uniform(
        [40, 40],
        [max(41, w - 40 - max_bw), max(41, h - 40 - max_bh)],
        (n, 2),
    )
    vel = rng.uniform(-3, 3, (n, 2))

    ds = DeepSort(max_dets=16, device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    wri = VideoWriter(args.out, 20.0, (w, h))
    for t in range(args.frames):
        frame = np.full((h, w, 3), 28, np.uint8)
        dets, confs = [], []
        for k in range(n):
            pos[k] += vel[k]
            for d in range(2):  # bounce off the borders
                lim = (w, h)[d]
                if not (20 < pos[k, d] < lim - 20 - size[k, d]):
                    vel[k, d] *= -1
            x, y = pos[k].astype(int)
            bw, bh = size[k].astype(int)
            frame[max(y, 0):y + bh, max(x, 0):x + bw] = colors[k]
            if t % 37 != 13 + k:  # occasional detector miss
                dets.append([x + bw / 2, y + bh / 2, bw, bh])
                confs.append(0.9)
        out = ds.update(np.asarray(dets, np.float32).reshape(-1, 4),
                        confs, frame)
        annotated = draw_tracks(frame, out)
        wri.write(np.ascontiguousarray(annotated[:, :, ::-1]))
    wri.release()
    print(f"demo clip -> {args.out} ({args.frames} frames, {n} objects)")


if __name__ == "__main__":
    main()
