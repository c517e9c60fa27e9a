"""Detection datasets: inference-folder globbing and darknet-label training
batches.

Contract: SURVEY.md section 2.3 "Datasets / letterbox" (reference:
yolo3/dataset/datasets.py:~1-160): ``ImageFolder`` globs a directory of
images for batch inference; ``ListDataset`` reads a list file of image paths
whose labels live in parallel ``labels/*.txt`` files with normalized
``cls cx cy w h`` rows (Appendix G), applies letterbox + horizontal-flip
augmentation, and supports multiscale training (re-choose input size in
320..608 step 32 every 10 batches).

Host-side numpy (PIL decode); batches are padded fixed-shape arrays ready
for the train step -- the reference's ragged collate_fn becomes a
(B, MAX_TARGETS, 6) masked tensor.

The port's own copy of yolo_deepsort_tpu/data/datasets.py (the port
imports nothing of the JAX package), held equal to it batch for batch by
tests/test_torch_port_data.py. PIL is imported where an image is decoded,
not with the module.
"""

from __future__ import annotations

import glob
import os
import random
from typing import Iterator, Tuple

import numpy as np

from .letterbox_np import letterbox as letterbox_np


def load_rgb(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB, a writable array."""
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im.convert("RGB"), np.uint8)


class ImageFolder:
    """Iterate (path, letterboxed image) over all images in a folder
    (reference ImageFolder, inference use)."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, folder_path: str, img_size: int = 416):
        self.files = sorted(
            f
            for f in glob.glob(os.path.join(folder_path, "*.*"))
            if f.lower().endswith(self.EXTS)
        )
        self.img_size = img_size

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> Tuple[str, np.ndarray]:
        path = self.files[index % len(self.files)]
        img = load_rgb(path)
        return path, letterbox_np(img, self.img_size).astype(np.float32)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class ListDataset:
    """Training dataset over a list file of image paths with darknet labels.

    Labels for ``images/xxx.jpg`` are read from ``labels/xxx.txt`` (the
    reference's path-replacement convention), rows ``cls cx cy w h``
    normalized to the ORIGINAL image; they are re-normalized to the padded
    square so they stay correct after letterboxing.
    """

    def __init__(
        self,
        list_path: str,
        img_size: int = 416,
        augment: bool = True,
        multiscale: bool = True,
        max_targets: int = 64,
        seed: int = 0,
        mosaic: bool = False,
    ):
        with open(list_path, "r", encoding="utf-8") as f:
            self.img_files = [l.strip() for l in f if l.strip()]
        self.label_files = [
            p.replace("images", "labels")
            .replace(".png", ".txt")
            .replace(".jpg", ".txt")
            .replace(".jpeg", ".txt")
            for p in self.img_files
        ]
        self.img_size = img_size
        self.min_size = img_size - 3 * 32
        self.max_size = img_size + 3 * 32
        self.augment = augment
        self.multiscale = multiscale
        self.max_targets = max_targets
        self.mosaic = mosaic
        self.batch_count = 0
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.img_files)

    def load_sample(self, index: int, size: int):
        img = load_rgb(self.img_files[index % len(self)])
        h, w = img.shape[:2]
        side = max(h, w)
        d = abs(h - w)
        p1 = d // 2
        pad_top = p1 if h <= w else 0
        pad_left = 0 if h <= w else p1

        boxes = np.zeros((0, 5), np.float64)
        label_path = self.label_files[index % len(self)]
        if os.path.exists(label_path) and os.path.getsize(label_path):
            raw = np.loadtxt(label_path, ndmin=2)
            if raw.size:
                boxes = raw.reshape(-1, 5).astype(np.float64)

        # re-normalize boxes from original-image space to the padded square
        if len(boxes):
            cx = (boxes[:, 1] * w + pad_left) / side
            cy = (boxes[:, 2] * h + pad_top) / side
            bw = boxes[:, 3] * w / side
            bh = boxes[:, 4] * h / side
            boxes = np.stack([boxes[:, 0], cx, cy, bw, bh], axis=1)

        x = letterbox_np(img, size).astype(np.float32)

        if self.augment and self._rng.random() < 0.5:
            x = np.ascontiguousarray(x[:, ::-1])
            if len(boxes):
                boxes[:, 1] = 1.0 - boxes[:, 1]
        return x, boxes

    def load_mosaic(self, index: int, size: int):
        """YOLOv4-style 4-image mosaic (not in the reference lineage's
        training path; opt-in via --mosaic): place this sample + 3 random
        ones into the quadrants of a 2x canvas around a random center,
        clip labels to their visible regions, then 2x-downscale back to
        ``size``. Boxes are returned in the same normalized convention as
        load_sample."""
        s = size
        xc = self._rng.randint(s // 2, 3 * s // 2)
        yc = self._rng.randint(s // 2, 3 * s // 2)
        idxs = [index] + [self._rng.randrange(len(self)) for _ in range(3)]
        canvas = np.zeros((2 * s, 2 * s, 3), np.float32)
        rows = []
        for i, idx in enumerate(idxs):
            x, boxes = self.load_sample(idx, s)
            if i == 0:
                x1a, y1a, x2a, y2a = max(xc - s, 0), max(yc - s, 0), xc, yc
            elif i == 1:
                x1a, y1a, x2a, y2a = xc, max(yc - s, 0), min(xc + s, 2 * s), yc
            elif i == 2:
                x1a, y1a, x2a, y2a = max(xc - s, 0), yc, xc, min(yc + s, 2 * s)
            else:
                x1a, y1a, x2a, y2a = (xc, yc, min(xc + s, 2 * s),
                                      min(yc + s, 2 * s))
            w_, h_ = x2a - x1a, y2a - y1a
            if w_ <= 0 or h_ <= 0:
                continue
            x1b = s - w_ if i in (0, 2) else 0
            y1b = s - h_ if i in (0, 1) else 0
            canvas[y1a:y2a, x1a:x2a] = x[y1b:y1b + h_, x1b:x1b + w_]
            if len(boxes):
                cx = boxes[:, 1] * s + (x1a - x1b)
                cy = boxes[:, 2] * s + (y1a - y1b)
                bw = boxes[:, 3] * s
                bh = boxes[:, 4] * s
                xx1 = np.clip(cx - bw / 2, x1a, x2a)
                yy1 = np.clip(cy - bh / 2, y1a, y2a)
                xx2 = np.clip(cx + bw / 2, x1a, x2a)
                yy2 = np.clip(cy + bh / 2, y1a, y2a)
                keep = (xx2 - xx1 > 2) & (yy2 - yy1 > 2)
                for c_, a, b, c2, d in zip(boxes[keep, 0], xx1[keep],
                                           yy1[keep], xx2[keep], yy2[keep]):
                    rows.append([c_, (a + c2) / 2 / (2 * s),
                                 (b + d) / 2 / (2 * s),
                                 (c2 - a) / (2 * s), (d - b) / (2 * s)])
        # 2x box downscale: average-pool the canvas back to (s, s)
        out = canvas.reshape(s, 2, s, 2, 3).mean(axis=(1, 3))
        return out.astype(np.float32), np.asarray(rows, np.float64).reshape(
            -1, 5)

    def batches(
        self, batch_size: int, shuffle: bool = True
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
        """Yield (images (B,S,S,3) f32, targets (B*max?, 6), mask, size).

        Targets are (max_targets, 6) rows [batch_idx, cls, cx, cy, w, h]
        over the whole batch + a bool mask, the shape the masked yolo_loss
        consumes. Size re-rolls every 10 batches when multiscale.
        """
        order = list(range(len(self)))
        if shuffle:
            self._rng.shuffle(order)
        size = self.img_size
        for b0 in range(0, len(order) - batch_size + 1, batch_size):
            if self.multiscale and self.batch_count % 10 == 0:
                size = self._rng.randrange(self.min_size, self.max_size + 1, 32)
            imgs, tgt_rows = [], []
            for bi, idx in enumerate(order[b0 : b0 + batch_size]):
                x, boxes = (self.load_mosaic(idx, size) if self.mosaic
                            else self.load_sample(idx, size))
                imgs.append(x)
                for row in boxes:
                    tgt_rows.append([bi, *row])
            n_pad = self.max_targets
            targets = np.zeros((n_pad, 6), np.float32)
            mask = np.zeros((n_pad,), bool)
            n = min(len(tgt_rows), n_pad)
            if n:
                targets[:n] = np.asarray(tgt_rows[:n], np.float32)
                mask[:n] = True
            self.batch_count += 1
            yield np.stack(imgs), targets, mask, size
