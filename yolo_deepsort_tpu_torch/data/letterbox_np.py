"""Numpy letterbox preprocessing and box rescaling (host-side): the
port's own copy of yolo_deepsort_tpu/data/letterbox_np.py, held equal to it
by tests/test_torch_port_data.py.

Used by the dataset pipeline (data/datasets.py).

Contract: SURVEY.md Appendix F (reference: yolo3/dataset/datasets.py:~15-35
pad_to_square/resize; yolo3/utils/utils.py:~45 rescale_boxes; ReID crop
preprocessing in deep_sort/deep/feature_extractor.py:~20-45).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# ImageNet normalization used by the ReID extractor (feature_extractor.py:~25).
REID_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float64)
REID_STD = np.array([0.229, 0.224, 0.225], dtype=np.float64)
REID_HW = (128, 64)  # (height, width) of ReID crops


def pad_to_square(img: np.ndarray, pad_value: float = 0.0):
    """Pad an HWC image to square. Short side gets (d//2, d - d//2).

    Returns (padded_img, pad) where pad = (top, bottom, left, right).
    """
    h, w = img.shape[:2]
    d = abs(h - w)
    p1, p2 = d // 2, d - d // 2
    if h <= w:
        pad = (p1, p2, 0, 0)
    else:
        pad = (0, 0, p1, p2)
    padded = np.pad(
        img,
        ((pad[0], pad[1]), (pad[2], pad[3]), (0, 0)),
        mode="constant",
        constant_values=pad_value,
    )
    return padded, pad


def resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbor resize of a square HWC image to (size, size).

    Index mapping matches torch ``F.interpolate(mode='nearest')``:
    src = floor(dst * scale).
    """
    h, w = img.shape[:2]
    ys = np.minimum((np.arange(size) * (h / size)).astype(np.int64), h - 1)
    xs = np.minimum((np.arange(size) * (w / size)).astype(np.int64), w - 1)
    return img[ys][:, xs]


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize (align_corners=False / half-pixel centers), HWC float."""
    img = np.asarray(img, dtype=np.float64)
    h, w = img.shape[:2]
    ys = (np.arange(out_h) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w) + 0.5) * (w / out_w) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def letterbox(
    img_rgb_uint8: np.ndarray, size: int, interp: str = "bilinear"
) -> np.ndarray:
    """Full YOLO input preprocessing: /255 -> pad_to_square(0) -> resize.

    Returns (size, size, 3) float64 in [0, 1]. The reference pads then resizes
    (datasets.py pad_to_square + resize); interp='nearest' reproduces the
    upstream F.interpolate default, 'bilinear' is the SURVEY App. F contract.
    """
    img = np.asarray(img_rgb_uint8, dtype=np.float64) / 255.0
    padded, _ = pad_to_square(img, 0.0)
    if interp == "nearest":
        return resize_nearest(padded, size)
    return resize_bilinear(padded, size, size)


def rescale_boxes(
    boxes: np.ndarray, current_dim: int, original_shape: Tuple[int, int]
) -> np.ndarray:
    """Map (x1,y1,x2,y2) boxes from letterboxed network space back to the
    original image (utils.py:~45). Uses floor(pad/2) like the reference's
    ``pad_x // 2``."""
    orig_h, orig_w = original_shape
    boxes = np.array(boxes, dtype=np.float64, copy=True)
    pad_x = max(orig_h - orig_w, 0) * (current_dim / max(original_shape))
    pad_y = max(orig_w - orig_h, 0) * (current_dim / max(original_shape))
    unpad_h = current_dim - pad_y
    unpad_w = current_dim - pad_x
    boxes[:, 0] = ((boxes[:, 0] - pad_x // 2) / unpad_w) * orig_w
    boxes[:, 1] = ((boxes[:, 1] - pad_y // 2) / unpad_h) * orig_h
    boxes[:, 2] = ((boxes[:, 2] - pad_x // 2) / unpad_w) * orig_w
    boxes[:, 3] = ((boxes[:, 3] - pad_y // 2) / unpad_h) * orig_h
    return boxes


def reid_preprocess_crop(crop_rgb_uint8: np.ndarray) -> np.ndarray:
    """One ReID crop -> (128, 64, 3) float, /255 then ImageNet-normalized
    (feature_extractor.py:~20-45). Bilinear resize (cv2.resize default)."""
    img = np.asarray(crop_rgb_uint8, dtype=np.float64) / 255.0
    resized = resize_bilinear(img, REID_HW[0], REID_HW[1])
    return (resized - REID_MEAN) / REID_STD
