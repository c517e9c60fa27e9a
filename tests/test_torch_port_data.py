"""The port's copies of the JAX package's host-side data modules
(``data/letterbox_np.py``, ``data/datasets.py``) held equal to the
originals: the same functions on seeded inputs give equal arrays, and the
datasets give equal batches from the same seed over one generated image
folder -- flip, multiscale, mosaic and label renormalization included."""

import numpy as np
import pytest

from yolo_deepsort_tpu.data import datasets as JD
from yolo_deepsort_tpu.data import letterbox_np as JL
from yolo_deepsort_tpu_torch.data import datasets as TD
from yolo_deepsort_tpu_torch.data import letterbox_np as TL
from torch_port_threads import torch_threads  # noqa: F401


@pytest.mark.parametrize("hw", [(40, 64), (64, 40), (33, 33)])
def test_letterbox_np_copy_equals_the_original(hw):
    rng = np.random.default_rng(sum(hw))
    img = rng.integers(0, 256, hw + (3,), np.uint8)
    for interp in ("bilinear", "nearest"):
        np.testing.assert_array_equal(TL.letterbox(img, 32, interp),
                                      JL.letterbox(img, 32, interp))
    a, pa = TL.pad_to_square(img, 0.5)
    b, pb = JL.pad_to_square(img, 0.5)
    np.testing.assert_array_equal(a, b)
    assert pa == pb
    boxes = rng.uniform(0, 32, (5, 4))
    np.testing.assert_array_equal(TL.rescale_boxes(boxes, 32, hw),
                                  JL.rescale_boxes(boxes, 32, hw))
    np.testing.assert_array_equal(TL.reid_preprocess_crop(img),
                                  JL.reid_preprocess_crop(img))
    np.testing.assert_array_equal(TL.resize_bilinear(img, 17, 9),
                                  JL.resize_bilinear(img, 17, 9))


def _image_list(root, n=6):
    from PIL import Image

    img_dir, lbl_dir = root / "images", root / "labels"
    img_dir.mkdir()
    lbl_dir.mkdir()
    rng = np.random.default_rng(3)
    paths = []
    for i in range(n):
        h, w = (48, 80) if i % 2 else (72, 40)
        p = img_dir / f"im{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(p)
        rows = [" ".join([str(i % 3)] + [
            f"{v:.4f}" for v in (*rng.uniform(0.2, 0.8, 2),
                                 *rng.uniform(0.1, 0.4, 2))])
            for _ in range(i % 3)]
        (lbl_dir / f"im{i}.txt").write_text("\n".join(rows))
        paths.append(str(p))
    lst = root / "train.txt"
    lst.write_text("\n".join(paths))
    return lst, img_dir


@pytest.mark.parametrize("mosaic", [False, True], ids=["plain", "mosaic"])
def test_list_dataset_copy_gives_the_same_batches(tmp_path, mosaic):
    """Two epochs of batches of 2 with flip augmentation and multiscale
    from seed 5: images, targets, masks and sizes equal."""
    lst, _ = _image_list(tmp_path)
    kw = dict(img_size=64, augment=True, multiscale=True, max_targets=8,
              seed=5, mosaic=mosaic)
    a, b = TD.ListDataset(str(lst), **kw), JD.ListDataset(str(lst), **kw)
    assert a.label_files == b.label_files
    n = 0
    for _ in range(2):
        for got, want in zip(a.batches(2), b.batches(2)):
            for x, y in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(x, y)
            assert got[3] == want[3]
            n += 1
    assert n == 6


def test_image_folder_copy_equals_the_original(tmp_path):
    _, img_dir = _image_list(tmp_path, n=3)
    a, b = TD.ImageFolder(str(img_dir), 32), JD.ImageFolder(str(img_dir), 32)
    assert len(a) == len(b) == 3
    for (pa, xa), (pb, xb) in zip(a, b):
        assert pa == pb
        np.testing.assert_array_equal(xa, xb)
