"""The NMS kernels of ``csrc/nms.cu`` against their plain versions, and the
seeded adversarial cases both packages' tests share.

The cases (``nms_cases``, ``roi_cases``) are numpy arrays made from seeds;
``tests/test_torch_port_nms_kernel.py`` holds the plain versions to the JAX
package on them on the CPU, and the tests here marked ``gpu`` hold the
kernels to the plain versions on the card (skipped without one). This file
imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_nms_kernel_gpu.py

The tests not marked ``gpu`` check the routing on the CPU: CPU tensors take
the plain versions and launch nothing.

Tolerances (``nms_kernel.mismatch``): the keep set, its order, the mask,
the saturation counters and the obj / cls_conf / cls columns exactly equal
(the kernel computes each IoU in the plain version's expression and order,
with --fmad=false); the merged boxes within ``nms_kernel.MERGE_TOL`` (1e-5)
of the box scale, the largest |merged coordinate| (at least 1): the
weighted sums of up to ``max_boxes`` terms run in another order; NaN where
the plain version has NaN.
"""

import numpy as np
import pytest
import torch

from yolo_deepsort_tpu_torch.kernels import launches as KL
from yolo_deepsort_tpu_torch.ops import nms as N
from yolo_deepsort_tpu_torch.ops import nms_kernel


def _rows(rng, n, b, c, lo=0.0, hi=400.0, wh=(4.0, 40.0), obj=(0.0, 1.0),
          cls=(0.0, 1.0)):
    """(n, b, 5 + c) f32 rows: centres in [lo, hi), sizes in ``wh``."""
    return np.concatenate([
        rng.uniform(lo, hi, (n, b, 2)), rng.uniform(*wh, (n, b, 2)),
        rng.uniform(*obj, (n, b, 1)), rng.uniform(*cls, (n, b, c))],
        -1).astype(np.float32)


def nms_cases():
    """{name: (pred (N, B, 5 + C) f32, conf (float or (N,) f32), nms_thres,
    max_boxes, max_dets)}: small enough for the JAX package on the CPU."""
    cases = {}
    rng = np.random.default_rng(11)
    cases["random_per_image"] = (
        _rows(rng, 3, 300, 4, wh=(10.0, 60.0)),
        np.asarray([0.3, 0.5, 0.7], np.float32), 0.4, 512, 32)

    # exact score ties across the max_boxes boundary, n_valid > max_boxes:
    # 90 separated rows with one score, 30 others above and below it
    b = 150
    pred = np.zeros((2, b, 8), np.float32)
    pred[:, :, 0] = (np.arange(b) % 15) * 30.0 + 15.0
    pred[:, :, 1] = (np.arange(b) // 15) * 30.0 + 15.0
    pred[:, :, 2:4] = 12.0
    pred[:, :, 4] = 0.9
    pred[:, :, 5] = 0.5
    pred[:, :, 6:] = 0.25
    pred[:, ::5, 5] = rng.uniform(0.6, 0.9, (2, b // 5))  # above the tie
    pred[:, 2::5, 5] = rng.uniform(0.1, 0.4, (2, b // 5))  # below it
    pred[1, :, 0] += np.arange(b) * 0.01  # image 1: jittered, still apart
    cases["ties_across_topk"] = (pred, 0.5, 0.4, 64, 48)

    # class argmax ties (first index wins), overlapping rows of every class
    pred = _rows(rng, 2, 80, 3, lo=100.0, hi=140.0, wh=(30.0, 50.0),
                 obj=(0.6, 1.0), cls=(0.0, 0.5))
    pred[:, ::2, 5:7] = 0.75  # classes 0 and 1 tie
    pred[:, 1::4, 6:8] = 0.7  # classes 1 and 2 tie
    pred[:, 3::8, 5:8] = 0.8  # all three tie
    cases["class_argmax_ties"] = (pred, 0.5, 0.4, 512, 24)

    # one box suppresses all the others: near-copies of one box, one class
    pred = np.zeros((1, 40, 6), np.float32)
    pred[0, :, 0:2] = 200.0 + rng.uniform(-1, 1, (40, 2))
    pred[0, :, 2:4] = 80.0 + rng.uniform(-1, 1, (40, 2))
    pred[0, :, 4] = rng.uniform(0.6, 1.0, 40)
    pred[0, :, 5] = rng.uniform(0.5, 1.0, 40)
    cases["one_suppresses_all"] = (pred, 0.5, 0.4, 512, 8)

    # an image with nothing valid beside a saturated one (per-image
    # thresholds): top-k drops candidates and max_dets fills with some left
    pred = _rows(rng, 2, 400, 2, hi=800.0, wh=(4.0, 8.0), obj=(0.5, 1.0),
                 cls=(0.5, 1.0))
    cases["empty_beside_saturated"] = (
        pred, np.asarray([1.5, 0.55], np.float32), 0.4, 128, 16)

    # zero-area boxes: IoU with itself is 0, so the top never suppresses
    # itself and is emitted again every step (both packages)
    pred = _rows(rng, 1, 30, 2, obj=(0.6, 1.0), cls=(0.5, 1.0))
    pred[0, 3, 2] = 0.0
    cases["zero_area"] = (pred, 0.5, 0.4, 512, 10)

    # a non-finite box among the top k: its weight is 0, and 0 x inf = NaN
    # poisons that coordinate of every merge in both packages
    pred = _rows(rng, 2, 50, 2, obj=(0.0, 1.0))
    pred[1, 7, 2] = np.inf
    pred[1, 7, 4] = 0.1  # invalid (score -1) but inside the top k
    cases["inf_box_in_topk"] = (pred, 0.5, 0.4, 512, 12)
    return cases


def nan_case():
    """Six separated rows with positive scores and one whose class score is
    NaN (so is its score), ``max_boxes`` 4: the NaN row sorts first in
    both packages' descending order, takes a top-k slot, and is never
    alive, so three of the six are emitted."""
    pred = np.zeros((1, 7, 6), np.float32)
    pred[0, :, 0] = np.arange(7) * 50.0 + 25.0
    pred[0, :, 1] = 40.0
    pred[0, :, 2:4] = 20.0
    pred[0, :, 4] = 0.9
    pred[0, :, 5] = [0.9, 0.8, 0.7, np.nan, 0.6, 0.5, 0.4]
    return pred, 0.5, 0.4, 4, 8


def roi_cases():
    """{name: (boxes_tlwh (D, 4) f32, scores (D,), mask (D,) bool,
    max_overlap)}."""
    rng = np.random.default_rng(12)
    cases = {}
    d = 64
    xy = rng.uniform(0, 300, (d, 2))
    wh = rng.uniform(20, 90, (d, 2))
    scores = rng.uniform(0, 1, d).astype(np.float32)
    mask = rng.uniform(0, 1, d) < 0.8
    cases["random_d64"] = (np.concatenate([xy, wh], 1).astype(np.float32),
                           scores, mask, 0.5)
    # clusters of near-copies with tied scores (lower index first)
    base = rng.uniform(0, 300, (8, 4)) * [1, 1, 0.3, 0.3] + [0, 0, 20, 20]
    boxes = np.repeat(base, 6, 0) + rng.uniform(-2, 2, (48, 4))
    scores = np.repeat(rng.uniform(0, 1, 8), 6).astype(np.float32)
    scores[::7] = 0.5
    cases["tied_clusters"] = (boxes.astype(np.float32), scores,
                              np.ones(48, bool), 0.3)
    # NaN and infinite scores among masked boxes
    boxes, scores, mask, _ = cases["random_d64"]
    scores = scores.copy()
    scores[[3, 10]] = np.nan
    scores[5] = np.inf
    scores[6] = -np.inf
    cases["nan_inf_scores"] = (boxes, scores, mask, 0.5)
    return cases


def _torch_args(args, dev):
    pred, conf, *rest = args
    conf = conf if isinstance(conf, float) else torch.from_numpy(conf).to(dev)
    return (torch.from_numpy(pred).to(dev), conf, *rest)


def test_cpu_tensors_take_the_plain_versions():
    KL.zero_launches()
    for name, args in {**nms_cases(), "nan": nan_case()}.items():
        targs = _torch_args(args, "cpu")
        got = N.batched_nms_with_stats(*targs)
        want = N.batched_nms_with_stats_plain(*targs)
        for g, w in zip(got, want):
            assert torch.equal(g, w) or torch.allclose(g, w, equal_nan=True), \
                name
        dets, mask = N.batched_nms(*targs)
        assert torch.equal(mask, want[1]), name
    for name, (boxes, scores, mask, ov) in roi_cases().items():
        args = (torch.from_numpy(boxes), torch.from_numpy(scores),
                torch.from_numpy(mask), ov)
        assert torch.equal(N.roi_nms_mask(*args), N.roi_nms_mask_plain(*args))
    assert KL.read_launches()["nms"] == 0
    assert KL.read_launches()["roi_nms"] == 0
    assert set(KL.read_launches()) >= {"nms", "roi_nms"}


def test_kernel_wrappers_refuse_cpu_tensors():
    pred = torch.zeros((2, 30, 7))
    with pytest.raises(ValueError, match="CUDA"):
        nms_kernel.nms_cuda(pred, 0.5, 0.4, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        nms_kernel.roi_nms_cuda(torch.zeros((4, 4)), torch.zeros(4),
                                torch.ones(4, dtype=torch.bool), 0.5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the NMS kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _check_nms(dev, args, tag):
    targs = _torch_args(args, dev)
    before = nms_kernel.launches
    got = N.batched_nms_with_stats(*targs)
    assert nms_kernel.launches == before + 1
    want = N.batched_nms_with_stats_plain(*targs)
    why, _ = nms_kernel.mismatch(got, want)
    assert not why, f"{tag}: {why}"
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(nms_cases()))
def test_nms_kernel_vs_plain(cuda_device, name):
    _check_nms(cuda_device, nms_cases()[name], name)


@pytest.mark.gpu
def test_nms_kernel_nan_score(cuda_device):
    dets, mask, sat = _check_nms(cuda_device, nan_case(), "nan")
    assert mask.sum().item() == 3 and sat[0, 0].item() == 3


@pytest.mark.gpu
@pytest.mark.parametrize("n,b,c,max_dets", [
    (32, 10647, 80, 64),  # the main path: K=4 x 8 streams, yolov3-416
    (8, 10647, 80, 40),  # the K=1 step at cap 40
    (1, 22743, 80, 64),  # yolov3-608 / v4-608 on a facade
    (8, 2535, 80, 64),  # yolov3-tiny
])
def test_nms_kernel_vs_plain_at_served_shapes(cuda_device, n, b, c,
                                              max_dets):
    rng = np.random.default_rng(n + b)
    pred = _rows(rng, n, b, c, hi=416.0, wh=(8.0, 80.0), obj=(0.0, 1.0))
    pred[..., 4] **= 6  # a few hundred candidates an image over 0.5
    conf = rng.uniform(0.3, 0.6, n).astype(np.float32)
    _check_nms(cuda_device, (pred, conf, 0.4, 512, max_dets), f"{n}x{b}")
    _check_nms(cuda_device, (pred, 0.05, 0.4, 512, max_dets),
               f"{n}x{b} saturated")


@pytest.mark.gpu
def test_nms_kernel_refuses_more_candidates_than_a_block(cuda_device):
    pred = torch.zeros((1, 2048, 7), device=cuda_device)
    with pytest.raises(ValueError, match="one block"):
        N.batched_nms_with_stats(pred, 0.5, 0.4, 2048, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(roi_cases()))
def test_roi_nms_kernel_vs_plain(cuda_device, name):
    boxes, scores, mask, ov = roi_cases()[name]
    args = (torch.from_numpy(boxes).to(cuda_device),
            torch.from_numpy(scores).to(cuda_device),
            torch.from_numpy(mask).to(cuda_device), ov)
    before = nms_kernel.roi_launches
    got = N.roi_nms_mask(*args)
    assert nms_kernel.roi_launches == before + 1
    assert torch.equal(got.cpu(), N.roi_nms_mask_plain(*args).cpu())


@pytest.mark.gpu
def test_roi_nms_kernel_at_a_full_block(cuda_device):
    rng = np.random.default_rng(13)
    d = 1024
    boxes = np.concatenate([rng.uniform(0, 1000, (d, 2)),
                            rng.uniform(10, 120, (d, 2))], 1)
    args = (torch.from_numpy(boxes.astype(np.float32)).to(cuda_device),
            torch.from_numpy(rng.uniform(0, 1, d).astype(np.float32)).to(
                cuda_device),
            torch.from_numpy(rng.uniform(0, 1, d) < 0.9).to(cuda_device), 0.4)
    assert torch.equal(N.roi_nms_mask(*args).cpu(),
                       N.roi_nms_mask_plain(*args).cpu())
