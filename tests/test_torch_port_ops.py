"""The PyTorch port's tensor ops against the JAX package, on the same numpy
inputs at float32: boxes, decode, letterbox + rescale, NMS (incl. score
ties), crops (dense and windowed), Kalman filter."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from yolo_deepsort_tpu.ops import boxes as JB
from yolo_deepsort_tpu.ops import crops as JC
from yolo_deepsort_tpu.ops.decode import yolo_decode as j_decode
from yolo_deepsort_tpu.ops.letterbox import letterbox as j_letterbox
from yolo_deepsort_tpu.ops.letterbox import rescale_boxes as j_rescale
from yolo_deepsort_tpu.ops.nms import batched_nms_with_stats as j_nms
from yolo_deepsort_tpu.tracking import kalman as JK
from yolo_deepsort_tpu_torch.ops import boxes as TB
from yolo_deepsort_tpu_torch.ops import crops as TC
from yolo_deepsort_tpu_torch.ops.decode import yolo_decode as t_decode
from yolo_deepsort_tpu_torch.ops.letterbox import letterbox_batch, rescale_boxes
from yolo_deepsort_tpu_torch.ops.nms import batched_nms_with_stats as t_nms
from yolo_deepsort_tpu_torch.tracking import kalman as TK
from torch_port_threads import torch_threads  # noqa: F401

ATOL = 1e-5  # float32 elementwise math in two frameworks


def _boxes(rng, n, lo=0.0, hi=100.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(1.0, 40.0, (n, 2))
    return np.concatenate([xy, wh], 1).astype(np.float32)


@pytest.mark.parametrize("name", ["xywh_to_xyxy", "tlwh_to_xyah",
                                  "xyah_to_tlwh", "tlwh_to_xyxy"])
def test_box_conversions(name):
    b = _boxes(np.random.default_rng(0), 16)
    b[3] = 0.0  # padded all-zero row: guarded aspect
    want = np.asarray(getattr(JB, name)(jnp.asarray(b)))
    got = getattr(TB, name)(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)


def test_iou_matrices():
    rng = np.random.default_rng(1)
    a, b = _boxes(rng, 7), _boxes(rng, 9)
    a[0, 2:] = 0.0  # zero-area row
    np.testing.assert_allclose(
        TB.iou_tlwh(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(JB.iou_tlwh(jnp.asarray(a), jnp.asarray(b))), atol=ATOL)
    ax = np.array(JB.tlwh_to_xyxy(jnp.asarray(a)))
    bx = np.array(JB.tlwh_to_xyxy(jnp.asarray(b)))
    np.testing.assert_allclose(
        TB.iou_xyxy(torch.from_numpy(ax), torch.from_numpy(bx)).numpy(),
        np.asarray(JB.iou_xyxy(jnp.asarray(ax), jnp.asarray(bx))), atol=ATOL)


@pytest.mark.parametrize("scale_x_y", [1.0, 1.05])
def test_yolo_decode(scale_x_y):
    rng = np.random.default_rng(2)
    anchors = ((10.0, 13.0), (16.0, 30.0), (33.0, 23.0))
    raw = rng.normal(0, 1, (2, 4, 4, 3 * 7)).astype(np.float32)
    want = np.asarray(j_decode(jnp.asarray(raw), anchors, 2, 64, scale_x_y))
    got = t_decode(torch.from_numpy(raw), anchors, 2, 64, scale_x_y).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("hw,size", [((48, 64), 32), ((64, 48), 32),
                                     ((36, 64), 40), ((30, 30), 64)])
def test_letterbox_bilinear(hw, size):
    img = np.random.default_rng(3).integers(0, 256, (2, *hw, 3), np.uint8)
    want = np.stack([np.asarray(j_letterbox(jnp.asarray(f), size))
                     for f in img])
    got = letterbox_batch(torch.from_numpy(img), size).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("hw", [(1080, 1920), (1920, 1080), (64, 64)])
def test_rescale_boxes(hw):
    b = np.random.default_rng(4).uniform(0, 416, (5, 4)).astype(np.float32)
    want = np.asarray(j_rescale(jnp.asarray(b), 416, *hw))
    got = rescale_boxes(torch.from_numpy(b), 416, *hw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def _compare_nms(pred, conf, nms_thres=0.4, max_boxes=512, max_dets=8):
    jd, jm, js = (np.asarray(a) for a in j_nms(
        jnp.asarray(pred), conf, nms_thres, max_boxes, max_dets))
    td, tm, ts = (a.numpy() for a in t_nms(
        torch.from_numpy(pred), conf, nms_thres, max_boxes, max_dets))
    np.testing.assert_array_equal(tm, jm)  # keep set and its order
    np.testing.assert_array_equal(ts, js)  # saturation counters
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-4)


def test_nms_random_per_image_thresholds():
    rng = np.random.default_rng(5)
    n, b, c = 3, 60, 4
    pred = np.concatenate([
        rng.uniform(20, 80, (n, b, 2)), rng.uniform(5, 30, (n, b, 2)),
        rng.uniform(0, 1, (n, b, 1 + c))], -1).astype(np.float32)
    _compare_nms(pred, np.asarray([0.3, 0.5, 0.7], np.float32))


def test_nms_saturation_counters():
    rng = np.random.default_rng(6)
    pred = np.concatenate([
        rng.uniform(0, 400, (2, 80, 2)), rng.uniform(2, 6, (2, 80, 2)),
        rng.uniform(0.6, 1, (2, 80, 3))], -1).astype(np.float32)
    _compare_nms(pred, 0.5, max_boxes=40, max_dets=8)


def test_nms_score_ties_keep_lower_index_first():
    """Saturated objectness gives exact score ties: the keep order must be
    the reference top_k's (lower index first), for separated boxes (all
    kept) and for overlapping ones (the lower index wins the merge)."""
    b = 12
    pred = np.zeros((2, b, 7), np.float32)
    pred[:, :, 0] = np.arange(b) * 40.0 + 20.0  # separated centres
    pred[:, :, 1] = 50.0
    pred[:, :, 2:4] = 10.0
    pred[:, :, 4] = 1.0  # saturated objectness
    pred[:, :, 5] = 0.8  # identical class scores -> identical scores
    pred[1, :, 0] = 50.0 + np.arange(b) * 0.5  # image 1: heavy overlap
    pred[1, ::2, 6] = 0.9  # two classes interleaved
    _compare_nms(pred, 0.5, max_dets=6)
    dets, mask, _ = t_nms(torch.from_numpy(pred), 0.5, 0.4, 512, 6)
    # image 0: the first six boxes, in index order
    np.testing.assert_allclose(dets[0, :, 0].numpy(),
                               np.arange(6) * 40.0 + 15.0, atol=1e-4)


def _crop_case(seed, d=6, h=48, w=64, max_wh=(30, 20)):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (h, w, 3), np.uint8)
    x1 = rng.uniform(-4, w - 2, d)
    y1 = rng.uniform(-4, h - 2, d)
    boxes = np.stack([x1, y1, x1 + rng.uniform(1, max_wh[1], d),
                      y1 + rng.uniform(1, max_wh[0], d)], 1)
    boxes = np.clip(boxes, 0, [w - 1, h - 1, w - 1, h - 1]).astype(np.float32)
    return frame, boxes


def test_crop_window_bounds():
    frame, boxes = _crop_case(7)
    want = JC.crop_window_bounds(jnp.asarray(boxes), 48, 64)
    got = TC.crop_window_bounds(torch.from_numpy(boxes), 48, 64)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_crops_dense_matches_jax():
    frame, boxes = _crop_case(8)
    want = np.asarray(JC.crop_and_normalize(jnp.asarray(frame),
                                            jnp.asarray(boxes)))
    got = TC.crop_and_normalize(torch.from_numpy(frame),
                                torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_crops_windowed_matches_jax_and_dense():
    frame, boxes = _crop_case(9)
    f, b = torch.from_numpy(frame), torch.from_numpy(boxes)
    want = np.asarray(JC.crop_and_normalize_windowed(
        jnp.asarray(frame), jnp.asarray(boxes), 32, 24))
    got = TC.crop_and_normalize_windowed(f, b, 32, 24).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # every box fits the window: the windowed resampler equals dense
    dense = TC.crop_and_normalize(f, b).numpy()
    np.testing.assert_allclose(got, dense, atol=1e-4)


def _kf_case(seed, t=6):
    rng = np.random.default_rng(seed)
    meas = np.concatenate([rng.uniform(50, 400, (t, 2)),
                           rng.uniform(0.3, 0.7, (t, 1)),
                           rng.uniform(40, 200, (t, 1))], 1).astype(np.float32)
    mean, cov = (np.asarray(a) for a in JK.initiate_batch(jnp.asarray(meas)))
    mean = mean + rng.normal(0, 1, mean.shape).astype(np.float32)
    return rng, meas, mean, cov


def test_kalman_initiate_predict():
    _, meas, mean, cov = _kf_case(10)
    tm, tc = TK.initiate(torch.from_numpy(meas))
    jm, jc = JK.initiate_batch(jnp.asarray(meas))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    tm, tc = TK.predict(torch.from_numpy(mean), torch.from_numpy(cov))
    jm, jc = JK.predict_batch(jnp.asarray(mean), jnp.asarray(cov))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)


def test_kalman_update_and_gating():
    rng, meas, mean, cov = _kf_case(11)
    z = meas + rng.normal(0, 2, meas.shape).astype(np.float32)
    tm, tc = TK.update(torch.from_numpy(mean), torch.from_numpy(cov),
                       torch.from_numpy(z))
    jm, jc = JK.update_batch(jnp.asarray(mean), jnp.asarray(cov),
                             jnp.asarray(z))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-3)
    g_t = TK.gating_distance_matrix(torch.from_numpy(mean),
                                    torch.from_numpy(cov),
                                    torch.from_numpy(z)).numpy()
    g_j = np.asarray(JK.gating_distance_matrix(jnp.asarray(mean),
                                               jnp.asarray(cov),
                                               jnp.asarray(z)))
    np.testing.assert_allclose(g_t, g_j, rtol=1e-4, atol=1e-3)
