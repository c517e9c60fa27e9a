"""The plain NMS versions of the port (``ops/nms.py``
``batched_nms_with_stats_plain``, ``roi_nms_mask_plain``), which hold the
CUDA kernels of ``csrc/nms.cu`` on the card, against the JAX package on
adversarial cases (``test_torch_port_nms_kernel_gpu.nms_cases``,
``roi_cases``, ``nan_case``): exact score ties across the ``max_boxes``
boundary with more valid rows than it, class argmax ties, one box that
suppresses the rest, an image with nothing valid beside a saturated one,
zero-area and non-finite boxes, NaN scores.

Masks, counters and the obj / cls_conf / cls columns exactly equal; merged
boxes within rtol 1e-5, atol 1e-4 (the two frameworks sum in other orders),
NaN where JAX has NaN.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from test_torch_port_nms_kernel_gpu import nan_case, nms_cases, roi_cases
from yolo_deepsort_tpu.ops.nms import batched_nms_with_stats as j_nms
from yolo_deepsort_tpu.ops.nms import roi_nms_mask as j_roi_nms
from yolo_deepsort_tpu_torch.ops import nms as N


def _both(args):
    pred, conf, nms_thres, max_boxes, max_dets = args
    want = [np.asarray(a) for a in j_nms(jnp.asarray(pred), conf, nms_thres,
                                         max_boxes, max_dets)]
    got = [a.numpy() for a in N.batched_nms_with_stats_plain(
        torch.from_numpy(pred),
        conf if isinstance(conf, float) else torch.from_numpy(conf),
        nms_thres, max_boxes, max_dets)]
    return got, want


def _assert_same(got, want):
    (td, tm, ts), (jd, jm, js) = got, want
    np.testing.assert_array_equal(tm, jm)  # keep set and its order
    np.testing.assert_array_equal(ts, js)  # saturation counters
    np.testing.assert_array_equal(td[..., 4:], jd[..., 4:])
    np.testing.assert_allclose(td[..., :4], jd[..., :4], rtol=1e-5,
                               atol=1e-4, equal_nan=True)


@pytest.mark.parametrize("name", sorted(nms_cases()))
def test_plain_nms_matches_jax(name):
    _assert_same(*_both(nms_cases()[name]))


def test_cases_reach_what_they_are_named_for():
    """Each case shows its edge in the plain version's output."""
    cases = nms_cases()
    _, _, sat = _out(cases["ties_across_topk"])
    assert (sat[:, 0] > 0).all()  # n_valid > max_boxes
    dets, mask, sat = _out(cases["one_suppresses_all"])
    assert mask.sum() == 1 and sat[0, 1] == 0
    dets, mask, sat = _out(cases["empty_beside_saturated"])
    assert not mask[0].any() and mask[1].all()
    assert (sat[0] == 0).all() and (sat[1] > 0).all()
    dets, mask, sat = _out(cases["zero_area"])
    assert mask.all() and sat[0, 1] >= 1  # the zero-area top stays alive
    dets, mask, _ = _out(cases["inf_box_in_topk"])
    assert np.isnan(dets[1][mask[1]][:, [0, 2]]).all()
    assert np.isfinite(dets[0][mask[0]]).all()
    dets, mask, _ = _out(cases["class_argmax_ties"])
    pred = cases["class_argmax_ties"][0]
    assert set(np.unique(dets[mask][:, 6])) <= {0.0, 1.0, 2.0}
    assert pred[:, ::2, 5].max() == pred[:, ::2, 6].max()


def _out(args):
    return _both(args)[0]


def test_nan_score_pinned():
    """A NaN score sorts first in both packages (torch.sort descending and
    lax.top_k put NaN above every number), takes one of the ``max_boxes``
    slots and is never alive (NaN > 0 is false): the two agree, three of the
    six finite candidates survive the top-k, and no row is the NaN one's."""
    got, want = _both(nan_case())
    _assert_same(got, want)
    dets, mask, sat = got
    assert mask[0].sum() == 3 and sat[0].tolist() == [3, 0]
    np.testing.assert_allclose(dets[0, :3, 0], [15.0, 65.0, 115.0])  # x1
    assert not np.isnan(dets).any()


@pytest.mark.parametrize("name", sorted(roi_cases()))
def test_plain_roi_nms_matches_jax(name):
    boxes, scores, mask, ov = roi_cases()[name]
    got = N.roi_nms_mask_plain(torch.from_numpy(boxes),
                               torch.from_numpy(scores),
                               torch.from_numpy(mask), ov)
    want = j_roi_nms(boxes, scores, mask, ov)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() < mask.sum()  # something was suppressed
