"""The last public functions of the JAX package that the port lacked, each
against its JAX counterpart on the same numpy inputs: ``weights.py``
``count_params``, ``ops/boxes.py`` ``xyxy_to_xywh`` and ``xywh_to_tlwh``,
and ``tracking/kalman.py`` ``gating_distance`` (both gates).

Tolerances: the parameter counts exactly equal; the box conversions are the
same f32 elementwise expressions (within 1e-6 relative, 1e-5 absolute); the
gating distances run the port's unrolled Cholesky against JAX's LAPACK one
(within 1e-4 relative, 1e-3 absolute, as ``test_torch_port_ops``'s matrix
form).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from yolo_deepsort_tpu.cfg.architectures import ARCHITECTURES as J_ARCH
from yolo_deepsort_tpu.models import weights as JW
from yolo_deepsort_tpu.ops import boxes as JB
from yolo_deepsort_tpu.tracking import kalman as JK
from yolo_deepsort_tpu_torch import weights as TW
from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES as T_ARCH
from yolo_deepsort_tpu_torch.ops import boxes as TB
from yolo_deepsort_tpu_torch.tracking import kalman as TK
from torch_port_threads import torch_threads  # noqa: F401


@pytest.mark.parametrize("name,kw,in_channels", [
    ("yolov3", {}, 3), ("yolov3-tiny", dict(img_size=64, num_classes=1), 3),
    ("yolov4", dict(num_classes=2), 3), ("yolov3-tiny", {}, 1),
])
def test_count_params_matches_jax(name, kw, in_channels):
    defs = T_ARCH[name](**kw)[1:]
    got = TW.count_params(defs, in_channels)
    assert isinstance(got, int)
    assert got == JW.count_params(J_ARCH[name](**kw)[1:], in_channels)


@pytest.mark.parametrize("name", ["xyxy_to_xywh", "xywh_to_tlwh"])
def test_box_conversions_match_jax(name):
    rng = np.random.default_rng(21)
    b = np.concatenate([rng.uniform(0, 400, (3, 16, 2)),
                        rng.uniform(1, 300, (3, 16, 2))], -1).astype(
                            np.float32)
    b[0, 3] = 0.0  # a padded row
    want = np.asarray(getattr(JB, name)(jnp.asarray(b)))
    got = getattr(TB, name)(torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == b.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_box_conversions_round_trip():
    b = torch.tensor([[10.0, 20.0, 50.0, 80.0]])
    xywh = TB.xyxy_to_xywh(b)
    torch.testing.assert_close(xywh, torch.tensor([[30.0, 50.0, 40.0, 60.0]]))
    torch.testing.assert_close(TB.xywh_to_xyxy(xywh), b)
    torch.testing.assert_close(TB.tlwh_to_xyxy(TB.xywh_to_tlwh(xywh)), b)


def _state(seed):
    rng = np.random.default_rng(seed)
    meas = np.asarray([200.0, 150.0, 0.5, 120.0], np.float32)
    mean, cov = (np.array(a) for a in JK.initiate(jnp.asarray(meas)))
    for _ in range(3):  # a few predicts: off-diagonal covariance terms
        mean, cov = (np.array(a) for a in JK.predict(jnp.asarray(mean),
                                                       jnp.asarray(cov)))
    mean = mean + rng.normal(0, 1, 8).astype(np.float32)
    z = (meas + rng.normal(0, [8, 8, 0.05, 8], (12, 4))).astype(np.float32)
    return mean, cov, z


@pytest.mark.parametrize("only_position", [False, True])
def test_gating_distance_matches_jax(only_position):
    mean, cov, z = _state(22)
    got = TK.gating_distance(torch.from_numpy(mean), torch.from_numpy(cov),
                             torch.from_numpy(z), only_position)
    want = np.asarray(JK.gating_distance(jnp.asarray(mean), jnp.asarray(cov),
                                         jnp.asarray(z), only_position))
    assert got.shape == (12,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_gating_distance_batches_like_the_matrix_form():
    """Leading dims broadcast: T states at once equal the matrix form, and
    the 2-dof gate never exceeds the 4-dof one."""
    states = [_state(s) for s in range(23, 27)]
    mean = torch.from_numpy(np.stack([s[0] for s in states]))
    cov = torch.from_numpy(np.stack([s[1] for s in states]))
    z = torch.from_numpy(states[0][2])
    full = TK.gating_distance(mean, cov, z.expand(4, -1, -1))
    assert torch.equal(full, TK.gating_distance_matrix(mean, cov, z))
    pos = TK.gating_distance(mean, cov, z.expand(4, -1, -1), True)
    assert (pos <= full).all()
