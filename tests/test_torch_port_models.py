"""The port's Darknet and ReID modules against the JAX package at float32
and at bf16, from identical parameters (the port's weights.py carries them
across)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from specs.weights_np import random_darknet_weights
from yolo_deepsort_tpu.cfg.architectures import ARCHITECTURES
from yolo_deepsort_tpu.models import weights as W
from yolo_deepsort_tpu.models.darknet import build_network as j_build
from yolo_deepsort_tpu.models.darknet import network_apply
from yolo_deepsort_tpu.models.reid import random_reid_params as j_reid_params
from yolo_deepsort_tpu.models.reid import reid_apply
from yolo_deepsort_tpu_torch.models.darknet import build_network
from yolo_deepsort_tpu_torch.models.reid import random_reid_params
from yolo_deepsort_tpu_torch.weights import (
    darknet_from_raw,
    darknet_params_from_folded,
    reid_from_params,
)
from torch_port_threads import torch_threads  # noqa: F401

LAYER_RTOL = 1e-5  # per-layer max |diff| relative to the layer's max |value|


def _defs(name):
    if name == "yolov3-tiny":
        return ARCHITECTURES["yolov3-tiny"](img_size=64)
    # a 2-stage cut of Darknet-53 (convs, stride-2 convs, 3 shortcuts)
    return ARCHITECTURES["yolov3"](img_size=64)[:13]


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov3-cut"])
def test_darknet_per_layer(name):
    defs = _defs(name)
    jplan, tplan = j_build(defs), build_network(defs)
    assert tplan == build_network(defs)
    assert (tplan.img_size, tplan.keep, len(tplan.heads)) == (
        jplan.img_size, jplan.keep, len(jplan.heads))
    blob = random_darknet_weights(jplan.defs(), seed=0, well_conditioned=True)
    _, raw = W.load_darknet_weights(blob, jplan.defs())
    folded = W.fold_inference_params(raw, jplan.defs())
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    j_det, j_layers = network_apply(jplan, folded, jnp.asarray(x),
                                    capture_all_layers=True)
    model = darknet_from_raw(tplan, raw)
    with torch.no_grad():
        t_det, t_layers = model(torch.from_numpy(x), capture_all_layers=True)
    assert len(t_layers) == len(j_layers)
    for i, (a, b) in enumerate(zip(j_layers, t_layers)):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, (i, a.shape, b.shape)
        scale = max(float(np.abs(a).max()), 1e-6)
        assert np.abs(a - b).max() / scale < LAYER_RTOL, f"layer {i}"
    if j_det is None:
        assert t_det is None
    else:
        np.testing.assert_allclose(t_det.numpy(), np.asarray(j_det),
                                   rtol=1e-4, atol=1e-3)


def test_darknet_params_layout():
    defs = _defs("yolov3-tiny")
    plan = j_build(defs)
    raw = W.random_raw_params(plan.defs(), seed=1)
    folded = W.fold_inference_params(raw, plan.defs())
    oihw = darknet_params_from_folded(folded)
    for i, p in folded.items():
        assert tuple(oihw[i]["w"].shape) == p["w"].shape[::-1][:2] + \
            p["w"].shape[:2]
        np.testing.assert_array_equal(oihw[i]["w"].numpy(),
                                      p["w"].transpose(3, 2, 0, 1))


def test_reid_params_twin():
    a, b = random_reid_params(3), j_reid_params(3)
    np.testing.assert_array_equal(a["stem"]["w"], b["stem"]["w"])
    for sa, sb in zip(a["layers"], b["layers"]):
        for ba, bb in zip(sa, sb):
            for k in ("conv1", "conv2"):
                np.testing.assert_array_equal(ba[k]["w"], bb[k]["w"])
            assert (ba["down"] is None) == (bb["down"] is None)


def test_reid_full_net():
    params = random_reid_params(0)
    crops = np.random.default_rng(1).normal(0, 1, (8, 128, 64, 3)).astype(
        np.float32)
    want = np.asarray(reid_apply(params, jnp.asarray(crops)))
    with torch.no_grad():
        got = reid_from_params(params)(torch.from_numpy(crops)).numpy()
    assert got.shape == (8, 512)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def _bf16_ulps(got, want, floor):
    """|got - want| in bf16 ulps of max(|want|, floor): below the floor a
    sum that cancels keeps less than its ulp of the f32 sums' rounding."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    exp = np.floor(np.log2(np.maximum(np.abs(want), floor)))
    return np.abs(got - want) / 2.0 ** (exp - 7)


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov3-cut"])
def test_bf16_darknet_convs_round_as_the_reference(name):
    """Every conv layer of the port's bf16 Darknet, fed the reference's bf16
    input of that layer, against the reference's bf16 output: bf16
    operands, f32 sums, f32 bias and activation, one rounding
    (``models/layers.conv_layer_bf16``, kernel 7's plain version on the
    CPU). Only the order of the f32 sums differs, so every element lies
    within 1 bf16 ulp of max(|want|, 2^-8 of the layer's largest) and at
    most 0.5% of a layer's elements differ at all (measured 0 to 0.04%)."""
    defs = _defs(name)
    jplan, tplan = j_build(defs), build_network(defs)
    blob = random_darknet_weights(jplan.defs(), seed=0, well_conditioned=True)
    _, raw = W.load_darknet_weights(blob, jplan.defs())
    folded = W.fold_inference_params(raw, jplan.defs())
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    _, j_layers = network_apply(jplan, folded, jnp.asarray(x),
                                compute_dtype=jnp.bfloat16,
                                capture_all_layers=True)
    model = darknet_from_raw(tplan, raw).to(torch.bfloat16)
    assert model.convs["0"].bias.dtype == torch.float32  # the folded bias
    from yolo_deepsort_tpu_torch.models.layers import conv_layer_bf16

    defs = tplan.defs()
    n_conv = 0
    for i, mdef in enumerate(defs):
        if mdef["type"] != "convolutional":
            continue
        src = x if i == 0 else np.asarray(j_layers[i - 1], np.float32)
        with torch.no_grad():
            got = conv_layer_bf16(model.convs[str(i)],
                                  torch.from_numpy(src).to(torch.bfloat16),
                                  mdef.get("activation", "linear"))
        want = np.asarray(j_layers[i], np.float32)
        got = got.float().numpy()
        assert got.shape == want.shape
        floor = np.abs(want).max() * 2.0 ** -8
        assert _bf16_ulps(got, want, floor).max() <= 1.0, f"layer {i}"
        assert (got != want).mean() <= 5e-3, f"layer {i}"
        n_conv += 1
    assert n_conv >= 9


@pytest.mark.parametrize("layout", ["512", "128"])
def test_bf16_reid_embeds_round_as_the_reference(layout):
    """The port's bf16 ReID nets against the reference's ``reid_apply`` at
    bf16 on the same crops (24 seeded N(0, 1) crops). Both round where the
    reference rounds (f32 sums and bias, ReLU / ELU in f32, the residual
    sum in f32 with the projection shortcut unrounded, one rounding per
    layer); the order of the f32 sums still flips a bf16 rounding now and
    then, and the random nets carry a flip on through every block after
    it. Max |feature diff|: 512-d within 4e-4 (measured 3.0e-4; 4.2e-4
    before the repair, when each bf16 conv rounded its output and the
    residual sum added two bf16 tensors), 128-d within 1.5e-3 (measured
    1.06e-3; 2.84e-3 before, its dense head's weights rounded to bf16
    too)."""
    from yolo_deepsort_tpu.models.reid import (
        random_original_reid_params as j_original_params,
    )

    params = j_reid_params(0) if layout == "512" else j_original_params(0)
    crops = np.random.default_rng(0).normal(0, 1, (24, 128, 64, 3)).astype(
        np.float32)
    want = np.asarray(reid_apply(params, jnp.asarray(crops),
                                 compute_dtype=jnp.bfloat16))
    net = reid_from_params(params).to(torch.bfloat16)
    with torch.no_grad():
        got = net(torch.from_numpy(crops).to(torch.bfloat16)).numpy()
    assert got.shape == want.shape == (24, int(layout))
    bound = 4e-4 if layout == "512" else 1.5e-3
    assert np.abs(got - want).max() <= bound
