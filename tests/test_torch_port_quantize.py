"""models/quantize.py of the port against the JAX package on the CPU: the
512-d ReID net at full width (seed-3 random params), a seeded N(0, 1)
calibration batch of 16 crops, seeded crops of 8, 24 and 72.

Tolerances:
* packages: ``wq`` byte for byte and ``wscale`` / ``b`` / the front's float
  params exactly (the same numpy code on the same weights); every scale that
  comes from the calibration forward (``xscale``, ``scale``, ``oinv``,
  ``res_scale``, ``in_scale``) to CALIB_ULPS f32 ulps: one f32 forward in
  each framework, whose sums run in another order, so each conv's input
  absmax differs in its last bits (measured on this net and batch: up to 10
  ulps on the activation scales, up to 13 on the packaged scales); from the
  SAME activation scales the packages are equal to 1 f32 ulp;
* forwards, ONE package (the JAX package's) fed to both sides through
  ``reid_int8_package_to_torch``: atol 2e-3 on the normalized features, and
  feature cosine > 0.99999 for the per-layer route -- the reference's bound
  for its own kernel-vs-twin pair: an FMA-contracted epilogue can flip an
  int8 code on a rounding boundary, which moves a normalized feature by
  O(scale / |feat|). The resident route is held to cosine > 0.9999: its
  f32 front is one XLA graph on the reference's two sides but two
  frameworks' convs here (outputs 2e-5 apart at values up to 22), which
  flips about 5 of the 1,048,576 codes of the first quantize at batch 8,
  and with He-random weights one flipped input code moves a crop's feature
  by up to 1.2e-5 in cosine (crops without a flip agree to 1e-7). Stages
  2-4 alone, both sides fed the same codes, are held to the reference's
  0.99999. The resident forward runs with an f32 front on both sides (in
  bf16 the two frameworks round the front at different points).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from yolo_deepsort_tpu.models import quantize as JQ
from yolo_deepsort_tpu.models.reid import random_reid_params as j_reid_params
from yolo_deepsort_tpu_torch.models import quantize as TQ
from yolo_deepsort_tpu_torch.models.reid import random_reid_params
from yolo_deepsort_tpu_torch.weights import (
    reid_from_params,
    reid_int8_package_to_torch,
)

CALIB_ULPS = 32
CONVS = ("conv1", "conv2", "down")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    calib = rng.normal(0, 1, (16, 128, 64, 3)).astype(np.float32)
    j_params, params = j_reid_params(seed=3), random_reid_params(seed=3)
    return dict(
        calib=calib, params=params,
        j_layer=JQ.quantize_reid_params(j_params, calib),
        j_res=JQ.quantize_reid_params_resident(j_params, calib),
        t_layer=TQ.quantize_reid_params(params, calib, device="cpu"),
        t_res=TQ.quantize_reid_params_resident(params, calib, device="cpu"))


def f32_ulps(got, want):
    """max |got - want| in float32 ulps of ``want``."""
    want = np.asarray(want, np.float32)
    gap = np.abs(np.asarray(got, np.float64) - want.astype(np.float64))
    return float((gap / np.spacing(np.abs(want)).astype(np.float64)).max())


def _convs(pkg):
    """(tag, conv package) over the quantized convs of either package."""
    if "stem" in pkg:
        yield "stem", pkg["stem"]
    for li, blocks in enumerate(pkg["layers"]):
        for bi, block in enumerate(blocks):
            for name in CONVS:
                if block[name] is not None:
                    yield f"l{li}b{bi}{name}", block[name]


def test_quantize_reid_params_matches_jax(setup):
    got, want = dict(_convs(setup["t_layer"])), dict(_convs(setup["j_layer"]))
    assert list(got) == list(want) and len(got) == 20
    for tag, qp in got.items():
        ref = want[tag]
        assert set(qp) == set(ref) == {"wq", "wscale", "b", "xscale"}
        assert qp["wq"].dtype == np.int8
        assert qp["wq"].tobytes() == np.asarray(ref["wq"]).tobytes(), tag
        np.testing.assert_array_equal(qp["wscale"], ref["wscale"])
        np.testing.assert_array_equal(qp["b"], np.asarray(ref["b"]))
        assert f32_ulps(qp["xscale"], ref["xscale"]) <= CALIB_ULPS, tag


def _assert_resident_packages_match(got, want, ulps):
    assert set(got) == set(want) == {"front", "in_scale", "layers"}
    assert f32_ulps(got["in_scale"], want["in_scale"]) <= ulps
    g_convs, w_convs = dict(_convs(got)), dict(_convs(want))
    assert list(g_convs) == list(w_convs) and len(g_convs) == 15
    for tag, qp in g_convs.items():
        ref = w_convs[tag]
        assert set(qp) == set(ref) == {"wq", "scale", "b", "oinv"}
        assert qp["wq"].tobytes() == np.asarray(ref["wq"]).tobytes(), tag
        np.testing.assert_array_equal(qp["b"], np.asarray(ref["b"]))
        assert np.asarray(qp["scale"]).dtype == np.float32
        assert np.asarray(qp["oinv"]).dtype == np.float32
        assert f32_ulps(qp["scale"], ref["scale"]) <= ulps, tag
        if float(ref["oinv"]) == 0.0:  # the last conv: f32 out
            assert float(qp["oinv"]) == 0.0 and tag == "l2b1conv2"
        else:
            assert f32_ulps(qp["oinv"], ref["oinv"]) <= ulps, tag
    for gb, wb in zip(sum(got["layers"], []), sum(want["layers"], [])):
        assert f32_ulps(gb["res_scale"], wb["res_scale"]) <= ulps
    for g, w in ((got["front"]["stem"], want["front"]["stem"]),
                 *((gb[c], wb[c]) for gb, wb in zip(got["front"]["layers0"],
                                                    want["front"]["layers0"])
                   for c in ("conv1", "conv2"))):
        np.testing.assert_array_equal(g["w"], np.asarray(w["w"]))
        np.testing.assert_array_equal(g["b"], np.asarray(w["b"]))


def test_quantize_reid_params_resident_matches_jax(setup, monkeypatch):
    """Each framework's own calibration forward: CALIB_ULPS. Then the
    packaging alone, the port handed the reference's activation scales: 1
    f32 ulp, for both packages."""
    _assert_resident_packages_match(setup["t_res"], setup["j_res"],
                                    CALIB_ULPS)
    j_params = j_reid_params(seed=3)
    j_cal = JQ.calibrate_reid_resident_scales(j_params, setup["calib"])
    t_cal = TQ.calibrate_reid_resident_scales(setup["params"],
                                              setup["calib"], device="cpu")
    for key in ("act", "short"):
        assert set(t_cal[key]) == set(j_cal[key])
        for name in j_cal[key]:
            assert f32_ulps(t_cal[key][name],
                            np.float32(j_cal[key][name])) <= CALIB_ULPS, name
    monkeypatch.setattr(TQ, "calibrate_reid_resident_scales",
                        lambda *a, **k: j_cal)
    monkeypatch.setattr(TQ, "calibrate_reid_act_scales",
                        lambda *a, **k: dict(j_cal["act"]))
    _assert_resident_packages_match(
        TQ.quantize_reid_params_resident(setup["params"], setup["calib"],
                                         device="cpu"), setup["j_res"], 1)
    same = dict(_convs(TQ.quantize_reid_params(setup["params"],
                                               setup["calib"], device="cpu")))
    for tag, ref in _convs(setup["j_layer"]):
        assert f32_ulps(same[tag]["xscale"], ref["xscale"]) <= 1, tag


def _assert_features_match(got, want, min_cos=0.99999):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    cos = np.sum(got * want, axis=1)
    assert cos.min() > min_cos, cos.min()
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("n", [8, 24, 72])
def test_reid_apply_int8_matches_jax(setup, n):
    x = np.random.default_rng(n).normal(0, 1, (n, 128, 64, 3)).astype(
        np.float32)
    want = np.asarray(JQ.reid_apply_int8(setup["j_layer"], jnp.asarray(x)))
    pkg = reid_int8_package_to_torch(setup["j_layer"], "cpu")
    got = TQ.reid_apply_int8(pkg, torch.from_numpy(x)).numpy()
    _assert_features_match(got, want)


@pytest.mark.parametrize("n,kernel_route", [(8, True), (24, False),
                                            (72, False)])
def test_reid_apply_int8_resident_matches_jax(setup, n, kernel_route):
    """``kernel_route``: the JAX side runs its Pallas kernel in interpret
    mode and the port takes ``use_pallas=True``, which on CPU tensors is the
    kernel's plain version; else both run their plain twins."""
    x = np.random.default_rng(n).normal(0, 1, (n, 128, 64, 3)).astype(
        np.float32)
    want = np.asarray(JQ.reid_apply_int8_resident(
        setup["j_res"], jnp.asarray(x), use_pallas=kernel_route,
        interpret=kernel_route, front_dtype=jnp.float32))
    pkg = reid_int8_package_to_torch(setup["j_res"], "cpu",
                                     front_dtype=torch.float32)
    got = TQ.reid_apply_int8_resident(pkg, torch.from_numpy(x),
                                      use_pallas=kernel_route).numpy()
    _assert_features_match(got, want, min_cos=0.9999)


def test_resident_stages_match_jax_from_the_same_codes(setup):
    """Stages 2-4 alone, both sides fed the SAME int8 codes (so the two
    frameworks' fronts play no part): the 15 fused int8 convs of the port
    against the reference's twin composed over the same package, by the
    reference's bound for its own kernel-vs-twin pair -- feature cosine >
    0.99999, atol 2e-3 (XLA may contract an epilogue into an FMA and flip a
    code on a rounding boundary; the port's plain version does not)."""
    tq = np.random.default_rng(9).integers(
        -127, 128, (8, 32, 16, 64)).astype(np.int8)
    pkg = reid_int8_package_to_torch(setup["j_res"], "cpu",
                                     front_dtype=torch.float32)
    got = TQ._resident_stages(pkg, torch.from_numpy(tq),
                              TQ.conv_int8_plain).numpy()

    jq = jnp.asarray(tq)
    layers = setup["j_res"]["layers"]
    for li, blocks in enumerate(layers):
        for bi, block in enumerate(blocks):
            last = li == len(layers) - 1 and bi == len(blocks) - 1
            down = block["down"]
            stride = 2 if down is not None else 1
            y1 = JQ._xla_conv_int8_resident(jq, block["conv1"], stride, 1,
                                            True, True)
            short = (JQ._xla_conv_int8_resident(jq, down, stride, 0, False,
                                                True)
                     if down is not None else jq)
            jq = JQ._xla_conv_int8_resident(
                y1, block["conv2"], 1, 1, True, not last, residual=short,
                res_scale=block["res_scale"])
    feat = np.asarray(jq).mean((1, 2))
    want = feat / np.maximum(np.linalg.norm(feat, axis=1, keepdims=True),
                             1e-12)
    _assert_features_match(got, want.astype(np.float32))


def test_resident_forward_takes_the_converted_package(setup):
    """The forwards read one form, the package converted once by
    ``reid_int8_package_to_torch`` (the front's dtype chosen there); the
    port's own package gives features close to the per-layer route and to
    f32, by the reference's bounds for those pairs (0.995, 0.99)."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (8, 128, 64, 3)).astype(np.float32))
    pkg = reid_int8_package_to_torch(setup["t_res"], "cpu",
                                     front_dtype=torch.float32)
    assert TQ.is_torch_package(pkg) and not TQ.is_torch_package(
        setup["t_res"])
    assert TQ.package_front_dtype(pkg) == torch.float32
    assert TQ.package_device(pkg).type == "cpu"
    feats = TQ.reid_apply_int8_resident(pkg, x)
    assert torch.equal(feats, TQ.reid_apply_int8_resident(
        pkg, x, use_pallas=True)), "on CPU tensors K8 is its plain version"
    per_layer = TQ.reid_apply_int8(
        reid_int8_package_to_torch(setup["t_layer"], "cpu"), x)
    f32 = reid_from_params(setup["params"])(x)
    assert (feats * per_layer).sum(1).min() > 0.995
    assert (feats * f32).sum(1).min() > 0.99
    with pytest.raises(ValueError, match="already"):
        reid_int8_package_to_torch(pkg, "cpu")
    bf16_pkg = reid_int8_package_to_torch(setup["t_res"], "cpu")
    assert TQ.package_front_dtype(bf16_pkg) == torch.bfloat16
    assert (TQ.reid_apply_int8_resident(bf16_pkg, x)
            * feats).sum(1).min() > 0.99


def test_f32_via_graph_equals_the_module(setup):
    """The ``_graph`` walker against ``ReIDNet``: the same f32 convs in the
    same order, so equal to float rounding."""
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (4, 128, 64, 3)).astype(np.float32))
    got = TQ.reid_apply_f32_via_graph(setup["params"], x)
    with torch.no_grad():
        want = reid_from_params(setup["params"])(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_original_layout_is_refused():
    from yolo_deepsort_tpu_torch.models.reid import (
        random_original_reid_params,
    )

    calib = np.zeros((1, 128, 64, 3), np.float32)
    for fn in (TQ.quantize_reid_params, TQ.quantize_reid_params_resident):
        with pytest.raises(ValueError, match="original_model"):
            fn(random_original_reid_params(0), calib, device="cpu")
