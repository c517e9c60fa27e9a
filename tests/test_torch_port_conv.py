"""The port's conv route (kernel 7's plain versions, the routing policy, the
int8 package and the ``Darknet.forward`` hook) against the JAX package, on
the CPU at small sizes, inputs from a numpy seed. The Pallas kernel runs in
interpret mode, as the JAX package's own tests run it. (The CUDA kernel
against its plain versions on the card: tests/test_torch_port_gpu.py.)

Tolerances:
* bf16 mode: within 2 bf16 ulps, compared in f32. Both sides multiply the
  same bf16-rounded operands exactly in f32 and differ only in the order of
  the f32 sums, which can move the final bf16 rounding by an ulp. The ulp is
  that of max(|want|, 2^-6): below that the sums' own f32 rounding (inputs
  ~N(0, 1), up to 1152 terms) outweighs the value's ulp.
* int8 mode: exactly equal. The int32 sums are exact on both sides; the
  tests use power-of-two dequant scales and coarse biases, so the f32
  epilogue is exact too and XLA-CPU's FMA contraction cannot move a bit
  (activation codes are kept within |xq| <= 31).
"""

import json

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from yolo_deepsort_tpu.cfg.architectures import yolov3_tiny
from yolo_deepsort_tpu.models import quantize_darknet as JQ
from yolo_deepsort_tpu.models import weights as JW
from yolo_deepsort_tpu.models.darknet import build_network as j_build
from yolo_deepsort_tpu.models.darknet import network_apply
from yolo_deepsort_tpu.ops import pallas_conv as JP
from yolo_deepsort_tpu_torch.models import quantize_darknet as TQ
from yolo_deepsort_tpu_torch.models.darknet import Darknet, build_network
from yolo_deepsort_tpu_torch.ops import conv_kernel as CK
from yolo_deepsort_tpu_torch.parallel.streams import _make_conv_impl
from yolo_deepsort_tpu_torch.weights import (
    conv_int8_package_to_torch,
    darknet_params_from_folded,
)
from torch_port_threads import torch_threads  # noqa: F401

# the reference's own parametrization (tests/test_pallas_conv.py CASES)
CASES = [
    # n, hw, ci, co, k, stride, act
    (2, 16, 128, 256, 3, 1, "leaky"),
    (2, 16, 256, 128, 1, 1, "leaky"),
    (2, 16, 128, 256, 3, 2, "leaky"),
    (1, 13, 256, 512, 3, 1, "leaky"),   # odd spatial, odd N
    (4, 8, 256, 255, 1, 1, "linear"),   # head conv: Co not a multiple of 8
    (2, 16, 128, 256, 3, 1, "mish"),
]


def bf16_ulps(got, want, floor=2.0 ** -6):
    """max |got - want| in bf16 ulps of max(|want|, floor)."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), floor))) - 7)
    return float((np.abs(got - want) / ulp).max())


def _case(rng, n, hw, ci, co, k):
    x = rng.standard_normal((n, hw, hw, ci), np.float32)
    w = (rng.standard_normal((k, k, ci, co), np.float32)
         / np.sqrt(k * k * ci)).astype(np.float32)
    return x, w, rng.standard_normal((co,), np.float32)


@pytest.mark.parametrize("n,hw,ci,co,k,stride,act", CASES)
def test_conv_plain_bf16_vs_pallas_interpret(n, hw, ci, co, k, stride, act):
    rng = np.random.default_rng(n + hw + ci + co + k + stride)
    x, w, b = _case(rng, n, hw, ci, co, k)
    pad = (k - 1) // 2
    want = np.asarray(JP.conv_mxu_bf16(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b), stride=stride, pad=pad, act=act, interpret=True),
        np.float32)
    got = CK.conv_bf16(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), stride=stride, pad=pad, act=act)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bf16_ulps(got.float().numpy(), want) <= 2


def _int8_case(rng, n, hw, ci, co, k):
    x = rng.standard_normal((n, hw, hw, ci), np.float32)
    wq = rng.integers(-127, 128, (k, k, ci, co)).astype(np.int8)
    xinv = np.float32(31.0 / np.abs(x).max())  # |xq| <= 31
    scale = (2.0 ** -rng.integers(10, 14, co)).astype(np.float32)
    b = (rng.integers(-32, 33, co) / 16.0).astype(np.float32)
    return x, wq, b, scale, xinv


@pytest.mark.parametrize("n,hw,ci,co,k,stride,act", [
    (2, 16, 128, 256, 3, 1, "leaky"), (2, 16, 128, 256, 3, 2, "leaky"),
    (2, 16, 256, 128, 1, 1, "leaky"), (4, 8, 256, 255, 1, 1, "linear"),
    (1, 8, 128, 128, 1, 2, "leaky")])
def test_conv_plain_int8_vs_pallas_interpret_and_xla_twin(n, hw, ci, co, k,
                                                          stride, act):
    rng = np.random.default_rng(7 + hw + co + k + stride)
    x, wq, b, scale, xinv = _int8_case(rng, n, hw, ci, co, k)
    pad = (k - 1) // 2
    tx = torch.from_numpy(x)
    args = (torch.from_numpy(wq), torch.from_numpy(b),
            torch.from_numpy(scale), xinv)
    got = CK.conv_int8(tx, *args, stride=stride, pad=pad, act=act)
    acc = CK.conv_plain_int8(tx, *args, stride=stride, pad=pad, act=act,
                             return_acc=True).numpy()

    # the int32 sums against XLA's int8 conv, jitted
    @jax.jit
    def sums(xv):
        xq = jnp.clip(jnp.round(xv * xinv), -127, 127).astype(jnp.int8)
        return jax.lax.conv_general_dilated(
            xq, jnp.asarray(wq), (stride, stride), [(pad, pad)] * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)

    np.testing.assert_array_equal(acc, np.asarray(sums(jnp.asarray(x))))
    assert np.abs(acc).max() > 2 ** 12

    kernel = np.asarray(JP.conv_mxu_int8(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(b), jnp.asarray(scale),
        jnp.asarray(xinv), stride=stride, pad=pad, act=act, interpret=True),
        np.float32)
    np.testing.assert_array_equal(got.float().numpy(), kernel)

    pkg = {5: {"wq": wq, "scale": scale, "b": b, "xinv": xinv}}
    twin = jax.jit(lambda xv: JQ.make_xla_int8_conv_impl(pkg)(
        xv, None, None, stride, pad, act, 5))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(twin(jnp.asarray(x)),
                                             np.float32))
    # the port's own twin and the carried-across package give the same
    t_pkg = conv_int8_package_to_torch(pkg, device="cpu")
    same = TQ.make_plain_int8_conv_impl(t_pkg)(tx, None, None, stride, pad,
                                               act, 5)
    assert torch.equal(same, got)


@pytest.mark.parametrize("geom", [
    (52, 52, 128, 256, 3, 1, "leaky"), (13, 13, 512, 1024, 3, 1, "leaky"),
    (104, 104, 128, 256, 3, 1, "leaky"), (52, 52, 64, 128, 3, 1, "leaky"),
    (52, 52, 128, 256, 3, 1, "mish"), (52, 52, 128, 256, 3, 1, "swish"),
    (13, 13, 512, 1024, 5, 1, "leaky"), (13, 13, 512, 1024, 3, 2, "leaky"),
    (26, 26, 768, 256, 1, 1, "leaky"), (13, 13, 1024, 255, 1, 1, "linear")])
def test_eligibility_policy_equals_reference(geom):
    assert (CK.backbone_conv_eligible(*geom)
            == JP.backbone_conv_eligible(*geom))
    assert (CK.backbone_conv_eligible(*geom, max_hw=32)
            == JP.backbone_conv_eligible(*geom, max_hw=32))


def _tiny(size, seed=4):
    """yolov3-tiny at ``size``: (JAX plan, folded params, the port's f32
    module from the same folded params)."""
    cfg = yolov3_tiny(img_size=size)
    jplan = j_build(cfg, size)
    defs = [dict(d) for d in cfg[1:]]
    folded = JW.fold_inference_params(JW.random_raw_params(defs, seed=seed),
                                      defs)
    model = Darknet(build_network(cfg, size))
    model.load_params(darknet_params_from_folded(folded))
    return jplan, folded, model.eval()


def f32_ulps(got, want):
    """max |got - want| in float32 ulps of ``want``."""
    want = np.asarray(want, np.float32)
    gap = np.abs(np.asarray(got, np.float64) - want.astype(np.float64))
    return float((gap / np.spacing(np.abs(want)).astype(np.float64)).max())


# The calibrated scale of a layer is the absmax (or a percentile) of that
# layer's input, which every f32 conv before it has shaped; the two
# frameworks' f32 convs sum in different orders, so the inputs themselves
# differ in their last bits and the gap grows with depth. Measured on this
# net and batch (yolov3-tiny at 128, seed 4, two frames), per routed layer
# 8..22: 2, 0, 1, 4, 4, 9, 4, 2, 28 f32 ulps for the absmax, up to 43 for
# the 99.9th percentile, up to 18 from raw frames. Held to 64. What does not pass through
# the convs is held to 1 ulp below: the percentile of given activations, and
# the package from given activation scales.
CALIB_ULPS = 64


@pytest.mark.parametrize("pct", [100.0, 99.9, 50.0, 0.0])
def test_activation_percentile_equals_numpy(pct):
    """The calibration statistic alone, on the same activations: the
    device-side percentile of |x| against ``np.percentile`` / absmax to 1
    f32 ulp (sizes that put the percentile between two samples and on
    one). numpy takes the percentile of the float64 copy: on a float32
    array it also rounds the sample position to float32, which moves the
    interpolation weight by up to 2e-3 at these sizes."""
    rng = np.random.default_rng(int(pct * 10))
    for shape in ((2, 13, 13, 128), (1, 7, 9, 16), (1, 1, 1, 1001)):
        x = rng.standard_normal(shape).astype(np.float32)
        ax = np.abs(x)
        want = (float(np.percentile(ax.astype(np.float64), pct))
                if pct < 100 else float(ax.max()))
        got = TQ._abs_percentile(torch.from_numpy(x), pct)
        assert f32_ulps(got, want) <= 1, (shape, got, want)


def test_quantize_darknet_convs_equals_reference(monkeypatch):
    """One calibration batch through both packages: the same folded weights
    give ``wq`` byte for byte and ``b`` exactly. ``scale`` and ``xinv``
    follow each layer's calibrated activation scale: from the SAME
    activation scales they are held to 1 f32 ulp; calibrated by each
    framework's own f32 forward, to CALIB_ULPS (measured gaps above)."""
    jplan, folded, model = _tiny(128)
    calib = np.random.default_rng(1).random((2, 128, 128, 3), np.float32)
    want = JQ.quantize_darknet_convs(jplan, folded, calib)
    got = TQ.quantize_darknet_convs(model, calib)
    assert set(got) == set(want) and len(got) >= 3
    for idx in want:
        assert got[idx]["wq"].dtype == np.int8
        assert got[idx]["wq"].tobytes() == want[idx]["wq"].tobytes(), idx
        np.testing.assert_array_equal(got[idx]["b"], want[idx]["b"])
        assert f32_ulps(got[idx]["scale"], want[idx]["scale"]) <= CALIB_ULPS
        assert f32_ulps(got[idx]["xinv"], want[idx]["xinv"]) <= CALIB_ULPS
        assert got[idx]["scale"].dtype == np.float32
        assert got[idx]["xinv"].dtype == np.float32
    # the activation scales themselves, absmax and percentile
    j_acts = {}
    for pct in (100.0, 99.9):
        j_act = j_acts[pct] = JQ.calibrate_darknet_act_scales(
            jplan, folded, calib, pct=pct)
        t_act = TQ.calibrate_darknet_act_scales(model, calib, pct=pct)
        assert set(t_act) == set(j_act)
        for idx in j_act:
            assert f32_ulps(t_act[idx], j_act[idx]) <= CALIB_ULPS, (pct, idx)
    # the packaging alone: both sides handed the reference's scales (its
    # default statistic, the absmax)
    j_act = j_acts[100.0]
    monkeypatch.setattr(TQ, "calibrate_darknet_act_scales",
                        lambda *a, **k: dict(j_act))
    same = TQ.quantize_darknet_convs(model, calib)
    monkeypatch.undo()
    for idx in want:
        assert same[idx]["wq"].tobytes() == want[idx]["wq"].tobytes()
        assert f32_ulps(same[idx]["scale"], want[idx]["scale"]) <= 1
        assert f32_ulps(same[idx]["xinv"], want[idx]["xinv"]) <= 1
    # layers / k3_only restrict the package as in the reference
    keep = {sorted(want)[0]}
    assert set(TQ.quantize_darknet_convs(model, calib, layers=keep)) == keep
    k3 = TQ.quantize_darknet_convs(model, calib, k3_only=True)
    assert set(k3) == set(JQ.quantize_darknet_convs(jplan, folded, calib,
                                                    k3_only=True))
    # from raw frames: the same letterbox geometry on both sides
    frames = np.random.default_rng(2).integers(0, 256, (3, 96, 160, 3),
                                               np.uint8)
    a = TQ.quantize_darknet_from_frames(model, frames, 128)
    b = JQ.quantize_darknet_from_frames(jplan, folded, frames, 128)
    assert set(a) == set(b)
    for idx in a:
        assert a[idx]["wq"].tobytes() == b[idx]["wq"].tobytes()
        assert f32_ulps(a[idx]["xinv"], b[idx]["xinv"]) <= CALIB_ULPS
        assert f32_ulps(a[idx]["scale"], b[idx]["scale"]) <= CALIB_ULPS
    # tensors are taken as they lie (a CPU detector calibrates on the CPU)
    c = TQ.quantize_darknet_from_frames(model, torch.from_numpy(frames), 128)
    for idx in a:
        np.testing.assert_array_equal(c[idx]["scale"], a[idx]["scale"])
    with pytest.raises(ValueError, match="float32"):
        TQ.quantize_darknet_convs(model.to(torch.bfloat16), calib)


def test_darknet_forward_conv_hook_vs_network_apply():
    """The hooked forward against network_apply with the Pallas hook in
    interpret mode, both computing in f32 around the routed layers: routed
    outputs are bf16 on both sides, and an f32 sum taken in another order
    flips a bf16 rounding here and there (1 ulp = 0.4-0.8%), which the
    layers behind carry on and exp(tw) amplifies: the JAX package's own
    hook test allows boxes 4% (or 3 px) and scores 3e-2 for that; here boxes
    within 4% (or 0.05 px) and scores within 1e-2."""
    jplan, folded, model = _tiny(128)
    x = np.random.default_rng(0).random((1, 128, 128, 3), np.float32)
    routed = {"j": [], "t": []}
    j_impl = JP.make_backbone_conv_impl(interpret=True)
    t_impl = CK.make_backbone_conv_impl()

    def counting(impl, key):
        def hook(*a):
            out = impl(*a)
            if out is not None:
                routed[key].append(a[-1])
            return out
        return hook

    want = np.asarray(network_apply(jplan, folded, jnp.asarray(x),
                                    conv_impl=counting(j_impl, "j")))
    with torch.no_grad():
        got = model(torch.from_numpy(x), conv_impl=counting(t_impl, "t"))
        plain = model(torch.from_numpy(x))
    assert routed["t"] == routed["j"] and len(routed["t"]) >= 3
    got = got.numpy()
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=4e-2,
                               atol=0.05)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], atol=1e-2)
    assert not np.array_equal(got, plain.numpy())  # the route did run

    # a whitelist restricts the route; the weights are packed once
    only = frozenset(routed["t"][:1])
    wl_impl = CK.make_backbone_conv_impl(layer_whitelist=only)
    with torch.no_grad():
        model(torch.from_numpy(x), conv_impl=counting(wl_impl, "t"))
    assert routed["t"][-1:] == list(only)


def test_darknet_forward_int8_route_vs_xla_twin():
    """Whitelist dict routing with an int8 package: the port's forward
    (bf16 kernel's plain version on one layer, int8 on another) against the
    JAX forward composed of the same two routes. Same tolerance as the bf16
    hook test: the int8 layers are exact, the layers around them are f32
    convs of two frameworks."""
    jplan, folded, model = _tiny(128)
    rng = np.random.default_rng(11)
    x = rng.random((1, 128, 128, 3), np.float32)
    probe = []
    j_all = JP.make_backbone_conv_impl(interpret=True)

    def discover(xv, w, b, stride, pad, act, idx):
        if j_all(xv, w, b, stride, pad, act, idx) is not None:
            probe.append(idx)
        return None

    network_apply(jplan, folded, jnp.asarray(x), conv_impl=discover)
    bf16_l, int8_l = probe[0], probe[1]
    pkg = JQ.quantize_darknet_convs(jplan, folded, x, layers={int8_l})
    t_pkg = TQ.quantize_darknet_convs(model, x, layers={int8_l})
    assert t_pkg[int8_l]["wq"].tobytes() == pkg[int8_l]["wq"].tobytes()

    wl = {"bf16": frozenset({bf16_l}), "int8": frozenset({int8_l})}
    want = np.asarray(network_apply(
        jplan, folded, jnp.asarray(x),
        conv_impl=JP.make_backbone_conv_impl(
            interpret=True, layer_whitelist=wl["bf16"] | wl["int8"],
            int8_pkg=pkg)))
    taken = []
    impl = _make_conv_impl(wl, pkg)  # the SAME package on both sides

    def counting(*a):
        out = impl(*a)
        if out is not None:
            taken.append(a[-1])
        return out

    with torch.no_grad():
        got = model(torch.from_numpy(x), conv_impl=counting).numpy()
    assert sorted(taken) == sorted({bf16_l, int8_l})
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=4e-2,
                               atol=0.05)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], atol=1e-2)

    # the plain twin route computes what the int8 kernel route computes
    with torch.no_grad():
        a = model(torch.from_numpy(x),
                  conv_impl=_make_conv_impl("plain-twin", pkg))
        b = model(torch.from_numpy(x), conv_impl=_make_conv_impl(
            {"int8": frozenset({int8_l})}, pkg))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="backbone_int8_pkg"):
        _make_conv_impl("plain-twin", None)
    with pytest.raises(ValueError, match="unknown conv route"):
        _make_conv_impl("interpret", None)
    assert _make_conv_impl(False, pkg) is None


def test_load_conv_whitelist_accepts_only_cuda_files(tmp_path):
    rec = {"model": "yolov3", "img_size": 416, "batch": 8, "backend": "cuda",
           "bf16": [37, 64], "int8": [63]}
    path = tmp_path / "conv_whitelist_yolov3_416_b8.json"
    path.write_text(json.dumps(rec))
    wl = CK.load_conv_whitelist("yolov3", 416, 8, tuned_dir=str(tmp_path))
    assert wl == {"bf16": frozenset({37, 64}), "int8": frozenset({63})}
    for backend in ("tpu", "cpu", None):
        rec2 = dict(rec)
        if backend is None:
            del rec2["backend"]
        else:
            rec2["backend"] = backend
        path.write_text(json.dumps(rec2))
        assert CK.load_conv_whitelist("yolov3", 416, 8,
                                      tuned_dir=str(tmp_path)) is None
    assert CK.load_conv_whitelist("yolov3", 608, 8,
                                  tuned_dir=str(tmp_path)) is None
    # the files shipped for the TPU are refused
    assert CK.load_conv_whitelist("yolov3", 416, 8) is None
    assert CK.load_conv_whitelist("yolov3", 416, 16) is None


@pytest.mark.parametrize("bad", ["k5", "pad", "odd_stride2", "ci"])
def test_conv_wrappers_refuse_what_the_kernel_does_not_take(bad):
    x = torch.zeros((1, 8, 8, 128))
    w = torch.zeros((3, 3, 128, 128))
    b = torch.zeros((128,))
    kw = dict(stride=1, pad=1)
    if bad == "k5":
        w = torch.zeros((5, 5, 128, 128))
        kw["pad"] = 2
    elif bad == "pad":
        kw["pad"] = 0
    elif bad == "odd_stride2":
        x = torch.zeros((1, 7, 7, 128))
        kw["stride"] = 2
    else:
        w = torch.zeros((3, 3, 64, 128))
    with pytest.raises(ValueError):
        CK.conv_bf16(x, w, b, **kw)
