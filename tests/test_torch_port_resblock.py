"""The fused residual-chain route of the port (``ops/resblock_kernel.py``,
``Darknet.forward(block_impl=)``, ``use_resblock`` on the serving steps)
against the JAX package on the CPU, from the same numpy inputs.

The JAX side runs its Pallas chain kernel in interpret mode, as
``tests/test_pallas_resblock.py`` does; the port runs the plain version of
its CUDA kernel (CPU tensors). Tolerances:

* bf16 chains: rtol = atol = 3e-2, the reference's own bound between its
  kernel and the per-layer path (f32 sums in another order, each block
  rounds ``mid`` and its output to bf16, a chain compounds the roundings);
* int8 chains: the same bound, and the share of exactly equal outputs is
  asserted above 0.99 (leaky: all of them) and printed. The JAX kernel is
  compiled for this comparison with ``xla_allow_excess_precision`` off: by
  default XLA on the CPU keeps a block's f32 result where the kernel stores
  bf16 chain state, so from the second block on the input codes are
  quantized from unrounded values and ~3% of them flip (measured: 70% of a
  two-block chain's outputs then differ in their last bits). With the
  stores rounded as on the device, the port's plain version equals the JAX
  kernel bit for bit, as it equals the reference's own eager twin;
* the routed detector (toy residual net, bf16 chains in an f32 net): 4e-2,
  the reference's bound for its hook;
* the serving steps: NMS masks and emitted rows equal, boxes within 1 px (a
  bf16 ulp in a routed layer moves a box coordinate by a fraction of a
  pixel; the threshold sits in the widest objectness gap so that no
  candidate flips).
"""

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from specs.weights_np import random_darknet_weights
from yolo_deepsort_tpu.cfg.architectures import ARCHITECTURES as J_ARCH
from yolo_deepsort_tpu.config import DetectorConfig, TrackerConfig
from yolo_deepsort_tpu.models import quantize_darknet as JQ
from yolo_deepsort_tpu.models import weights as W
from yolo_deepsort_tpu.models.darknet import build_network as j_build
from yolo_deepsort_tpu.models.darknet import network_apply
from yolo_deepsort_tpu.models.reid import random_reid_params as j_reid_params
from yolo_deepsort_tpu.ops import pallas_resblock as JR
from yolo_deepsort_tpu.ops.letterbox import letterbox as j_letterbox
from yolo_deepsort_tpu.parallel import streams as JS
from yolo_deepsort_tpu_torch.cfg.architectures import ARCHITECTURES
from yolo_deepsort_tpu_torch.models.darknet import Darknet, build_network
from yolo_deepsort_tpu_torch.models.reid import random_reid_params
from yolo_deepsort_tpu_torch.ops import conv_kernel as CV
from yolo_deepsort_tpu_torch.ops import conv_plan as CP
from yolo_deepsort_tpu_torch.ops import resblock_kernel as TR
from yolo_deepsort_tpu_torch.ops.conv_plan_table import TUNED_132_SMS
from yolo_deepsort_tpu_torch.parallel import streams as TS
from yolo_deepsort_tpu_torch.weights import darknet_from_raw, reid_from_params

from test_pallas_resblock import (
    CASES,
    TOY_CFG,
    _calib_absmax,
    _chain_case,
    _parse_text,
    _quant_layer,
    _toy_net,
    _xla_int8_chain,
)
from test_torch_port_slice import _plant_small_boxes
from test_torch_port_tracking import DISCRETE
from torch_port_threads import torch_threads  # noqa: F401


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("n,h,w,ci,cm,nblk,act", CASES)
def test_chain_plain_bf16_matches_jax_kernel(n, h, w, ci, cm, nblk, act):
    rng = np.random.default_rng(hash((n, h, ci, cm, nblk)) % 2**32)
    x, w1, b1, w2, b2 = _chain_case(rng, n, h, w, ci, cm, nblk)
    want = JR.resblock_chain_bf16(
        x, jnp.asarray(w1.reshape(nblk, ci, cm), jnp.bfloat16),
        jnp.asarray(b1), jnp.asarray(w2, jnp.bfloat16), jnp.asarray(b2),
        act=act, interpret=True)
    before = TR.launches
    got = TR.resblock_chain_bf16(
        _t(np.asarray(x, np.float32), torch.bfloat16),
        _t(w1.reshape(nblk, ci, cm), torch.bfloat16), _t(b1),
        _t(w2, torch.bfloat16), _t(b2), act=act)
    assert TR.launches == before, "CPU tensors take the plain version"
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("nblk,act", [(1, "leaky"), (2, "leaky"),
                                      (2, "mish")])
def test_chain_plain_int8_matches_jax_kernel(nblk, act):
    """The reference's three int8 cases with its scale rule (|xq| <= 31, so
    every int32 sum is exact in the f32 arithmetic XLA's CPU backend
    emulates int8 products with)."""
    rng = np.random.default_rng(11 + nblk)
    n, h, w, ci, cm = 2, 13, 13, 256, 128
    x, w1, b1, w2, b2 = _chain_case(rng, n, h, w, ci, cm, nblk)
    abses = _calib_absmax(x, w1, b1, w2, b2, act)
    q1 = [_quant_layer(rng, w1[b], abses[b][0]) for b in range(nblk)]
    q2 = [_quant_layer(rng, w2[b], abses[b][1]) for b in range(nblk)]
    w1q = np.stack([q[0].reshape(ci, cm) for q in q1])
    w2q = np.stack([q[0] for q in q2])
    s1 = np.stack([q[2] * q[1] for q in q1]).astype(np.float32)
    s2 = np.stack([q[2] * q[1] for q in q2]).astype(np.float32)
    xinv = np.stack([[np.float32(1.0 / a[2]), np.float32(1.0 / b[2])]
                     for a, b in zip(q1, q2)]).astype(np.float32)
    args = (x, jnp.asarray(w1q), jnp.asarray(b1), jnp.asarray(w2q),
            jnp.asarray(b2), jnp.asarray(s1), jnp.asarray(s2),
            jnp.asarray(xinv))
    # jitted, with bf16 stores rounded as the device rounds them
    want = JR.resblock_chain_int8.lower(
        *args, act=act, interpret=True).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
    got = TR.resblock_chain_int8(
        _t(np.asarray(x, np.float32), torch.bfloat16), _t(w1q), _t(b1),
        _t(w2q), _t(b2), _t(s1), _t(s2), _t(xinv), act=act)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    share = float((got == want).mean())
    print(f"int8 chain nblk={nblk} {act}: {share:.4f} of the outputs "
          f"exactly equal")
    assert share == 1.0 if act == "leaky" else share > 0.99
    # the reference's own twin, op by op without fusion: the same bits
    pkgs = [({"wq": q1[b][0], "scale": s1[b], "b": b1[b],
              "xinv": xinv[b, 0]},
             {"wq": q2[b][0], "scale": s2[b], "b": b2[b],
              "xinv": xinv[b, 1]}) for b in range(nblk)]
    twin = np.asarray(_xla_int8_chain(x, pkgs, act), np.float32)
    np.testing.assert_allclose(got, twin, rtol=3e-2, atol=3e-2)
    assert float((got == twin).mean()) > 0.99


def _int8_chain_args(nblk):
    """The W8A8 operands of ``test_chain_plain_int8_matches_jax_kernel``."""
    rng = np.random.default_rng(11 + nblk)
    n, h, w, ci, cm = 2, 13, 13, 256, 128
    x, w1, b1, w2, b2 = _chain_case(rng, n, h, w, ci, cm, nblk)
    abses = _calib_absmax(x, w1, b1, w2, b2, "leaky")
    q1 = [_quant_layer(rng, w1[b], abses[b][0]) for b in range(nblk)]
    q2 = [_quant_layer(rng, w2[b], abses[b][1]) for b in range(nblk)]
    w1q = np.stack([q[0].reshape(ci, cm) for q in q1])
    w2q = np.stack([q[0] for q in q2])
    s1 = np.stack([q[2] * q[1] for q in q1]).astype(np.float32)
    s2 = np.stack([q[2] * q[1] for q in q2]).astype(np.float32)
    xinv = np.stack([[np.float32(1.0 / a[2]), np.float32(1.0 / b[2])]
                     for a, b in zip(q1, q2)]).astype(np.float32)
    return x, w1q, b1, w2q, b2, s1, s2, xinv


def _codes_at_the_store(x, w1q, b1, w2q, b2, s1, s2, xinv, act):
    """The kernel's int8 block as it runs: the 1x1 conv's epilogue rounds
    act(f32(acc) * s1 + b1) to bf16 and STORES the codes clip(rint(m *
    xinv2), -127, 127); the 3x3 conv reads those codes as they are (no
    quantize on its way in), then act(f32(acc) * s2 + b2) to bf16 and the
    shortcut add in bf16."""
    out = x.to(torch.bfloat16)
    for b in range(w1q.shape[0]):
        acc1 = CV.conv_plain_int8(out, w1q[b][None, None], b1[b], s1[b],
                                  float(xinv[b, 0]), pad=0, return_acc=True)
        m = CV.apply_act(acc1.float() * s1[b] + b1[b], act).to(
            torch.bfloat16)
        codes = torch.round(m.float() * float(np.float32(xinv[b, 1]))).clamp(
            -127, 127).to(torch.int8)
        acc2 = CV._conv_nhwc(codes.double(), w2q[b].double(), 1, 1).to(
            torch.int32)
        y = CV.apply_act(acc2.float() * s2[b] + b2[b], act).to(
            torch.bfloat16)
        out = y + out
    return out.contiguous()


@pytest.mark.parametrize("nblk,act", [(1, "leaky"), (2, "leaky"),
                                      (2, "mish")])
def test_codes_written_at_the_1x1_store_equal_the_plain_int8_chain(nblk,
                                                                   act):
    """Writing ``mid`` as int8 codes in the 1x1 conv's epilogue (the
    kernel's design) gives the plain version's bits exactly -- mish too,
    since both sides here run the same math library -- and, against the JAX
    kernel (stores rounded as on the device), the tolerance of
    ``test_chain_plain_int8_matches_jax_kernel``."""
    x, w1q, b1, w2q, b2, s1, s2, xinv = _int8_chain_args(nblk)
    args = (_t(np.asarray(x, np.float32), torch.bfloat16), _t(w1q), _t(b1),
            _t(w2q), _t(b2), _t(s1), _t(s2))
    got = _codes_at_the_store(*args, xinv, act)
    plain = TR.resblock_chain_plain_int8(*args, xinv, act=act)
    assert torch.equal(got, plain)
    jargs = (x, jnp.asarray(w1q), jnp.asarray(b1), jnp.asarray(w2q),
             jnp.asarray(b2), jnp.asarray(s1), jnp.asarray(s2),
             jnp.asarray(xinv))
    want = np.asarray(JR.resblock_chain_int8.lower(
        *jargs, act=act, interpret=True).compile(
            compiler_options={"xla_allow_excess_precision": False})(*jargs),
        np.float32)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    share = float((got == want).mean())
    assert share == 1.0 if act == "leaky" else share > 0.99


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_packed_chain_weights_give_the_same_plain_chain(mode):
    """``pack_chain_weights``: each block's two convs as K-major rows
    (``pack_conv_weights`` per block, stacked in one ``PackedWeights``);
    unpacking gives the stacked weights back, the plain versions give the
    same bits from either form, and so does every block cut out of either
    form (``block_args``)."""
    case = TR.seeded_chain_case(np.random.default_rng(3), "cpu", 2, 8, 128,
                                128, 3)
    args = case[mode]
    packed = TR.pack_chain_args(args)
    for raw, p, k in ((args[1], packed[1], 1), (args[3], packed[3], 3)):
        assert isinstance(p, CP.PackedWeights) and p.k == k
        assert p.data.shape[:2] == (3, p.co) and p.data.is_contiguous()
        assert torch.equal(TR.unpack_chain_weights(p), raw)
        assert torch.equal(p.data[1], CP.pack_conv_weights(
            raw[1][None, None] if k == 1 else raw[1]).data)
        assert TR.pack_chain_weights(p) is p
    plain = (TR.resblock_chain_plain_bf16 if mode == "bf16"
             else TR.resblock_chain_plain_int8)
    assert torch.equal(plain(*packed), plain(*args))
    state = args[0]
    for b in range(3):
        one_packed = TR.block_args(packed[1:], b)
        assert one_packed[0].data.shape[0] == 1
        want = plain(state, *TR.block_args(args[1:], b))
        assert torch.equal(plain(state, *one_packed), want)
        state = want
    assert torch.equal(state, plain(*args)), "a chain is its blocks"
    if mode == "int8":
        assert args[-1].device.type == "cpu", "xinv stays in host memory"


def test_int8_kernel_path_refuses_xinv_off_the_host(monkeypatch):
    """The kernels take ``xinv`` by value: the kernel path wants the table
    in host memory and refuses one on a device (here the meta device, past
    the device checks and the build; on the card a CUDA tensor,
    ``tests/test_torch_port_gpu.py``) before it launches anything."""
    from yolo_deepsort_tpu_torch.kernels import build

    case = TR.seeded_chain_case(np.random.default_rng(4), "cpu", 1, 4, 128,
                                128, 2)
    *args, xinv = case["int8"]
    monkeypatch.setattr(build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(build, "load", lambda: None)
    before = TR.launches
    with pytest.raises(ValueError, match="host memory"):
        TR.resblock_chain_cuda(*args, xinv.to("meta"))
    assert TR.launches == before
    assert TR._host_xinv(xinv).dtype == np.float32
    np.testing.assert_array_equal(TR._host_xinv(case["xinv"]), case["xinv"])


def _with_net(defs):
    """Module definitions (no [net] section) -> both packages' plans."""
    net = {"type": "net", "width": "64", "height": "64", "channels": "3"}
    return j_build([dict(net)] + [dict(d) for d in defs]), build_network(
        [dict(net)] + [dict(d) for d in defs])


def _conv(filters, size, act="leaky", stride=1):
    return {"type": "convolutional", "batch_normalize": "1",
            "filters": str(filters), "size": str(size),
            "stride": str(stride), "pad": "1", "activation": act}


_SHORTCUT = {"type": "shortcut", "from": "-3", "activation": "linear"}


@pytest.mark.parametrize("name", ["toy", "yolov3", "yolov3-tiny", "yolov4"])
def test_find_residual_spans_matches_jax(name):
    if name == "toy":
        defs = _parse_text(TOY_CFG)
        jplan, tplan = j_build(defs), build_network(defs)
    else:
        jplan = j_build(J_ARCH[name](img_size=416))
        tplan = build_network(ARCHITECTURES[name](img_size=416))
    want = JR.find_residual_spans(jplan)
    got = TR.find_residual_spans(tplan)
    assert got == want
    starts = [(c[0], len(c)) for c in got]
    if name == "toy":
        assert got == [(1, 4)]
    elif name == "yolov3":
        assert starts == [(2, 1), (6, 2), (13, 8), (38, 8), (63, 4)]
    elif name == "yolov3-tiny":
        assert got == []
    else:
        assert [c[0] for c in got] == [5, 15, 28, 59, 90]
        assert all(tplan.defs()[c[0]]["activation"] == "mish" for c in got)


def test_find_residual_spans_does_not_merge_across_an_outside_reference():
    """Two consecutive spans whose first shortcut output also feeds a later
    route: the reference merges them (and its hook would then miss the
    cached output); the port keeps them apart."""
    defs = [_conv(128, 3, stride=2),
            _conv(128, 1), _conv(128, 3), dict(_SHORTCUT),
            _conv(128, 1), _conv(128, 3), dict(_SHORTCUT),
            {"type": "route", "layers": "3"},
            _conv(128, 1)]
    jplan, tplan = _with_net(defs)
    assert JR.find_residual_spans(jplan) == [(1, 4)]
    assert TR.find_residual_spans(tplan) == [(1,), (4,)]


def test_find_residual_spans_does_not_merge_spans_of_different_cm():
    defs = [_conv(256, 3, stride=2),
            _conv(128, 1), _conv(256, 3), dict(_SHORTCUT),
            _conv(256, 1), _conv(256, 3), dict(_SHORTCUT),
            _conv(128, 1)]
    jplan, tplan = _with_net(defs)
    assert JR.find_residual_spans(jplan) == [(1, 4)]
    assert TR.find_residual_spans(tplan) == [(1,), (4,)]


@pytest.mark.parametrize("n", [8, 32])
@pytest.mark.parametrize("int8_mode", [False, True])
@pytest.mark.parametrize("h,ci,cm,nblk", [(52, 256, 128, 8),
                                          (26, 512, 256, 8),
                                          (13, 1024, 512, 4)])
def test_plan_chain_schedule_fits_shared_memory(n, int8_mode, h, ci, cm,
                                                nblk):
    """The three chain classes of yolov3-416: each block is two launches of
    the conv kernels' main loop, each layer under the conv planner's plan
    for its shape (1x1: m pixels, Cm columns, depth Ci, quantizing in int8
    mode; 3x3: Ci columns, depth 9 Cm), within the 227 KB of shared memory
    a thread block can use. At batch 8 the bf16 layers and the int8 1x1
    conv are classes the planner's table holds (kernel 7's timed shapes)."""
    sched = TR.plan_chain_schedule(n, h, h, ci, cm, nblk, int8_mode)
    assert sched is not None
    assert sched.kernel_launches == 2 * nblk
    m, es = n * h * h, 1 if int8_mode else 2
    assert sched.conv1 == CP.plan_conv_tiles(m, cm, ci, es,
                                             quantizing=int8_mode)
    assert sched.conv2 == CP.plan_conv_tiles(m, ci, 9 * cm, es)
    for plan, depth in ((sched.conv1, ci), (sched.conv2, 9 * cm)):
        assert CP.check_plan(plan, depth, es) == plan
        assert CP.plan_smem_bytes(plan.bm, plan.bn, plan.stages) <= \
            227 * 1024 == TR.SMEM_PER_BLOCK
    if n == 8:
        assert (m, cm, ci, es, int8_mode) in TUNED_132_SMS
        if not int8_mode:
            assert (m, ci, 9 * cm, es, False) in TUNED_132_SMS


def test_plan_chain_schedule_refuses():
    # a state past the main loop's 32-bit offsets -> None (the chain runs
    # layer by layer)
    assert TR.plan_chain_schedule(64, 512, 512, 2048, 1024, 1, False) is None
    assert TR.plan_chain_schedule(1, 512, 512, 2048, 1024, 1, False) \
        is not None
    # channels that do not fill the 128-wide tiles the route asks for
    assert TR.plan_chain_schedule(8, 13, 13, 192, 128, 2, False) is None
    assert TR.plan_chain_schedule(8, 52, 52, 128, 64, 2, True) is None
    # a budget below a two-stage ring of the planned tiles
    assert TR.plan_chain_schedule(8, 52, 52, 256, 128, 8, False,
                                  budget=48 * 1024) is None
    # a budget that holds a shallower ring: the ring is cut to it
    small = TR.plan_chain_schedule(8, 52, 52, 256, 128, 8, False,
                                   budget=160 * 1024)
    full = TR.plan_chain_schedule(8, 52, 52, 256, 128, 8, False)
    for got, want in zip(small[:2], full[:2]):
        assert got._replace(stages=want.stages) == want
        assert 2 <= got.stages <= want.stages
        assert CP.plan_smem_bytes(got.bm, got.bn, got.stages) <= 160 * 1024
    # an empty chain or map
    assert TR.plan_chain_schedule(8, 13, 13, 256, 128, 0, False) is None
    assert TR.plan_chain_schedule(0, 13, 13, 256, 128, 2, False) is None


def test_plan_chain_schedule_declines_what_the_route_declined():
    """Over the chains the served models give the route (maps up to 64 at
    inputs 128-640, batch 1-64, both modes): the schedule is None exactly
    where Ci or Cm is not a multiple of 128 -- the inputs the route declined
    before the chain ran on the conv kernels' main loop (the shared-memory
    budget of a strip never refused a map of 64 or less)."""
    classes = ((8, 256, 128), (16, 512, 256), (32, 1024, 512),
               (8, 128, 128), (16, 256, 256), (32, 512, 512), (8, 128, 64))
    seen = 0
    for n in (1, 2, 3, 8, 16, 32, 64):
        for img in range(128, 641, 32):
            for div, ci, cm in classes:
                h = img // div
                if h > 64:
                    continue
                for int8_mode in (False, True):
                    sched = TR.plan_chain_schedule(n, h, h, ci, cm, 8,
                                                   int8_mode)
                    assert (sched is None) == bool(ci % 128 or cm % 128), (
                        n, h, ci, cm, int8_mode)
                    seen += 1
    assert seen > 1000


def _toy_detector(plan_params):
    jplan, params = plan_params
    tplan = build_network(_parse_text(TOY_CFG))
    model = Darknet(tplan)
    model.load_params({i: {"w": p["w"].transpose(3, 2, 0, 1), "b": p["b"]}
                       for i, p in params.items()})
    return tplan, model.eval()


def test_darknet_forward_block_impl_matches_jax():
    jplan, params = _toy_net()
    tplan, model = _toy_detector((jplan, params))
    x = np.random.default_rng(5).random((2, 64, 64, 3), np.float32)
    want = network_apply(jplan, params, jnp.asarray(x),
                         compute_dtype=jnp.bfloat16,
                         block_impl=JR.make_resblock_impl(jplan,
                                                          interpret=True))
    calls = []
    impl = TR.make_resblock_impl(tplan)

    def counting(xx, convs, i):
        res = impl(xx, convs, i)
        if res is not None:
            calls.append((i, res[1]))
        return res

    model = model.to(torch.bfloat16)
    with torch.no_grad():
        got = model(_t(x), block_impl=counting)
        unrouted = model(_t(x))
        _, layers = model(_t(x), capture_all_layers=True,
                          block_impl=counting)
    assert calls == [(1, 6)], "one chain of two blocks, six modules"
    assert len(layers) == len(tplan.defs())
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=4e-2, atol=4e-2)
    np.testing.assert_allclose(got.float().numpy(), unrouted.float().numpy(),
                               rtol=4e-2, atol=4e-2)


def test_block_impl_turns_down_oversize_unlisted_and_non_span():
    jplan, params = _toy_net()
    tplan, model = _toy_detector((jplan, params))
    x = torch.zeros((2, 32, 32, 128), dtype=torch.bfloat16)
    assert TR.make_resblock_impl(tplan, max_hw=16)(x, model.convs, 1) is None
    assert TR.make_resblock_impl(tplan, chain_whitelist=frozenset())(
        x, model.convs, 1) is None
    impl = TR.make_resblock_impl(tplan)
    assert impl(x, model.convs, 0) is None
    assert impl(x, model.convs, 4) is None, "mid-chain spans are not starts"
    out, consumed = impl(x, model.convs, 1)
    assert consumed == 6 and out.shape == x.shape
    # a package that lacks one conv of the chain: the chain stays bf16
    partial = {1: None, 2: None, 4: None}
    out8, _ = TR.make_resblock_impl(tplan, int8_pkg=partial)(
        x, model.convs, 1)
    assert torch.equal(out8, out)


# ---------------------------------------------------------------------------
# the slice as a whole: the serving steps with the chain route

H, W_, S, K, FRAMES = 64, 128, 2, 2, 4


@pytest.fixture(scope="module")
def small():
    """A small residual detector (the toy cfg: 64x64 input, width 128, two
    residual blocks at 32x32) with seeded weights aimed at small boxes, both
    packages' forms of it, two streams of 64x128 frames, and ONE int8
    package (the JAX package's, calibrated from the frames)."""
    defs = _parse_text(TOY_CFG)
    jplan, tplan = j_build(defs), build_network(defs)
    blob = random_darknet_weights(jplan.defs(), seed=0, well_conditioned=True)
    _, raw = W.load_darknet_weights(blob, jplan.defs())
    raw = _plant_small_boxes(raw, jplan)
    folded = W.fold_inference_params(raw, jplan.defs())
    frames = np.random.default_rng(0).integers(0, 256, (S, H, W_, 3),
                                               np.uint8)
    pkg = JQ.quantize_darknet_from_frames(jplan, folded, frames, 64)
    assert {1, 2, 4, 5} <= set(pkg)
    xs = jax.vmap(lambda f: j_letterbox(f, 64))(frames)
    return dict(jplan=jplan, tplan=tplan, folded=folded, frames=frames,
                pkg=pkg, xs=xs, detector=darknet_from_raw(tplan, raw),
                reid=reid_from_params(random_reid_params(0)),
                j_reid=j_reid_params(0))


@pytest.fixture(scope="module")
def gap_threshold(small):
    """get(mode) -> a threshold in the widest gap of the routed forward's
    objectness (ranks 5-25), so that a bf16 ulp flips no candidate; the
    reference's routed forward runs once per mode for the file."""
    thresholds = {}

    def get(mode):
        if mode not in thresholds:
            impl = JR.make_resblock_impl(
                small["jplan"], interpret=True,
                int8_pkg=small["pkg"] if mode == "int8" else None)
            dec = np.asarray(network_apply(small["jplan"], small["folded"],
                                           small["xs"], block_impl=impl))
            obj = np.sort(dec[..., 4].ravel())[::-1][4:26]
            gap = int(np.argmax(obj[:-1] - obj[1:]))
            thresholds[mode] = float((obj[gap] + obj[gap + 1]) / 2)
        return thresholds[mode]

    return get


def _routes(mode):
    """(the port's use_resblock, the JAX package's) for one mode."""
    if mode == "int8":
        return "int8", {"int8": True, "interpret": True}
    return True, "interpret"


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_bucketed_step_and_detect_stage_with_chains_match_jax(
        small, gap_threshold, mode):
    t_route, j_route = _routes(mode)
    pkg = small["pkg"] if mode == "int8" else None
    det_cfg = DetectorConfig(img_size=64, max_dets=8,
                             conf_thres=gap_threshold(mode))
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    kw = dict(buckets=(4, 8), windows=((16, 16), (32, 40), (48, 64)))
    frames = np.broadcast_to(small["frames"][None], (K, S, H, W_, 3)).copy()
    j_step = JS.BucketedScannedStep(
        small["jplan"], det_cfg, trk_cfg, (H, W_), donate_state=False,
        use_resblock=j_route, backbone_int8_pkg=pkg, **kw)
    t_step = TS.make_scanned_step_bucketed(
        small["detector"], small["reid"], det_cfg, trk_cfg, (H, W_),
        use_resblock=t_route, backbone_int8_pkg=pkg, **kw)
    direct = TS.make_scanned_detect_stage(
        small["detector"], det_cfg, trk_cfg, (H, W_), use_resblock=t_route,
        backbone_int8_pkg=pkg)(_t(frames))
    unrouted = TS.make_scanned_detect_stage(
        small["detector"], det_cfg, trk_cfg, (H, W_))(_t(frames))
    j_states = JS.init_stream_states(trk_cfg, S)
    t_states = TS.init_stream_states(trk_cfg, S, "cpu")
    emitted = 0
    for c in range(2):
        j_handle = j_step.detect(small["folded"], jnp.asarray(frames))
        t_handle = t_step.detect(_t(frames))
        for got, want in zip(t_handle[1:4], direct):
            assert torch.equal(got, want)
        j_b7, j_mask, j_stats = (np.array(a) for a in j_handle[1:])
        np.testing.assert_array_equal(t_handle[2].numpy(), j_mask)
        assert j_mask.sum() >= 2 * K * S
        valid = j_mask[..., None]
        np.testing.assert_allclose(np.where(valid, t_handle[1].numpy(), 0),
                                   np.where(valid, j_b7, 0), atol=1,
                                   rtol=0)
        np.testing.assert_array_equal(t_handle[3].numpy()[[0, 3, 4]],
                                      j_stats[[0, 3, 4]])
        # the track stage on the SAME detections: rows exactly equal
        j_states, (j_out, j_emit) = j_step.track(small["j_reid"], j_states,
                                                 j_handle)
        same = (t_handle[0], _t(j_b7), _t(j_mask), _t(j_stats))
        t_states, (t_out, t_emit) = t_step.track(t_states, same)
        np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
        emitted += int(t_emit.sum())
    assert emitted > 0, "tracks confirmed and were emitted"
    assert not torch.equal(direct[0], unrouted[0]), "the route changed bits"


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_make_batched_step_with_chains_matches_jax(small, gap_threshold,
                                                   mode):
    t_route, j_route = _routes(mode)
    pkg = small["pkg"] if mode == "int8" else None
    det_cfg = DetectorConfig(img_size=64, max_dets=8,
                             conf_thres=gap_threshold(mode))
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    j_step = JS.make_batched_step(small["jplan"], det_cfg, trk_cfg, (H, W_),
                                  donate_state=False, use_resblock=j_route,
                                  backbone_int8_pkg=pkg)
    t_step = TS.make_batched_step(small["detector"], small["reid"], det_cfg,
                                  trk_cfg, (H, W_), use_resblock=t_route,
                                  backbone_int8_pkg=pkg)
    j_states = JS.init_stream_states(trk_cfg, S)
    t_states = TS.init_stream_states(trk_cfg, S, "cpu")
    frames = small["frames"]
    emitted = 0
    for f in range(FRAMES):
        j_states, (j_out, j_emit) = j_step(small["folded"], small["j_reid"],
                                           j_states, jnp.asarray(frames))
        t_states, (t_out, t_emit) = t_step(t_states, _t(frames))
        np.testing.assert_array_equal(t_emit.numpy(), np.asarray(j_emit))
        np.testing.assert_array_equal(t_out.numpy()[..., 4],
                                      np.asarray(j_out)[..., 4])
        np.testing.assert_allclose(t_out.numpy()[..., :4],
                                   np.asarray(j_out)[..., :4], atol=1)
        for name in DISCRETE:
            np.testing.assert_array_equal(
                getattr(t_states, name).numpy(),
                np.asarray(getattr(j_states, name)), err_msg=f"{f}: {name}")
        emitted += int(t_emit.sum())
    assert emitted > 0


def test_resblock_route_values(small):
    """``use_resblock``: ``"int8"`` and the dict form with ``int8`` need the
    package; the reference's CPU-test values have no meaning here and are
    refused by name; the dict form restricts the route to listed chains."""
    det_cfg = DetectorConfig(img_size=64, max_dets=8)
    trk_cfg = TrackerConfig(max_tracks=16, max_dets=8, nn_budget=4)
    args = (small["detector"], det_cfg, trk_cfg, (H, W_))
    for route in ("int8", {"int8": True}):
        with pytest.raises(ValueError, match="requires backbone_int8_pkg"):
            TS.make_scanned_detect_stage(*args, use_resblock=route)
    with pytest.raises(ValueError, match="'interpret'"):
        TS.make_scanned_detect_stage(*args, use_resblock="interpret")
    with pytest.raises(ValueError, match="interpret"):
        TS.make_scanned_detect_stage(*args,
                                     use_resblock={"interpret": True})
    frames = _t(small["frames"][None].copy())
    on = TS.make_scanned_detect_stage(*args, use_resblock=True)(frames)
    listed = TS.make_scanned_detect_stage(
        *args, use_resblock={"chains": [1]})(frames)
    unlisted = TS.make_scanned_detect_stage(
        *args, use_resblock={"chains": []})(frames)
    off = TS.make_scanned_detect_stage(*args)(frames)
    assert torch.equal(on[0], listed[0])
    assert torch.equal(off[0], unlisted[0])
    assert not torch.equal(on[0], off[0])
    # composable with a conv route: the chain claims its span first, the
    # conv hook sees the remaining layers
    both = TS.make_scanned_detect_stage(
        *args, use_resblock="int8", use_pallas_conv=True,
        backbone_int8_pkg=small["pkg"])(frames)
    chains = TS.make_scanned_detect_stage(
        *args, use_resblock="int8", backbone_int8_pkg=small["pkg"])(frames)
    assert torch.equal(both[0], chains[0]), (
        "every packaged layer of the toy net lies inside the chain")
