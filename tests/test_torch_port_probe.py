"""The int8 matmul probe of the port (``tools/int8_probe.py``: kernel 10's
plain versions) against the expressions of the reference tool.

The reference's tiled kernel is nested in its ``main()`` and cannot be
imported, so its body (``jnp.dot(..., preferred_element_type=...)``, and for
int8 ``clip(acc // (8 K), -127, 127)``) is written out here, at M = 512 (one
tile of the reference's grid). int8: exactly equal (integer sums, floor
division). bf16: within 1 bf16 ulp (f32 sums of K products in another
order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from yolo_deepsort_tpu_torch.tools import int8_probe as P
from torch_port_threads import torch_threads  # noqa: F401

M, K, N = 512, 256, 256


def _operands():
    xb, wb, xi, wi = P.probe_operands(M, K, N, "cpu", seed=0)
    return xb, wb, xi, wi


def test_probe_plain_int8_equals_the_reference_expression():
    _, _, xi, wi = _operands()
    acc = jnp.dot(jnp.asarray(xi.numpy()), jnp.asarray(wi.numpy()),
                  preferred_element_type=jnp.int32)
    want = np.asarray(jnp.clip(acc // (8 * K), -127, 127).astype(jnp.int8))
    before = P.launches
    got = P.matmul_probe(xi, wi)
    assert P.launches == before, "CPU tensors take the plain version"
    assert got.dtype == torch.int8 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).any() and (want > 0).any()
    # floor, not truncation: sums in (-8K, 0) give -1
    neg = (np.asarray(acc) < 0) & (np.asarray(acc) > -8 * K)
    assert neg.any() and (got.numpy()[neg] == -1).all()


def test_probe_plain_bf16_within_one_ulp_of_the_reference_expression():
    xb, wb, _, _ = _operands()
    want = np.asarray(jnp.dot(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        jnp.asarray(wb.float().numpy(), jnp.bfloat16),
        preferred_element_type=jnp.float32).astype(jnp.bfloat16), np.float32)
    got = P.matmul_probe(xb, wb)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert P.bf16_ulps(got, torch.from_numpy(want)) <= 1


def _rows_summing_to(sums, k):
    """int8 rows whose entries sum to the given values (|sum| <= 127 k)."""
    x = torch.zeros((len(sums), k), dtype=torch.int8)
    for r, s in enumerate(sums):
        full, last = divmod(abs(s), 127)
        sign = 1 if s >= 0 else -1
        x[r, :full] = sign * 127
        if last:
            x[r, full] = sign * last
    return x


def test_probe_floor_division_and_clip():
    """Column 0 of w is all ones, so its output is the row sum: sums in
    (-8 K, 0) give -1 (floor; C's division would give 0), -8 K gives -1,
    -8 K - 1 gives -2, 8 K - 1 gives 0. Column 1 is all 127: large sums
    clip to +-127."""
    k, n = 256, 128
    sums = [-1, -2047, -2048, -2049, 2047, 2048, 32512, -32512]
    x = _rows_summing_to(sums, k)
    w = torch.zeros((k, n), dtype=torch.int8)
    w[:, 0] = 1
    w[:, 1] = 127
    assert (x.long() @ w.long())[:, 0].tolist() == sums
    got = P.matmul_probe(x, w)
    assert got[:, 0].tolist() == [-1, -1, -1, -2, 0, 1, 15, -16]
    assert got[:, 1].tolist() == [-1, -127, -127, -127, 126, 127, 127, -127]


def test_probe_refuses_and_needs_the_card():
    xb, wb, xi, wi = _operands()
    with pytest.raises(ValueError, match="one dtype"):
        P.matmul_probe(xb, wi)
    with pytest.raises(ValueError, match=r"\(M, K\) x \(K, N\)"):
        P.matmul_probe(xi, wi[:100])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.run_probe(64, 32, 128)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            P.run_probe(64, 32, 128, device="cpu")


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_probe_packed_weight_gives_the_same_plain_product(dtype):
    """The tool packs its fixed (K, N) weight once to the K-major (N, ldw)
    rows the kernel reads (``pack_probe_weight``: ``pack_conv_weights`` of
    the (1, 1, K, N) view); the plain product from the packed form is the
    raw form's, bit for bit."""
    xb, wb, xi, wi = _operands()
    x, w = (xb, wb) if dtype == "bf16" else (xi, wi)
    p = P.pack_probe_weight(w)
    assert (p.k, p.ci, p.co) == (1, K, N)
    assert p.data.shape == (N, K) and p.data.dtype == w.dtype
    assert torch.equal(p.data, w.t())
    before = P.launches
    assert torch.equal(P.matmul_probe(x, p), P.matmul_probe(x, w))
    assert P.launches == before
    with pytest.raises(ValueError, match=r"\(K, N\) weights"):
        P.pack_probe_weight(w[None])


def test_probe_plan_takes_the_tiles_the_kernel_instantiates():
    """Kernel 10 takes the conv planner's plan for a 1x1 conv of M pixels,
    N output channels and depth K (no plan table of its own): at every
    shape a tile among the three ``csrc/matmul_probe.cu`` instantiates. The
    plan sweep times it at the probe's default shape."""
    from yolo_deepsort_tpu_torch.ops import conv_plan as CP
    from yolo_deepsort_tpu_torch.tools import conv_plan_sweep as S

    assert S.PROBE_CLASSES == ((32768, 256, 256),)
    for es, depth_steps in ((2, 4), (1, 2)):
        plan = CP.plan_conv_tiles(32768, 256, 256, es)
        assert (plan.bm, plan.bn) in P.PROBE_TILES
        assert CP.check_plan(plan, 256, es) == plan
        assert CP.depth_steps(256, es) == depth_steps
    for m, k, n in ((32768, 256, 256), (1000, 64, 128), (3, 32, 128),
                    (512, 256, 256), (100000, 512, 1024)):
        for es in (1, 2):
            plan = CP.plan_conv_tiles(m, n, k, es)
            assert (plan.bm, plan.bn) in P.PROBE_TILES, (m, k, n, es, plan)
