"""The port's int8 weight matmul (kernel #12's module) against the JAX
package.

The JAX side runs `spn4cir_tpu.ops.quant_matmul.quant_matmul`, the Pallas
kernel, in interpret mode on this CPU host, as the JAX package's own tests
do. The port side runs `quant_matmul_reference`, the plain version that the
CUDA kernel is held against on the card, and the wrapper, which takes the
plain version for a CPU tensor and counts no launch. Inputs are numpy
arrays from a seed, handed to both sides.

Tolerances: float32 x 1e-5 (float32 sums in another order); bf16 x 2e-2
(one rounding of the output to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spn4cir_tpu.ops.quant_matmul import quant_matmul as jax_quant_matmul
from spn4cir_tpu_torch.ops import quant_matmul as qm

torch.set_num_threads(1)


def _weights(rng, d, f):
    w = rng.standard_normal((d, f)).astype(np.float32)
    scales = np.maximum(np.abs(w).max(axis=0), 1e-12) / 127.0
    vals = np.clip(np.round(w / scales), -127, 127).astype(np.int8)
    return vals, scales.astype(np.float32)


@pytest.mark.parametrize("shape,d,f", [
    ((8, ), 128, 256), ((3, ), 128, 256), ((8, ), 256, 160), ((1, ), 64, 512),
    ((2, 5), 64, 128), ((37, ), 64, 77)])
def test_plain_version_matches_the_tpu_kernel(shape, d, f):
    rng = np.random.RandomState(sum(shape) + d + f)
    vals, scales = _weights(rng, d, f)
    x = rng.standard_normal((*shape, d)).astype(np.float32)
    want = np.asarray(jax_quant_matmul(jnp.asarray(x), jnp.asarray(vals),
                                       jnp.asarray(scales)))
    got = qm.quant_matmul_reference(torch.from_numpy(x),
                                    torch.from_numpy(vals),
                                    torch.from_numpy(scales))
    assert got.shape == (*shape, f)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_plain_version_matches_the_tpu_kernel_bf16():
    rng = np.random.RandomState(7)
    vals, scales = _weights(rng, 64, 200)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jax_quant_matmul(jx, jnp.asarray(vals), jnp.asarray(scales))
    assert want.dtype == jnp.bfloat16
    got = qm.quant_matmul_reference(
        torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(vals), torch.from_numpy(scales))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.RandomState(8)
    vals, scales = _weights(rng, 40, 77)
    x = torch.from_numpy(rng.standard_normal((5, 40)).astype(np.float32))
    before = qm.quant_matmul.launches
    got = qm.quant_matmul(x, torch.from_numpy(vals), torch.from_numpy(scales))
    assert qm.quant_matmul.launches == before
    assert torch.equal(got, qm.quant_matmul_reference(
        x, torch.from_numpy(vals), torch.from_numpy(scales)))


# clusters of n = 1..16 blocks the H100 holds at once (the occupancy API,
# read on the card for every instantiation alike; PERF.md)
H100_CLUSTERS = (264, 132, 79, 62, 47, 39, 32, 30, 23, 21, 16, 16, 14, 14,
                 14, 14)


@pytest.mark.parametrize("rows,d,f", [
    (1, 4096, 4096), (16, 4096, 11008), (8, 11008, 4096), (16, 4096, 32000),
    (5, 40, 77), (33, 300, 130), (1, 100, 1), (17, 11008, 4096),
    (16, 4096, 4096)])
def test_split_plan_covers_d_in_whole_chunks(rows, d, f):
    """D is cut into splits of whole stages that cover it once, as many as
    keep every cluster resident at once; the plan is pure."""
    nt, per, n = qm.split_plan(rows, d, f, H100_CLUSTERS)
    assert (nt, per, n) == qm.split_plan(rows, d, f, H100_CLUSTERS)
    assert nt == (1 if rows <= 8 else 2)
    assert (n - 1) * per < d <= n * per and per % qm.DEPTH == 0
    tiles = -(-rows // (8 * nt)) * -(-f // qm.COLS)
    assert 1 <= n <= qm.MAX_SPLITS
    assert n == 1 or tiles <= H100_CLUSTERS[n - 1]
    # no split count whose clusters fit gives shorter splits
    steps = -(-d // qm.DEPTH)
    for m in range(1, min(qm.MAX_SPLITS, steps) + 1):
        if m == 1 or tiles <= H100_CLUSTERS[m - 1]:
            assert -(-steps // m) >= per // qm.DEPTH


def test_split_plan_at_the_decode_shapes():
    """The H100's readings: 5 splits of (4096, 11008), 12 of (11008,
    4096), 2 of the lm_head; one split when the tiles outnumber the
    resident blocks."""
    assert qm.split_plan(16, 4096, 11008, H100_CLUSTERS)[2] == 5
    assert qm.split_plan(16, 11008, 4096, H100_CLUSTERS)[2] == 12
    assert qm.split_plan(1, 4096, 32000, H100_CLUSTERS)[2] == 2
    assert qm.split_plan(16, 4096, 70000, H100_CLUSTERS)[2] == 1


# --------------------------------------------------------------------------
# The kernel's arithmetic, emulated in numpy.
# --------------------------------------------------------------------------

def _bf16(x):
    """float32 -> the nearest bf16 (ties to even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _split3(x):
    """x -> (hi, mid, lo) bf16 terms as the kernel's split3: each the
    nearest bf16 of what the earlier ones left (float32 differences)."""
    x = np.asarray(x, np.float32)
    hi = _bf16(x)
    r = (x - hi).astype(np.float32)
    mid = _bf16(r)
    lo = _bf16((r - mid).astype(np.float32))
    return hi, mid, lo


@settings(max_examples=400, deadline=None)
@given(st.floats(min_value=-30.0, max_value=30.0),
       st.floats(min_value=1.0, max_value=10.0), st.booleans())
def test_three_bf16_terms_sum_to_the_float32_value(exp10, mant, neg):
    """hi + mid + lo == x exactly for float32 x of magnitude 1e-30 to
    1e30, each term a bf16 value."""
    x = np.float32((-1.0 if neg else 1.0) * mant * 10.0 ** exp10)
    hi, mid, lo = _split3(x)
    for t in (hi, mid, lo):
        assert _bf16(t) == t
    assert float(hi) + float(mid) + float(lo) == float(x)


def test_int8_widens_to_bf16_exactly():
    """The kernel's widening, for every byte: (b & 0x7f) | 0x4300 and
    (b & 0x80) | 0xc300 are bf16 values whose sum is the int8 value."""
    b = np.arange(256, dtype=np.uint32)
    mag = (((b & 0x7F) | 0x4300) << 16).astype(np.uint32).view(np.float32)
    off = (((b & 0x80) | 0xC300) << 16).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(mag + off,
                                  b.astype(np.uint8).view(np.int8))


def test_fragments_give_x_at_w():
    """The lane layout of `mma.sync.m16n8k16` as the kernel fills it: lane
    (g, t) holds W rows 4t..4t+3 and columns 8g..8g+7 of a 16 x 64 tile,
    M tile i's rows m = g, g + 8 being columns 8g + 2i, 8g + 2i + 1, and
    x[row][4t..4t+3] as its B fragment. The products over the fragments,
    written back as the epilogue does, are x @ W."""
    rng = np.random.RandomState(0)
    w = rng.randint(-127, 128, (16, 64)).astype(np.float64)
    x = rng.randn(16, 16)
    y = np.zeros((16, 64))
    for i in range(4):
        for n in range(2):
            a = np.zeros((16, 16))    # the M tile, row-major (m, k)
            bm = np.zeros((16, 8))    # the n8 tile, (k, n)
            for g in range(8):
                for t in range(4):
                    rows = [4 * t + j for j in range(4)]
                    # a0: (g, 2t..2t+1) <- rows 4t, 4t+1 at column 8g + 2i
                    a[g, 2 * t:2 * t + 2] = w[rows[:2], 8 * g + 2 * i]
                    a[g + 8, 2 * t:2 * t + 2] = w[rows[:2], 8 * g + 2 * i + 1]
                    a[g, 2 * t + 8:2 * t + 10] = w[rows[2:], 8 * g + 2 * i]
                    a[g + 8, 2 * t + 8:2 * t + 10] = w[rows[2:],
                                                       8 * g + 2 * i + 1]
                    # b0: (2t..2t+1, g), b1: (2t+8..2t+9, g)
                    bm[2 * t:2 * t + 2, g] = x[8 * n + g, rows[:2]]
                    bm[2 * t + 8:2 * t + 10, g] = x[8 * n + g, rows[2:]]
            c = a @ bm                # (m, n)
            for g in range(8):
                for t in range(4):
                    for e in range(2):
                        for h in range(2):
                            y[8 * n + 2 * t + e, 8 * g + 2 * i + h] = \
                                c[g + 8 * h, 2 * t + e]
    np.testing.assert_allclose(y, x @ w, rtol=1e-12, atol=1e-9)


def _emulate(x, vals, scales):
    """y as the kernel sums it: float32 x in three bf16 terms; per split
    (the H100 plan), per 64-deep stage, per depth warp a zeroed tile of
    the lo, mid, hi products over its 32 rows, added to the warp's float32
    sums; the depth warps in order, the splits in order; then the scale."""
    rows, d = x.shape
    _, per, n = qm.split_plan(rows, d, vals.shape[1], H100_CLUSTERS)
    terms = [t.astype(np.float64) for t in _split3(x)][::-1]
    w = vals.astype(np.float64)
    total = np.zeros((rows, vals.shape[1]), np.float32)
    for sp in range(n):
        warps = [np.zeros_like(total) for _ in range(2)]
        for k0 in range(sp * per, min(d, (sp + 1) * per), qm.DEPTH):
            for dw in range(2):
                ks = slice(k0 + 32 * dw, min(d, k0 + 32 * dw + 32))
                stage = np.zeros(total.shape)
                for t in terms:
                    stage = stage + t[:, ks] @ w[ks]
                warps[dw] = (warps[dw] + stage.astype(np.float32)).astype(
                    np.float32)
        total = (total + (warps[0] + warps[1])).astype(np.float32)
    return (total * scales).astype(np.float32)


@pytest.mark.parametrize("rows,d,f,spread", [
    (16, 11008, 48, False), (3, 4096, 40, False), (16, 700, 24, True)])
def test_three_term_product_meets_the_tolerance(rows, d, f, spread):
    """The emulated product against float64 and against the Pallas kernel
    in interpret mode, within QMM_TOL (1e-5 of max|y|), at the 7B's widest
    depth and with |x| spanning 1e-6 to 1e3 in one row."""
    rng = np.random.RandomState(rows + d)
    vals, scales = _weights(rng, d, f)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    if spread:
        x[0] = (np.sign(x[0]) * 10.0 ** rng.uniform(-6, 3, d)).astype(
            np.float32)
    got = _emulate(x, vals, scales)
    exact = (x.astype(np.float64) @ vals.astype(np.float64)) * scales
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-5 * scale)
    want = np.asarray(jax_quant_matmul(jnp.asarray(x), jnp.asarray(vals),
                                       jnp.asarray(scales)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
