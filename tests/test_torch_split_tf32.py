"""The dense-bank InfoNCE backward's split-TF32 arithmetic, emulated in
numpy, against float64 and against the JAX package's Pallas kernel; and the
backward's plan (grid, scratch, route of the logits).

The CUDA kernels (`bank_infonce_coef_tc_kernel`, `bank_infonce_dq_tc_kernel`
in csrc/bank_infonce.cu) run only on the card (tests/test_torch_cuda.py,
chip_smoke.py). Their arithmetic is emulated here as they do it: each
float32 operand is split into hi = x rounded to TF32 (half a TF32 unit added
to the bits, the low 13 bits masked) and lo = x - hi, which the tensor core
reads with its low 13 bits masked; the product of one 8-deep step is
lo·hi + hi·lo + hi·hi (lo·hi + hi·hi over a bf16 bank, exact in TF32);
a 32-deep stage of those is summed exactly (float64), rounded once to
float32 and added to the float32 accumulator; the coefficient
(exp(l/tau - mx)/se - onehot)·g is formed in float32; the dQ product runs per split of the bank's 128-row
tiles (`dense_bwd_plan`) and the splits are summed in index order.

Tolerances: those of the kernels on the card (chip_smoke.py BANK_RTOL,
BANK_DQ_ATOL): the emulated dQ within atol 1e-6 + rtol 1e-4 of float64,
and so is the Pallas kernel run in interpret mode (as
tests/test_bank_kernel.py runs it), a float32 computation in another
order; the two are then within twice that of each other, which is what is
asserted between them (at B = 5 or 8 with tau = 0.02 each lies up to ~0.6
of the bound from float64, on opposite sides). The split's own residual is
below 2^-21 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.ops.bank_kernels import bank_infonce_pallas
from spn4cir_tpu_torch.ops import bank_kernels as bk

BANK_RTOL = 1e-4
BANK_DQ_ATOL = 1e-6
MASK = np.uint32(0xFFFFE000)


def tf32_hi(x):
    """x rounded to TF32 as the kernel's `split_tf32` does."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & MASK).view(np.float32)


def tf32_read(x):
    """What a tensor core reads of a .tf32 operand: the top 19 bits."""
    return (np.asarray(x, np.float32).view(np.uint32) & MASK).view(np.float32)


def split(x):
    hi = tf32_hi(x)
    return hi, tf32_read((np.asarray(x, np.float32) - hi).astype(np.float32))


def mma_3xtf32(a, b, exact_b, stage=32):
    """a (I, K) @ b (K, J) as the kernels: per 32-deep stage a fresh partial
    of lo·hi + hi·lo + hi·hi, rounded to float32 and added in float32."""
    ah, al = split(a)
    bh, bl = (b.astype(np.float32), np.zeros_like(b, np.float32)) \
        if exact_b else split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], stage):
        s = slice(k0, k0 + stage)
        a_hi, a_lo, b_hi, b_lo = (t.astype(np.float64) for t in
                                  (ah[:, s], al[:, s], bh[s], bl[s]))
        part = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


def emulate_backward(q, bank, exact_b, labels, tau, mx, se, gout, plan):
    """dQ of the dense backward as the split-TF32 kernels compute it."""
    b, m = q.shape[0], bank.shape[0]
    logits = mma_3xtf32(q, bank.T, exact_b)
    tau32 = np.float32(tau)
    p = (np.exp((logits / tau32).astype(np.float32) - mx[:, None])
         .astype(np.float32) / se[:, None]).astype(np.float32)
    p[np.arange(b), labels] -= np.float32(1.0)
    coef = (p * np.float32(gout / (b * tau))).astype(np.float32)
    rows = plan.tiles_per_split * bk.TILE_COLS
    dq = np.zeros((b, q.shape[1]), np.float32)
    for i in range(plan.n_splits):
        part = mma_3xtf32(coef[:, i * rows:(i + 1) * rows],
                          bank[i * rows:(i + 1) * rows], exact_b)
        dq = (dq + part).astype(np.float32)
    assert (plan.n_splits - 1) * rows < m <= plan.n_splits * rows
    return dq


def float64_backward(q, bank, labels, tau, mx, se, gout):
    """The backward's formula in float64 from the same saved (mx, se)."""
    b = q.shape[0]
    logits = q.astype(np.float64) @ bank.astype(np.float64).T / tau
    p = np.exp(logits - mx[:, None].astype(np.float64)) / se[:, None]
    p[np.arange(b), labels] -= 1.0
    return (p * (gout / (b * tau))) @ bank.astype(np.float64)


def _norm(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _case(rng, b, m, d, dtype):
    q = _norm(rng.randn(b, d))
    bank = _norm(rng.randn(m, d))
    if dtype == "bfloat16":  # the rounded values, as the card holds them
        bank = torch.from_numpy(bank).to(torch.bfloat16).float().numpy()
    labels = rng.randint(0, m, size=b).astype(np.int64)
    tau = 0.02
    mx, se, _, _ = (t.numpy() for t in bk.bank_infonce_stats_reference(
        torch.from_numpy(q), torch.from_numpy(bank), torch.from_numpy(labels),
        tau))
    return q, bank, labels, tau, mx, se


@pytest.mark.parametrize("x_scale", [1e-30, 1e-3, 1.0, 3e4])
def test_split_leaves_less_than_2_to_the_minus_21(x_scale, rng):
    x = (rng.randn(4096) * x_scale).astype(np.float32)
    hi, lo = split(x)
    for t in (hi, lo):  # both are TF32 values
        assert not (t.view(np.uint32) & np.uint32(0x1FFF)).any()
    resid = np.abs(x.astype(np.float64) - hi - lo)
    assert (resid <= 2.0 ** -21 * np.abs(x.astype(np.float64))).all()
    # hi is x to the nearest TF32 value: half a unit of its 10-bit mantissa
    assert (np.abs(x.astype(np.float64) - hi)
            <= 2.0 ** -11 * np.abs(x.astype(np.float64))).all()


def test_bf16_values_are_exact_in_tf32(rng):
    """A bf16 bank needs no lo: its values are TF32 values already."""
    x = torch.from_numpy(rng.randn(4096).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    hi, lo = split(x)
    np.testing.assert_array_equal(hi, x)
    assert not lo.any()


@pytest.mark.parametrize("b,m,d", [(8, 300, 256), (5, 1100, 512),
                                   (16, 700, 640), (32, 1100, 768)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_tf32_backward_matches_float64_and_pallas(b, m, d, dtype, rng):
    q, bank, labels, tau, mx, se = _case(rng, b, m, d, dtype)
    # a small card, so that the bank is cut into several splits
    plan = bk.dense_bwd_plan(b, m, d, sm_count=16)
    assert plan.tc_logits and plan.n_splits > 1
    got = emulate_backward(q, bank, dtype == "bfloat16", labels, tau, mx, se,
                           1.0, plan)
    want = float64_backward(q, bank, labels, tau, mx, se, 1.0)
    np.testing.assert_allclose(got, want, atol=BANK_DQ_ATOL, rtol=BANK_RTOL)
    jbank = jnp.asarray(bank)
    if dtype == "bfloat16":
        jbank = jbank.astype(jnp.bfloat16)
    dq = np.asarray(jax.grad(lambda q_: bank_infonce_pallas(
        q_, jbank, jnp.asarray(labels), jnp.float32(tau), 8, 128))(
        jnp.asarray(q)))
    np.testing.assert_allclose(dq, want, atol=BANK_DQ_ATOL, rtol=BANK_RTOL)
    np.testing.assert_allclose(got, dq, atol=2 * BANK_DQ_ATOL,
                               rtol=2 * BANK_RTOL)


@pytest.mark.parametrize("d", [16, 64, 128])
def test_split_tf32_dq_product_holds_at_shallow_depths(d, rng):
    """Below D = 256 only the dQ product runs in split TF32 (the logits run
    in float32 on the CUDA cores): from the same float32 coefficient it
    stays within the tolerance of the product in float64."""
    b, m = 9, 1000
    bank = _norm(rng.randn(m, d))
    coef = (rng.rand(b, m) * 1e-3).astype(np.float32)
    coef[np.arange(b), rng.randint(0, m, size=b)] -= np.float32(1.0)
    got = mma_3xtf32(coef, bank, False)
    want = coef.astype(np.float64) @ bank.astype(np.float64)
    np.testing.assert_allclose(got, want, atol=BANK_DQ_ATOL, rtol=BANK_RTOL)


@pytest.mark.parametrize("b,m,d", [(256, 65536, 640), (256, 65536, 512),
                                   (128, 65536, 256), (5, 2049, 512),
                                   (70, 4001, 768), (9, 130, 16),
                                   (1, 1, 16), (3, 300, 1040)])
@pytest.mark.parametrize("sms", [1, 132])
def test_dense_bwd_plan_covers_the_bank_with_no_empty_split(b, m, d, sms):
    plan = bk.dense_bwd_plan(b, m, d, sms)
    tiles = -(-m // bk.TILE_COLS)
    assert plan.tiles_per_split * plan.n_splits >= tiles
    assert plan.tiles_per_split * (plan.n_splits - 1) < tiles
    assert (plan.tiles_per_split, plan.n_splits) == bk.split_plan(
        m, b, sms, bk.DQ_CTAS_PER_SM, -(-d // bk.DQ_COLS))
    # scratch: the coefficient over whole bank tiles, one dQ per split
    assert plan.coef_shape == (b, tiles * bk.TILE_COLS)
    assert plan.dq_part_shape == (plan.n_splits, b, d)
    assert plan.tc_logits == (d >= bk.TC_LOGITS_MIN_D)


def test_dense_bwd_plan_fills_the_card_at_the_recipe_shapes():
    """B=256 x D=640 is 4 x 5 output tiles of the dQ kernel: the bank axis
    is split until the card holds two CTAs an SM."""
    plan = bk.dense_bwd_plan(256, 65536, 640, 132)
    assert (plan.tiles_per_split, plan.n_splits) == (40, 13)
    assert 4 * 5 * plan.n_splits <= 2 * 132
    scratch = 4 * (np.prod(plan.coef_shape) + np.prod(plan.dq_part_shape))
    assert scratch == 4 * (256 * 65536 + 13 * 256 * 640)
