"""The bank InfoNCE forward's and backward's split-TF32 arithmetic, over a
dense and over an int8 bank, emulated in numpy, against float64 and against
the JAX package's Pallas kernels; and the two plans (grid, scratch, route of
the logits), which are the same for every bank type.

The CUDA kernels (`bank_infonce_fwd_tc_kernel`, `bank_infonce_coef_tc_kernel`,
`bank_infonce_dq_tc_kernel` in csrc/bank_infonce.cu) run only on the card
(tests/test_torch_cuda.py,
chip_smoke.py). Their arithmetic is emulated here as they do it: each
float32 operand is split into hi = x rounded to TF32 (half a TF32 unit added
to the bits, the low 13 bits masked) and lo = x - hi, which the tensor core
reads with its low 13 bits masked; the product of one 8-deep step is
lo·hi + hi·lo + hi·hi (lo·hi + hi·hi over a bf16 bank or int8 values,
both exact in TF32); a 32-deep stage of those is summed exactly (float64),
rounded once to float32 and added to the float32 accumulator; the
coefficient (exp(l/tau - mx)/se - onehot)·g is formed in float32, over an
int8 bank from l = acc·s/tau and multiplied by s after; the dQ product runs
per split of the bank's 128-row tiles (`bwd_plan`) and the splits are
summed in index order. The forward forms the same logits, l = acc/tau (int8:
acc·s/tau), and folds them into running (mx, se, el, pos) in the kernel's
order: per bank tile, each thread over its 8 columns of the tile (lane t of
column warp w owns columns 32w + 8n + 2t + e); then, once per split, the
four lanes of a row merged (t xor 1, then xor 2), the four column warps in
order, and the splits of `fwd_plan` in index order.

Tolerances: those of the kernels on the card (chip_smoke.py BANK_RTOL,
BANK_DQ_ATOL): the emulated dQ within atol 1e-6 + rtol 1e-4 of float64,
and so is the Pallas kernel run in interpret mode (as
tests/test_bank_kernel.py runs it), a float32 computation in another
order; the two are then within twice that of each other, which is what is
asserted between them (at B = 5 or 8 with tau = 0.02 each lies up to ~0.6
of the bound from float64, on opposite sides). The forward's statistics and
loss hold those of the smoke's phase 3c (atol = rtol = 1e-4), dtau_unit
1e-3 absolute, against float64 and against the Pallas forward. The split's
own residual is below 2^-21 relative.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.ops import bank_kernels as jbk
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


def emulate_backward(q, bank, exact_b, labels, tau, mx, se, gout, plan,
                     scales=None):
    """dQ of the backward as the split-TF32 kernels compute it; `scales`:
    an int8 bank's, with `bank` its values as float32."""
    b, m = q.shape[0], bank.shape[0]
    logits = mma_3xtf32(q, bank.T, exact_b)
    if scales is not None:
        logits = (logits * scales[None, :]).astype(np.float32)
    tau32 = np.float32(tau)
    p = (np.exp((logits / tau32).astype(np.float32) - mx[:, None])
         .astype(np.float32) / se[:, None]).astype(np.float32)
    p[np.arange(b), labels] -= np.float32(1.0)
    coef = (p * np.float32(gout / (b * tau))).astype(np.float32)
    if scales is not None:
        coef = (coef * scales[None, :]).astype(np.float32)
    rows = plan.tiles_per_split * bk.TILE_COLS
    dq = np.zeros((b, q.shape[1]), np.float32)
    for i in range(plan.n_splits):
        part = mma_3xtf32(coef[:, i * rows:(i + 1) * rows],
                          bank[i * rows:(i + 1) * rows], exact_b)
        dq = (dq + part).astype(np.float32)
    assert (plan.n_splits - 1) * rows < m <= plan.n_splits * rows
    return dq


def _merge(a, b):
    """split_merge::merge_stats of two (mx, se, el) partials, per row, in
    float32: (mx, se, el) of a, then b."""
    (m, s, e), (om, os_, oe) = a, b
    nm = np.maximum(m, om)
    with np.errstate(invalid="ignore"):
        sa = np.where(nm == -np.inf, 0, np.exp(m - nm)).astype(np.float32)
        sb = np.where(nm == -np.inf, 0, np.exp(om - nm)).astype(np.float32)
    keep = nm == -np.inf  # both sides empty: a is kept as it is
    s2 = np.where(keep, s, (s * sa + os_ * sb).astype(np.float32))
    e2 = np.where(keep, e, (e * sa + oe * sb).astype(np.float32))
    return np.where(keep, m, nm), s2, e2


def emulate_forward(q, bank, exact_b, labels, tau, plan, scales=None):
    """(mx, se, pos, el, loss, dtau_unit) of the forward as the split-TF32
    kernel computes them; `scales`: an int8 bank's, with `bank` its values
    as float32."""
    b, m = q.shape[0], bank.shape[0]
    f32 = np.float32
    acc = mma_3xtf32(q, bank.T, exact_b)
    if scales is not None:
        acc = (acc * scales[None, :]).astype(f32)
    logits = (acc / f32(tau)).astype(f32)
    n_tiles = -(-m // bk.TILE_COLS)
    assert (plan.n_splits - 1) * plan.tiles_per_split < n_tiles \
        <= plan.n_splits * plan.tiles_per_split
    mx = np.full(b, -np.inf, f32)
    se, el, pos = (np.zeros(b, f32) for _ in range(3))
    for sp in range(plan.n_splits):
        tiles = range(sp * plan.tiles_per_split,
                      min((sp + 1) * plan.tiles_per_split, n_tiles))
        warps = []
        for w in range(4):
            lanes = []
            for t in range(4):
                lm = np.full(b, -np.inf, f32)
                ls, le, lp = (np.zeros(b, f32) for _ in range(3))
                for tile in tiles:
                    cols = [tile * bk.TILE_COLS + 32 * w + 8 * n + 2 * t + e
                            for n in range(4) for e in range(2)]
                    valid = [c for c in cols if c < m]
                    if not valid:
                        continue
                    lv = logits[:, valid]
                    for c in valid:
                        lp = np.where(labels == c, (lp + logits[:, c])
                                      .astype(f32), lp)
                    nm = np.maximum(lm, lv.max(axis=1))
                    scale = np.exp(lm - nm).astype(f32)
                    s_, e_ = np.zeros(b, f32), np.zeros(b, f32)
                    for j in range(lv.shape[1]):
                        p = np.exp(lv[:, j] - nm).astype(f32)
                        s_ = (s_ + p).astype(f32)
                        e_ = (p.astype(np.float64) * lv[:, j] + e_).astype(f32)
                    ls = (ls * scale + s_).astype(f32)
                    le = (le * scale + e_).astype(f32)
                    lm = nm
                lanes.append((lm, ls, le, lp))
            merged = []
            for a, c in ((0, 1), (2, 3)):
                st = _merge(lanes[a][:3], lanes[c][:3])
                merged.append((*st, (lanes[a][3] + lanes[c][3]).astype(f32)))
            st = _merge(merged[0][:3], merged[1][:3])
            warps.append((*st, (merged[0][3] + merged[1][3]).astype(f32)))
        wm_, ws, we, wp = warps[0]
        for o in warps[1:]:
            wm_, ws, we = _merge((wm_, ws, we), o[:3])
            wp = (wp + o[3]).astype(f32)
        mx, se, el = _merge((mx, se, el), (wm_, ws, we))
        pos = (pos + wp).astype(f32)
    loss = np.mean((np.log(se) + mx - pos).astype(f32), dtype=np.float32)
    dtau = np.mean(((pos - el / se) / f32(tau)).astype(f32), dtype=np.float32)
    return mx, se, pos, el, loss, dtau


def float64_forward(q, bank, labels, tau, scales=None):
    """(mx, se, pos, el, loss, dtau_unit) in float64; `scales`: an int8
    bank's, with `bank` its values."""
    s = np.ones(bank.shape[0]) if scales is None else scales.astype(np.float64)
    logits = q.astype(np.float64) @ bank.astype(np.float64).T * s / tau
    mx = logits.max(axis=1)
    p = np.exp(logits - mx[:, None])
    se, el = p.sum(axis=1), (p * logits).sum(axis=1)
    pos = logits[np.arange(q.shape[0]), labels]
    return (mx, se, pos, el, np.mean(np.log(se) + mx - pos),
            np.mean((pos - el / se) / tau))


def float64_backward(q, bank, labels, tau, mx, se, gout, scales=None):
    """The backward's formula in float64 from the same saved (mx, se);
    `scales`: an int8 bank's, with `bank` its values."""
    b = q.shape[0]
    s = np.ones(bank.shape[0]) if scales is None else scales.astype(np.float64)
    logits = q.astype(np.float64) @ bank.astype(np.float64).T * s / tau
    p = np.exp(logits - mx[:, None].astype(np.float64)) / se[:, None]
    p[np.arange(b), labels] -= 1.0
    return (p * (gout / (b * tau)) * s) @ bank.astype(np.float64)


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


def _q8_case(rng, b, m, d):
    """A unit-row bank quantized as `quantize_bank` does: (q, values as
    float32, scales, labels, tau, mx, se), the statistics from the plain
    int8 forward."""
    q = _norm(rng.randn(b, d))
    qbank = bk.quantize_bank(torch.from_numpy(_norm(rng.randn(m, d))))
    labels = rng.randint(0, m, size=b).astype(np.int64)
    tau = 0.02
    mx, se, _, _ = (t.numpy() for t in bk.bank_infonce_q8_stats_reference(
        torch.from_numpy(q), qbank, torch.from_numpy(labels), tau))
    return (q, qbank.values.numpy().astype(np.float32), qbank.scales.numpy(),
            labels, tau, mx, se)


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


def test_int8_values_are_exact_in_tf32():
    """An int8 bank needs no lo either: every value of -128..127 has at most
    7 significant bits, TF32 holds 11."""
    x = np.arange(-128, 128).astype(np.float32)
    hi, lo = split(x)
    np.testing.assert_array_equal(hi, x)
    assert not lo.any()


def _assert_forward(got, want, what):
    """The smoke's forward tolerances: atol = rtol = 1e-4 on the four
    statistics and the loss, 1e-3 absolute on dtau_unit."""
    names = ("mx", "se", "pos", "el", "loss", "dtau_unit")
    for name, g_, w_ in zip(names[:5], got[:5], want[:5]):
        np.testing.assert_allclose(g_, w_, atol=BANK_RTOL, rtol=BANK_RTOL,
                                   err_msg=f"{name} against {what}")
    np.testing.assert_allclose(got[5], want[5], atol=10 * BANK_RTOL, rtol=0,
                               err_msg=f"dtau_unit against {what}")


FWD_CASES = [(8, 300, 256), (5, 1100, 512), (16, 700, 640)]


@pytest.mark.parametrize("b,m,d", FWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_split_tf32_forward_matches_float64_and_pallas(b, m, d, dtype, rng):
    """The tensor-core forward's statistics (split-TF32 logits, the online
    statistics folded per tile and merged lanes, warps, splits in the
    kernel's order) hold the smoke's tolerances against float64 and against
    the JAX package's Pallas forward in interpret mode, over a float32, a
    bf16 and an int8 bank."""
    # a one-SM card, so that the bank is cut into splits of several tiles
    plan = bk.fwd_plan(b, m, d, sm_count=1)
    assert plan.tc_logits and plan.n_splits > 1 and plan.tiles_per_split > 1
    if dtype == "int8":
        q, vals, scales, labels, tau, _, _ = _q8_case(rng, b, m, d)
        got = emulate_forward(q, vals, True, labels, tau, plan, scales)
        want = float64_forward(q, vals, labels, tau, scales)
        jqb = jbk.QuantBank(jnp.asarray(vals.astype(np.int8)),
                            jnp.asarray(scales))
        loss, res = jbk._q8_fwd_for_vjp(jnp.asarray(q), jqb,
                                        jnp.asarray(labels), jnp.float32(tau),
                                        8, 128)
    else:
        q, bank, labels, tau, _, _ = _case(rng, b, m, d, dtype)
        got = emulate_forward(q, bank, dtype == "bfloat16", labels, tau, plan)
        want = float64_forward(q, bank, labels, tau)
        jbank = jnp.asarray(bank)
        if dtype == "bfloat16":
            jbank = jbank.astype(jnp.bfloat16)
        loss, res = jbk._fwd_for_vjp(jnp.asarray(q), jbank,
                                     jnp.asarray(labels), jnp.float32(tau),
                                     8, 128)
    mx, se, pos, el = (np.asarray(x) for x in res[4:8])
    pallas = (mx, se, pos, el, np.asarray(loss),
              np.mean((pos - el / se) / np.float32(tau)))
    _assert_forward(got, want, "float64")
    _assert_forward(pallas, want, "float64 (Pallas)")
    _assert_forward(got, pallas, "the Pallas forward")


@pytest.mark.parametrize("d", [256, 512, 640])
def test_forward_and_coefficient_share_the_logits(d, rng):
    """The backward's P = exp(l - mx)/se from the forward's own statistics
    sums to 1 over the bank for every row: the coefficient kernel forms the
    forward's logits bit for bit (one mainloop), here one emulation."""
    b, m = 6, 1100
    q, bank, labels, tau, _, _ = _case(rng, b, m, d, "float32")
    plan = bk.fwd_plan(b, m, d, sm_count=1)
    mx, se, _, _, _, _ = emulate_forward(q, bank, False, labels, tau, plan)
    logits = (mma_3xtf32(q, bank.T, False) / np.float32(tau)).astype(
        np.float32)
    p = np.exp(logits - mx[:, None]).astype(np.float32) / se[:, None]
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-5)
    assert (logits.max(axis=1) == mx).all()


@pytest.mark.parametrize("b,m,d", [(8, 300, 256), (5, 1100, 512),
                                   (16, 700, 640), (32, 1100, 768)])
def test_split_tf32_int8_backward_matches_float64_and_pallas(b, m, d, rng):
    """The int8 backward runs the dense kernels' two products on the raw
    values (exact in TF32: two products each), the scale on the logits
    column and on the coefficient; dQ holds the bank tolerance against
    float64 and against `bank_infonce_q8_pallas` in interpret mode."""
    q, vals, scales, labels, tau, mx, se = _q8_case(rng, b, m, d)
    plan = bk.bwd_plan(b, m, d, sm_count=16)
    assert plan.tc_logits and plan.n_splits > 1
    got = emulate_backward(q, vals, True, labels, tau, mx, se, 1.0, plan,
                           scales)
    want = float64_backward(q, vals, labels, tau, mx, se, 1.0, scales)
    np.testing.assert_allclose(got, want, atol=BANK_DQ_ATOL, rtol=BANK_RTOL)
    jqb = jbk.QuantBank(jnp.asarray(vals.astype(np.int8)),
                        jnp.asarray(scales))
    dq = np.asarray(jax.grad(lambda q_: jbk.bank_infonce_q8_pallas(
        q_, jqb, jnp.asarray(labels), jnp.float32(tau), 8, 128))(
        jnp.asarray(q)))
    np.testing.assert_allclose(dq, want, atol=BANK_DQ_ATOL, rtol=BANK_RTOL)
    np.testing.assert_allclose(got, dq, atol=2 * BANK_DQ_ATOL,
                               rtol=2 * BANK_RTOL)


@pytest.mark.parametrize("b,m,d", [(8, 300, 256), (5, 1100, 512),
                                   (16, 700, 640), (32, 1100, 768)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_tf32_backward_matches_float64_and_pallas(b, m, d, dtype, rng):
    q, bank, labels, tau, mx, se = _case(rng, b, m, d, dtype)
    # a small card, so that the bank is cut into several splits
    plan = bk.bwd_plan(b, m, d, sm_count=16)
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


@pytest.mark.parametrize("d", [16, 64, 128])
def test_split_tf32_int8_dq_product_holds_at_shallow_depths(d, rng):
    """The same over int8 values (exact in TF32, two products), from a
    coefficient that carries the scales, as the int8 backward's does."""
    b, m = 9, 1000
    qbank = bk.quantize_bank(torch.from_numpy(_norm(rng.randn(m, d))))
    vals = qbank.values.numpy().astype(np.float32)
    coef = (rng.rand(b, m) * 1e-3).astype(np.float32)
    coef[np.arange(b), rng.randint(0, m, size=b)] -= np.float32(1.0)
    coef = (coef * qbank.scales.numpy()[None, :]).astype(np.float32)
    got = mma_3xtf32(coef, vals, True)
    want = coef.astype(np.float64) @ vals.astype(np.float64)
    np.testing.assert_allclose(got, want, atol=BANK_DQ_ATOL, rtol=BANK_RTOL)


@pytest.mark.parametrize("b,m,d", [(256, 65536, 640), (256, 65536, 512),
                                   (128, 65536, 256), (5, 2049, 512),
                                   (70, 4001, 768), (9, 130, 16),
                                   (1, 1, 16), (3, 300, 1040)])
@pytest.mark.parametrize("sms", [1, 132])
def test_dense_bwd_plan_covers_the_bank_with_no_empty_split(b, m, d, sms):
    plan = bk.bwd_plan(b, m, d, sms)
    tiles = -(-m // bk.TILE_COLS)
    assert plan.tiles_per_split * plan.n_splits >= tiles
    assert plan.tiles_per_split * (plan.n_splits - 1) < tiles
    assert (plan.tiles_per_split, plan.n_splits) == bk.split_plan(
        m, b, sms, bk.DQ_CTAS_PER_SM, -(-d // bk.DQ_COLS))
    # scratch: the coefficient over whole bank tiles, one dQ per split
    assert plan.coef_shape == (b, tiles * bk.TILE_COLS)
    assert plan.dq_part_shape == (plan.n_splits, b, d)
    assert plan.tc_logits == (d >= bk.TC_LOGITS_MIN_D)


@pytest.mark.parametrize("b,m,d", [(256, 65536, 640), (256, 65536, 512),
                                   (5, 2049, 640), (70, 4001, 768),
                                   (9, 130, 16)])
def test_int8_bank_takes_the_dense_plan(b, m, d):
    """One plan for every bank type: a QuantBank's (M, D) gives the grid,
    the scratch and the logits route that the same dense bank gets."""
    bank = torch.zeros(m, d)
    qbank = bk.quantize_bank(bank)
    assert tuple(qbank.shape) == tuple(bank.shape) == (m, d)
    dense = bk.bwd_plan(b, *bank.shape, 132)
    quant = bk.bwd_plan(b, *qbank.shape, 132)
    assert quant == dense
    assert quant.coef_shape == (b, -(-m // bk.TILE_COLS) * bk.TILE_COLS)
    assert quant.dq_part_shape == (quant.n_splits, b, d)
    assert quant.tc_logits == (d >= bk.TC_LOGITS_MIN_D)


@pytest.mark.parametrize("b,m,d", [(256, 65536, 640), (256, 65536, 512),
                                   (128, 65536, 256), (5, 2049, 512),
                                   (70, 4001, 768), (33, 1000, 240),
                                   (9, 130, 16), (1, 1, 16), (3, 300, 1040)])
@pytest.mark.parametrize("sms", [1, 132])
def test_fwd_plan_covers_the_bank_with_no_empty_split(b, m, d, sms):
    """The forward's splits cover the bank's tiles, none of them empty; the
    logits route is the backward's rule."""
    plan = bk.fwd_plan(b, m, d, sms)
    tiles = -(-m // bk.TILE_COLS)
    assert plan.tiles_per_split * plan.n_splits >= tiles
    assert plan.tiles_per_split * (plan.n_splits - 1) < tiles
    assert (plan.tiles_per_split, plan.n_splits) == bk.split_plan(
        m, b, sms, bk.FWD_CTAS_PER_SM)
    assert plan.tc_logits == (d >= bk.TC_LOGITS_MIN_D)
    assert plan.tc_logits == bk.bwd_plan(b, m, d, sms).tc_logits


@pytest.mark.parametrize("b,m,d", [(256, 65536, 640), (256, 65536, 512),
                                   (5, 2049, 640), (33, 1000, 240),
                                   (9, 130, 16)])
def test_int8_bank_takes_the_dense_fwd_plan(b, m, d):
    bank = torch.zeros(m, d)
    qbank = bk.quantize_bank(bank)
    assert bk.fwd_plan(b, *qbank.shape, 132) == bk.fwd_plan(b, *bank.shape,
                                                            132)


def test_fwd_plan_fills_the_card_at_the_recipe_shapes():
    """B=256 is 4 row tiles: 64 splits of 8 bank tiles, 256 CTAs on the 264
    that 132 SMs hold at two each; the four CTAs of one split sit side by
    side in the grid."""
    plan = bk.fwd_plan(256, 65536, 640, 132)
    assert plan == bk.FwdPlan(8, 64, True)
    assert 4 * plan.n_splits <= 2 * 132
    assert bk.fwd_plan(128, 65536, 256, 132) == bk.FwdPlan(4, 128, True)


# q, bank | values, scales, labels; (bwd: mx, se, gout); tau; B, M, D (dense:
# the dtype code), tiles_per_split, n_splits, tc_logits; the scratch and the
# outputs (fwd: part, mx, se, pos, el, out2; bwd: coef, dq_part, dq); stream
_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRY_POINTS = {
    "bank_infonce_fwd": [_PTR] * 3 + [_F32] + [_I32] * 7 + [_PTR] * 7,
    "bank_infonce_q8_fwd": [_PTR] * 4 + [_F32] + [_I32] * 6 + [_PTR] * 7,
    "bank_infonce_bwd": [_PTR] * 6 + [_F32] + [_I32] * 7 + [_PTR] * 4,
    "bank_infonce_q8_bwd": [_PTR] * 7 + [_F32] + [_I32] * 6 + [_PTR] * 4,
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_both_backward_entry_points_take_the_plans_scratch(entry,
                                                           monkeypatch):
    """Each q8 entry point's C signature is its dense twin's with the
    scales' pointer for the dtype code; all four take (tiles_per_split,
    n_splits, tc_logits) of their plan, the forwards the statistics scratch
    and the backwards the coefficient and partial-dQ scratch."""
    from spn4cir_tpu_torch.ops import cuda_build

    class Lib:
        def __init__(self, path):
            for name in ("bank_infonce_fwd", "bank_infonce_bwd",
                         "bank_infonce_q8_fwd", "bank_infonce_q8_bwd"):
                setattr(self, name, type("Fn", (), {})())

    monkeypatch.setattr(cuda_build, "build_library", lambda *a: "unbuilt.so")
    monkeypatch.setattr(cuda_build, "_LIBRARIES", {})
    monkeypatch.setattr(ctypes, "CDLL", Lib)
    lib = cuda_build.load_library("bank_infonce", bk.ENTRY_POINTS)
    assert getattr(lib, entry).argtypes == ENTRY_POINTS[entry]


def test_dense_bwd_plan_fills_the_card_at_the_recipe_shapes():
    """B=256 x D=640 is 4 x 5 output tiles of the dQ kernel: the bank axis
    is split until the card holds two CTAs an SM."""
    plan = bk.bwd_plan(256, 65536, 640, 132)
    assert (plan.tiles_per_split, plan.n_splits) == (40, 13)
    assert 4 * 5 * plan.n_splits <= 2 * 132
    scratch = 4 * (np.prod(plan.coef_shape) + np.prod(plan.dq_part_shape))
    assert scratch == 4 * (256 * 65536 + 13 * 256 * 640)
