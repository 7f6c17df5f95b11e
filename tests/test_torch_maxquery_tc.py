"""The max-over-query InfoNCE kernels' arithmetic (#9 forward in split TF32
on the tensor cores, #10 routed backward from the forward's residuals),
emulated in numpy, against float64 and against the JAX package's Pallas
kernels in interpret mode; and their plan (`mq_plan`).

The CUDA kernels (`mq_fwd_tc_kernel`, `mq_routed_bwd_kernel` in
csrc/max_query_infonce.cu) run only on the card (tests/test_torch_cuda.py,
chip_smoke.py). Their arithmetic is emulated here as they do it:
  - forward: the sims of the bank as its (M·Q, D) matrix, over a float32
    bank in split TF32 (`mma_3xtf32` of tests/test_torch_split_tf32.py:
    each float32 operand hi + lo, three products), over a bf16 or int8 bank
    in bf16 (feats as three bf16 terms that sum to it exactly, the bank
    values exact in bf16); each 32-deep block summed exactly and added to
    the float32 accumulator; times the int8 scale; the max over each m's Q sims with
    the first argmax; 1/tau; then one online-softmax fold a (row, m) into
    the running (mx, se, el, pos) of slot (m % m_per_tile) % 8 (a warp's m
    at Q = 32, a scan thread's otherwise; slot 0 past Q = 256), the m's of a
    split in order; at the end of a split the 8 slots merged in order, and
    the splits of `mq_plan` in index order;
  - backward: w = (exp(l - mx)/se - onehot)·g (·s[m, q*]) from the
    residual logits l and routes q*, then dfeats[b] += w·bank[m, q*] in m
    order as float32 FMAs per split of `mq_plan`, the splits summed in
    index order.

Tolerances: those of the kernels on the card (chip_smoke.py BANK_RTOL,
BANK_DQ_ATOL): the forward's statistics and loss atol = rtol = 1e-4,
dtau_unit 1e-3 absolute; dfeats atol 1e-6 + rtol 1e-4, against float64 and
against the Pallas kernels (a float32 computation in another order; the two
are then held within twice that of each other).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.ops import bank_kernels as jbk
from spn4cir_tpu.ops import maxquery_kernels as jmq
from spn4cir_tpu_torch.ops import bank_kernels as bk
from spn4cir_tpu_torch.ops import maxquery_kernels as mk
from tests.test_torch_split_tf32 import (BANK_DQ_ATOL, BANK_RTOL, _merge,
                                         mma_3xtf32)

f32 = np.float32


def _norm(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(f32)


def _case(rng, b, m, q, d, kind):
    """(feats, values (M, Q, D) as float32, scales (M, Q) or None, labels,
    the JAX bank, the port's bank, tau): unit rows; a bf16 bank holds the
    rounded values, an int8 one `quantize_bank`'s."""
    feats = _norm(rng.randn(b, d))
    bank = _norm(rng.randn(m, q, d))
    labels = rng.randint(0, m, size=b).astype(np.int64)
    if kind == "int8":
        qb = bk.quantize_bank(torch.from_numpy(bank))
        vals, scales = qb.values.numpy(), qb.scales.numpy()
        jbank = jbk.QuantBank(jnp.asarray(vals), jnp.asarray(scales))
        return (feats, vals.astype(f32), scales, labels, jbank, qb, 0.05)
    if kind == "bfloat16":
        t = torch.from_numpy(bank).to(torch.bfloat16)
        vals = t.float().numpy()
        return (feats, vals, None, labels,
                jnp.asarray(vals).astype(jnp.bfloat16), t, 0.05)
    return (feats, bank, None, labels, jnp.asarray(bank),
            torch.from_numpy(bank), 0.05)


def bf16_rn(x):
    """float32 x rounded to bf16 (to nearest, ties to even), as float32."""
    bits = np.asarray(x, f32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(f32)


def split3(x):
    """x as three bf16 terms hi + mid + lo, each the rounding of what the
    earlier ones left (the kernel's `split3`)."""
    x = np.asarray(x, f32)
    hi = bf16_rn(x)
    r = (x - hi).astype(f32)
    mid = bf16_rn(r)
    return hi, mid, bf16_rn((r - mid).astype(f32))


def mma_bf16(a, b, stage=32):
    """a (I, K) @ b (K, J) as the bf16 route: a as its three bf16 terms and
    b exact in bf16, so each 32-deep block's products sum exactly; the
    block is rounded to float32 and added in float32."""
    terms = [t.astype(np.float64) for t in split3(a)]
    assert (np.asarray(b, f32) == bf16_rn(b)).all()
    acc = np.zeros((a.shape[0], b.shape[1]), f32)
    for k0 in range(0, a.shape[1], stage):
        s = slice(k0, k0 + stage)
        part = sum(t[:, s] for t in terms) @ b[s].astype(np.float64)
        acc = (acc + part.astype(f32)).astype(f32)
    return acc


def emulate_sims(feats, vals, kind, scales=None):
    """(B, M, Q) float32 sims as the forward kernel forms them: split TF32
    over a float32 bank, bf16 products of feats' three exact terms over a
    bf16 or int8 bank."""
    m, nq, d = vals.shape
    rows = vals.reshape(m * nq, d).T
    sims = (mma_3xtf32(feats, rows, False) if kind == "float32"
            else mma_bf16(feats, rows))
    if scales is not None:
        sims = (sims * scales.reshape(-1)[None, :]).astype(f32)
    return sims.reshape(feats.shape[0], m, nq)


def emulate_forward(feats, vals, kind, labels, tau, plan, scales=None):
    """(mx, se, pos, el, loss, dtau_unit, logits (B, M), route (B, M)) of
    the forward kernel, statistics folded and merged in its order."""
    b = feats.shape[0]
    m, nq, _ = vals.shape
    sims = emulate_sims(feats, vals, kind, scales)
    route = sims.argmax(axis=-1)  # the first of equal maxima
    best = np.take_along_axis(sims, route[..., None], -1)[..., 0]
    logits = (best / f32(tau)).astype(f32)
    per = plan.m_per_split
    assert (plan.n_splits - 1) * per < m <= plan.n_splits * per
    mx = np.full(b, -np.inf, f32)
    se, el, pos = (np.zeros(b, f32) for _ in range(3))
    for sp in range(plan.n_splits):
        slots = [[np.full(b, -np.inf, f32)] + [np.zeros(b, f32)] * 3
                 for _ in range(8)]
        for mm in range(sp * per, min((sp + 1) * per, m)):
            slot = (mm % plan.m_per_tile) % 8 if nq <= mk.TILE_COLS else 0
            smx, sse, sel, spos = slots[slot]
            lv = logits[:, mm]
            nm = np.maximum(smx, lv)
            a = np.exp(smx - nm).astype(f32)
            p = np.exp(lv - nm).astype(f32)
            sse = (sse.astype(np.float64) * a + p).astype(f32)
            sel = (sel.astype(np.float64) * a + p.astype(np.float64) * lv
                   ).astype(f32)
            spos = np.where(labels == mm, (spos + lv).astype(f32), spos)
            slots[slot] = [nm, sse, sel, spos]
        wm, ws, we, wp = slots[0]
        for o in slots[1:]:
            wm, ws, we = _merge((wm, ws, we), (o[0], o[1], o[2]))
            wp = (wp + o[3]).astype(f32)
        mx, se, el = _merge((mx, se, el), (wm, ws, we))
        pos = (pos + wp).astype(f32)
    loss = np.mean((np.log(se) + mx - pos).astype(f32), dtype=f32)
    dtau = np.mean(((pos - el / se) / f32(tau)).astype(f32), dtype=f32)
    return mx, se, pos, el, loss, dtau, logits, route


def emulate_backward(vals, labels, tau, mx, se, gout, logits, route, plan,
                     scales=None):
    """dfeats of the backward kernel from the residuals: the routed rows'
    FMAs in m order per split, the splits summed in index order."""
    b, m = logits.shape
    d = vals.shape[2]
    p = (np.exp((logits - mx[:, None]).astype(f32)).astype(f32)
         / se[:, None]).astype(f32)
    p[np.arange(b), labels] -= f32(1.0)
    w = (p * f32(gout / (b * tau))).astype(f32)
    if scales is not None:
        w = (w * scales[np.arange(m)[None, :], route]).astype(f32)
    rows = vals[np.arange(m)[None, :], route]  # (B, M, D)
    dq = np.zeros((b, d), f32)
    per = plan.bwd_m_per_split
    assert (plan.bwd_splits - 1) * per < m <= plan.bwd_splits * per
    for sp in range(plan.bwd_splits):
        part = np.zeros((b, d), f32)
        for mm in range(sp * per, min((sp + 1) * per, m)):
            part = (w[:, mm, None].astype(np.float64) * rows[:, mm]
                    + part).astype(f32)
        dq = (dq + part).astype(f32)
    return dq


def float64_forward(feats, vals, labels, tau, scales=None):
    """(mx, se, pos, el, loss, dtau_unit, logits, route) in float64."""
    sims = np.einsum("bd,mqd->bmq", feats.astype(np.float64),
                     vals.astype(np.float64))
    if scales is not None:
        sims = sims * scales[None].astype(np.float64)
    route = sims.argmax(axis=-1)
    logits = sims.max(axis=-1) / tau
    mx = logits.max(axis=1)
    p = np.exp(logits - mx[:, None])
    se, el = p.sum(axis=1), (p * logits).sum(axis=1)
    pos = logits[np.arange(feats.shape[0]), labels]
    return (mx, se, pos, el, np.mean(np.log(se) + mx - pos),
            np.mean((pos - el / se) / tau), logits, route)


def float64_backward(vals, labels, tau, mx, se, gout, logits, route,
                     scales=None):
    """The backward's formula in float64 from the given residuals and
    statistics."""
    b, m = logits.shape
    p = np.exp(logits.astype(np.float64) - mx[:, None].astype(np.float64)) \
        / se[:, None]
    p[np.arange(b), labels] -= 1.0
    w = p * (gout / (b * tau))
    if scales is not None:
        w = w * scales[np.arange(m)[None, :], route]
    rows = vals[np.arange(m)[None, :], route].astype(np.float64)
    return np.einsum("bm,bmd->bd", w, rows)


def _assert_forward(got, want, what):
    names = ("mx", "se", "pos", "el", "loss", "dtau_unit")
    for name, g_, w_ in zip(names[:5], got[:5], want[:5]):
        np.testing.assert_allclose(g_, w_, atol=BANK_RTOL, rtol=BANK_RTOL,
                                   err_msg=f"{name} against {what}")
    np.testing.assert_allclose(got[5], want[5], atol=10 * BANK_RTOL, rtol=0,
                               err_msg=f"dtau_unit against {what}")


def _pallas_forward(feats, jbank, labels, tau):
    mx, se, pos, el = (np.asarray(x) for x in jmq._run_forward(
        jnp.asarray(feats), jbank, jnp.asarray(labels), tau, block_b=8,
        block_m=64))
    return (mx, se, pos, el, np.mean(np.log(se) + mx - pos, dtype=f32),
            np.mean((pos - el / se) / f32(tau), dtype=f32))


# (B, M, Q): Q = 32 takes the register epilogue, the others the staged
# scan; on a 2-SM card the m axis is cut into several splits
FWD_CASES = [(8, 70, 32), (5, 300, 8), (9, 130, 3), (6, 700, 1)]


@pytest.mark.parametrize("b,m,q", FWD_CASES)
@pytest.mark.parametrize("d", [256, 512])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_split_tf32_forward_matches_float64_and_pallas(b, m, q, d, kind,
                                                       rng):
    """#9's statistics, loss and dtau (split-TF32 sims, the max's first
    argmax, the folds and merges in the kernel's order) hold the smoke's
    tolerances against float64 and against the Pallas forward in
    interpret mode; its residual logits are float64's within the
    tolerance and its routes are float64's."""
    feats, vals, scales, labels, jbank, _, tau = _case(rng, b, m, q, d, kind)
    plan = mk.mq_plan(b, m, q, sm_count=2)
    assert plan.n_splits > 1
    got = emulate_forward(feats, vals, kind, labels, tau, plan, scales)
    want = float64_forward(feats, vals, labels, tau, scales)
    _assert_forward(got, want, "float64")
    pallas = _pallas_forward(feats, jbank, labels, tau)
    _assert_forward(pallas, want, "float64 (Pallas)")
    _assert_forward(got, pallas, "the Pallas forward")
    np.testing.assert_allclose(got[6], want[6], atol=BANK_RTOL,
                               rtol=BANK_RTOL)
    np.testing.assert_array_equal(got[7], want[7])


@pytest.mark.parametrize("b,m,q", FWD_CASES)
@pytest.mark.parametrize("d", [256, 512])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_routed_backward_matches_float64_and_pallas(b, m, q, d, kind, rng):
    """#10 from the emulated forward's residuals and statistics: dfeats
    within atol 1e-6 + rtol 1e-4 of float64 (the same residuals) and of
    the Pallas backward in interpret mode from the same statistics."""
    feats, vals, scales, labels, jbank, _, tau = _case(rng, b, m, q, d, kind)
    plan = mk.mq_plan(b, m, q, sm_count=2)
    assert plan.bwd_splits > 1
    mx, se, _, _, _, _, logits, route = emulate_forward(
        feats, vals, kind, labels, tau, plan, scales)
    got = emulate_backward(vals, labels, tau, mx, se, 1.0, logits, route,
                           plan, scales)
    want = float64_backward(vals, labels, tau, mx, se, 1.0, logits, route,
                            scales)
    np.testing.assert_allclose(got, want, atol=BANK_DQ_ATOL, rtol=BANK_RTOL)
    g_rows = jnp.full((b,), 1.0 / (b * tau), jnp.float32)
    pallas = np.asarray(jmq._run_backward(
        jnp.asarray(feats), jbank, jnp.asarray(labels), tau,
        jnp.asarray(mx), jnp.asarray(se), g_rows, block_b=8, block_m=64))
    np.testing.assert_allclose(pallas, want, atol=BANK_DQ_ATOL,
                               rtol=BANK_RTOL)
    np.testing.assert_allclose(got, pallas, atol=2 * BANK_DQ_ATOL,
                               rtol=2 * BANK_RTOL)


@pytest.mark.parametrize("d", [32, 64, 128, 224])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_split_tf32_holds_at_narrow_depths(d, kind, rng):
    """Below D = 256 the same split-TF32 forward and routed backward hold
    the tolerances against float64: one route for every D (the backward
    reads the forward's own logits, so P sums to 1 against its own
    statistics, whatever the depth)."""
    b, m, q = 7, 260, 32
    feats, vals, scales, labels, _, _, tau = _case(rng, b, m, q, d, kind)
    plan = mk.mq_plan(b, m, q, sm_count=2)
    got = emulate_forward(feats, vals, kind, labels, tau, plan, scales)
    want = float64_forward(feats, vals, labels, tau, scales)
    _assert_forward(got, want, "float64")
    np.testing.assert_array_equal(got[7], want[7])
    mx, se, logits, route = got[0], got[1], got[6], got[7]
    dq = emulate_backward(vals, labels, tau, mx, se, 1.0, logits, route,
                          plan, scales)
    np.testing.assert_allclose(
        dq, float64_backward(vals, labels, tau, mx, se, 1.0, logits, route,
                             scales), atol=BANK_DQ_ATOL, rtol=BANK_RTOL)


@pytest.mark.parametrize("q,d", [(32, 256), (3, 512), (8, 64)])
def test_backward_weights_sum_to_one_from_the_forwards_statistics(q, d, rng):
    """P = exp(l - mx)/se from the forward's own residual logits and
    statistics sums to 1 over the bank for every row, and mx is the
    largest residual logit: the backward needs no logit of its own."""
    b, m = 6, 400
    feats, vals, scales, labels, _, _, tau = _case(rng, b, m, q, d,
                                                   "float32")
    plan = mk.mq_plan(b, m, q, sm_count=2)
    mx, se, _, _, _, _, logits, _ = emulate_forward(
        feats, vals, "float32", labels, tau, plan, scales)
    p = np.exp(logits - mx[:, None]).astype(f32) / se[:, None]
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-5)
    assert (logits.max(axis=1) == mx).all()


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 3e4, 1e30])
def test_three_bf16_terms_sum_to_feats_exactly(scale, rng):
    """The bf16 route's split: hi + mid + lo is x exactly (float64 sum),
    each a bf16 value; bf16 values and int8 values are bf16 values
    already, so the bank needs no split."""
    x = (rng.randn(4096) * scale).astype(f32)
    terms = split3(x)
    for t in terms:
        assert not (t.view(np.uint32) & np.uint32(0xFFFF)).any()
    np.testing.assert_array_equal(sum(t.astype(np.float64) for t in terms),
                                  x.astype(np.float64))
    ints = np.arange(-128, 128).astype(f32)
    np.testing.assert_array_equal(bf16_rn(ints), ints)
    b = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bf16_rn(b), b)


def test_tie_routes_to_the_first_query_as_the_pallas_kernel(rng):
    """Bank rows with two equal queries (1 and 3): their sims tie exactly,
    in the emulated kernel as in float64, and both the emulated residuals
    and the Pallas backward route the weight to query 1; the emulated
    dfeats is the Pallas kernel's."""
    b, m, q, d = 4, 90, 5, 256
    feats = _norm(rng.randn(b, d))
    bank = _norm(rng.randn(m, q, d))
    bank[:, 1] = _norm(bank[:, 1] + 3 * feats.sum(0))  # query 1 wins
    bank[:, 3] = bank[:, 1]
    labels = rng.randint(0, m, size=b).astype(np.int64)
    tau = 0.05
    plan = mk.mq_plan(b, m, q, sm_count=2)
    sims = emulate_sims(feats, bank, "float32")
    assert (sims[..., 1] == sims[..., 3]).all()
    assert (sims.argmax(-1) == 1).all()
    mx, se, _, _, _, _, logits, route = emulate_forward(
        feats, bank, "float32", labels, tau, plan)
    assert (route == 1).all()
    got = emulate_backward(bank, labels, tau, mx, se, 1.0, logits, route,
                           plan)
    want = np.asarray(jax.grad(lambda f: jmq.max_query_infonce_pallas(
        f, jnp.asarray(bank), jnp.asarray(labels), tau, 8, 64))(
            jnp.asarray(feats)))
    np.testing.assert_allclose(got, want, atol=2 * BANK_DQ_ATOL,
                               rtol=2 * BANK_RTOL)
    # and the port's plain routed backward from the plain residuals
    tb = torch.from_numpy(bank)
    ft, lt = torch.from_numpy(feats), torch.from_numpy(labels)
    res = mk.max_query_infonce_residuals_reference(ft, tb, tau)
    assert (res[1] == 1).all() and res[1].dtype == torch.int16
    stats = mk.max_query_infonce_stats_reference(ft, tb, lt, tau)
    dq = mk.max_query_infonce_routed_bwd_reference(
        tb, lt, tau, stats[0], stats[1], torch.tensor(1.0), res)
    np.testing.assert_allclose(dq.numpy(), want, atol=BANK_DQ_ATOL,
                               rtol=BANK_RTOL)


PLAN_CASES = [(32, 65536, 32), (33, 65536, 32), (1, 1, 1), (5, 1000, 8),
              (70, 4001, 3), (256, 4001, 32), (9, 130, 300), (4, 17, 32767),
              (64, 777, 4), (3, 5, 256), (3, 5, 257)]


@pytest.mark.parametrize("b,m,q", PLAN_CASES)
@pytest.mark.parametrize("sms", [1, 2, 132])
def test_plan_puts_every_m_in_one_split(b, m, q, sms):
    """Forward: tiles of whole m's (256 // Q; one m past Q = 256, over
    ceil(Q / 256) tiles), splits of whole tiles, so no split boundary lies
    inside an m; every m in exactly one split, no split empty; about one
    CTA an SM with the row tiles. Backward: the same for its splits of m's,
    about two CTAs an SM."""
    plan = mk.mq_plan(b, m, q, sms)
    row_tiles = -(-b // mk.TILE_ROWS)
    if q <= mk.TILE_COLS:
        assert (plan.m_per_tile, plan.tiles_per_m) == (mk.TILE_COLS // q, 1)
        assert plan.m_per_tile * q <= mk.TILE_COLS
    else:
        assert plan.m_per_tile == 1
        assert (plan.tiles_per_m - 1) * mk.TILE_COLS < q \
            <= plan.tiles_per_m * mk.TILE_COLS
    for per, n, ctas in ((plan.m_per_split, plan.n_splits,
                          mk.FWD_CTAS_PER_SM),
                         (plan.bwd_m_per_split, plan.bwd_splits,
                          mk.BWD_CTAS_PER_SM)):
        owner = np.minimum(np.arange(m) // per, n)
        assert owner.max() == n - 1 and (np.bincount(owner) > 0).all()
        assert per * (n - 1) < m <= per * n
        assert n * row_tiles <= max(sms * ctas, row_tiles)
    assert plan.m_per_split % plan.m_per_tile == 0
    assert plan == mk.mq_plan(b, m, q, sms)  # a pure function


def test_plan_at_blip2s_shape():
    """B=32, M=65,536, Q=32 on 132 SMs: 131 forward splits of 63 tiles of
    8 m's (the last of 2), 264 backward splits of 249 m's (two an SM)."""
    plan = mk.mq_plan(32, 65536, 32, 132)
    assert plan == mk.MqPlan(8, 1, 504, 131, 249, 264)
    assert (mk.TILE_ROWS, mk.TILE_COLS) == (32, 256)


# feats, bank | values, scales, labels; tau; B, M, Q, D, the dtype code,
# m_per_split, n_splits; part, mx, se, pos, el, out2, the residuals
# (logits, route), stream. The backward: bank, scales, labels, mx, se, gout,
# the residuals; tau; B, M, Q, D, code, m_per_split, n_splits; dq_part, dq,
# stream: no feats.
_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRY_POINTS = {
    "max_query_infonce_fwd": [_PTR] * 4 + [_F32] + [_I32] * 7 + [_PTR] * 9,
    "max_query_infonce_bwd": [_PTR] * 8 + [_F32] + [_I32] * 7 + [_PTR] * 3,
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_take_the_residuals(entry, monkeypatch):
    from spn4cir_tpu_torch.ops import cuda_build

    class Lib:
        def __init__(self, path):
            for name in ENTRY_POINTS:
                setattr(self, name, type("Fn", (), {})())

    monkeypatch.setattr(cuda_build, "build_library", lambda *a: "unbuilt.so")
    monkeypatch.setattr(cuda_build, "_LIBRARIES", {})
    monkeypatch.setattr(ctypes, "CDLL", Lib)
    lib = cuda_build.load_library("max_query_infonce", mk.ENTRY_POINTS)
    assert getattr(lib, entry).argtypes == ENTRY_POINTS[entry]


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("q", [1, 8, 32])
def test_plain_routed_backward_is_the_recomputing_one(kind, q, rng):
    """The port's plain routed backward from the plain residuals equals the
    plain backward that recomputes them from (feats, bank)."""
    b, m, d = 5, 41, 64
    feats, _, _, labels, _, tbank, tau = _case(rng, b, m, q, d, kind)
    ft, lt = torch.from_numpy(feats), torch.from_numpy(labels)
    stats = mk.max_query_infonce_stats_reference(ft, tbank, lt, tau)
    gout = torch.tensor(0.7)
    res = mk.max_query_infonce_residuals_reference(ft, tbank, tau)
    assert res[0].shape == res[1].shape == (b, m)
    assert res[0].dtype == torch.float32 and res[1].dtype == torch.int16
    got = mk.max_query_infonce_routed_bwd_reference(
        tbank, lt, tau, stats[0], stats[1], gout, res)
    want = mk.max_query_infonce_bwd_reference(ft, tbank, lt, tau, stats[0],
                                              stats[1], gout)
    assert torch.equal(got, want)
