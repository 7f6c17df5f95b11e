"""The port's decode-step attention (kernel #11's module) against the JAX
package.

The JAX side runs `spn4cir_tpu.ops.decode_attn.decode_attention`, the
Pallas kernel, in interpret mode on this CPU host, as the JAX package's own
tests do. The port side runs `decode_attention_reference`, the plain
version that the CUDA kernel is held against on the card
(tests/test_torch_cuda.py, chip_smoke.py), and the wrapper, which takes the
plain version for a CPU tensor and counts no launch. Inputs are numpy
arrays from a seed, handed to both sides.

Tolerances: float32 1e-5 (summation order); bf16 2e-2 (both round the
softmax weights to bf16 before the V product, in another order); int8 cache
1e-4 relative (float32 arithmetic on exact int8 values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.ops.decode_attn import decode_attention as jax_decode_attention
from spn4cir_tpu_torch.models.llama import _quant_rows
from spn4cir_tpu_torch.ops import decode_attn as da

torch.set_num_threads(1)

NEG_INF = -1e9


def _case(seed, b, h, hd, length, layers, pos):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, hd).astype(np.float32)
    k = rng.randn(layers, b, length, h * hd).astype(np.float32)
    v = rng.randn(layers, b, length, h * hd).astype(np.float32)
    bias = np.where(np.arange(length)[None, :] <= pos, 0.0, NEG_INF)
    bias = np.broadcast_to(bias, (b, length)).astype(np.float32).copy()
    bias[0, :3] = NEG_INF   # a left pad on the first row
    return q, k, v, bias


def _jax(q, k, v, li, bias, ks=None, vs=None):
    args = [jnp.asarray(a) if a is not None else None
            for a in (q, k, v, bias, ks, vs)]
    return np.asarray(jax_decode_attention(
        args[0], args[1], args[2], jnp.int32(li), args[3], args[4], args[5]),
        np.float32)


@pytest.mark.parametrize("length", [128, 256])
@pytest.mark.parametrize("kind,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_plain_version_matches_the_tpu_kernel(length, kind, tol):
    q, k, v, bias = _case(0, 2, 2, 128, length, 2, length - 9)
    jdt = getattr(jnp, kind)
    tdt = getattr(torch, kind)
    jk, jv = np.asarray(jnp.asarray(k, jdt)), np.asarray(jnp.asarray(v, jdt))
    want = _jax(q, jk, jv, 1, bias)
    got = da.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), 1, torch.from_numpy(bias))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("length", [128, 256])
def test_plain_version_matches_the_tpu_kernel_int8(length):
    q, k, v, bias = _case(1, 2, 2, 128, length, 2, length - 2)
    kq, ks = _quant_rows(torch.from_numpy(k))
    vq, vs = _quant_rows(torch.from_numpy(v))
    want = _jax(q, kq.numpy(), vq.numpy(), 1, bias, ks.numpy(), vs.numpy())
    got = da.decode_attention_reference(torch.from_numpy(q), kq, vq, 1,
                                        torch.from_numpy(bias), ks, vs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v, bias = _case(2, 3, 4, 8, 37, 2, 30)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    before = da.decode_attention.launches
    got = da.decode_attention(args[0], args[1], args[2], 1, args[3])
    assert da.decode_attention.launches == before
    assert torch.equal(got, da.decode_attention_reference(
        args[0], args[1], args[2], 1, args[3]))


def test_gqa_reads_the_kv_head_of_each_head():
    """With KVH < H the plain version expands kv head h // n_rep, the
    same as a cache whose kv heads were repeated to H."""
    rng = np.random.RandomState(3)
    b, h, kvh, hd, length = 2, 6, 2, 16, 20
    q = torch.from_numpy(rng.randn(b, h, hd).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, b, length, kvh, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(1, b, length, kvh, hd).astype(np.float32))
    bias = torch.zeros(b, length)
    got = da.decode_attention_reference(q, k.flatten(3), v.flatten(3), 0, bias)
    rep = lambda t: t.repeat_interleave(h // kvh, dim=3).flatten(3)  # noqa: E731
    want = da.decode_attention_reference(q, rep(k), rep(v), 0, bias)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("length,pairs,sm", [
    (1842, 32, 132), (1842, 512, 132), (1842, 256, 132), (37, 12, 132),
    (1, 1, 132), (1241, 512, 132), (5000, 1, 8), (1842, 1, 132),
    (300, 4, 132)])
def test_split_plan_covers_every_row_once(length, pairs, sm):
    """The plan cuts each pair's rows into splits that cover every row
    once, as few as give every SM a block, within the cluster and row
    caps; and it is pure."""
    rows, n = da.split_plan(length, pairs, sm)
    assert (rows, n) == da.split_plan(length, pairs, sm)
    assert rows >= 1 and (n - 1) * rows < length <= n * rows
    assert n <= min(da.MAX_SPLITS, -(-length // da.MIN_SPLIT_ROWS))
    cap = min(da.MAX_SPLITS, -(-length // da.MIN_SPLIT_ROWS))
    assert pairs * n >= sm or n == cap
    assert n == 1 or pairs * (n - 1) < sm


def test_split_plan_at_the_decode_shapes():
    """On 132 SMs the 7B's B = 8 and 16 take one split, B = 1 five."""
    assert da.split_plan(1842, 16 * 32, 132) == (1842, 1)
    assert da.split_plan(1842, 8 * 32, 132) == (1842, 1)
    assert da.split_plan(1842, 1 * 32, 132) == (369, 5)


# --------------------------------------------------------------------------
# The kernel's order of operations, emulated in numpy float32: a split's
# rows in tiles of (32 / G) x GROUP_ROWS rows, tile t of a split taken by
# warp t % WARPS, row r of a tile by lane group (slot) r % (32 / G); each
# slot keeps (max, sum, ctx) and rescales once a tile by the tile's max;
# the slots merge in xor order, the warps in order, the splits in order.
# (The kernel keeps its logits in log2 units and exponentiates with ex2: the
# same softmax, so the emulation stays in natural units.)
# --------------------------------------------------------------------------

def _merge(a, b):
    """Two online-softmax partials (m, s, acc), as the kernel's merge."""
    m, s, acc = a
    om, os_, oacc = b
    if om == -np.inf:
        return a
    nm = np.float32(max(m, om))
    ea, eb = np.exp(np.float32(m - nm)), np.exp(np.float32(om - nm))
    return nm, np.float32(s * ea + os_ * eb), (acc * ea + oacc * eb).astype(
        np.float32)


def _emulate(q, k, v, bias, ks, vs, li, kind, sm=132):
    """ctx (B, H, hd) float32 as the kernel computes it."""
    b_, h_, hd = q.shape
    length, width = k.shape[2], k.shape[3]
    kvh_n = width // hd
    rows_per_split, n_splits = da.split_plan(length, b_ * h_, sm)
    slots = 32 // da.lane_group(hd)
    tile = slots * da.GROUP_ROWS[getattr(torch, kind)]
    scale = np.float32(hd ** -0.5)
    out = np.zeros((b_, h_, hd), np.float32)
    for b in range(b_):
        for h in range(h_):
            kvh = h // (h_ // kvh_n)
            kk = k[li, b, :, kvh * hd:(kvh + 1) * hd].astype(np.float32)
            vv = v[li, b, :, kvh * hd:(kvh + 1) * hd].astype(np.float32)
            qq = q[b, h].astype(np.float32)
            parts = []
            for sp in range(n_splits):
                l0 = sp * rows_per_split
                l1 = min(length, l0 + rows_per_split)
                empty = (np.float32(-np.inf), np.float32(0),
                         np.zeros(hd, np.float32))
                state = [[empty] * slots for _ in range(da.WARPS)]
                for t in range(-(-(l1 - l0) // tile)):
                    w = t % da.WARPS
                    for slot in range(slots):
                        rows = [l0 + t * tile + rr * slots + slot
                                for rr in range(tile // slots)]
                        rows = [r for r in rows if r < l1]
                        if not rows:
                            continue
                        lg = (kk[rows] @ qq).astype(np.float32) * scale
                        if ks is not None:
                            lg = lg * ks[li, b, rows]
                        lg = (lg + bias[b, rows]).astype(np.float32)
                        m, s, acc = state[w][slot]
                        nm = np.float32(max(m, lg.max()))
                        c = np.exp(np.float32(m - nm))
                        p = np.exp(lg - nm).astype(np.float32)
                        wgt = p * vs[li, b, rows] if vs is not None else p
                        acc = (acc * c + wgt @ vv[rows]).astype(np.float32)
                        state[w][slot] = (nm, np.float32(s * c + p.sum()),
                                          acc)
                merged = empty
                for w in range(da.WARPS):
                    st = list(state[w])
                    step = 1
                    while step < slots:
                        st = [_merge(st[i], st[i ^ step])
                              for i in range(slots)]
                        step *= 2
                    merged = _merge(merged, st[0])
                parts.append(merged)
            gm = max(p[0] for p in parts)
            e = [np.exp(np.float32(p[0] - gm)) for p in parts]
            tot = sum(p[1] * ei for p, ei in zip(parts, e))
            out[b, h] = sum(p[2] * ei for p, ei in zip(parts, e)) / tot
    return out


def _exact(q, k, v, bias, ks, vs, li):
    """The float64 reference: softmax(logits) · V, scales applied."""
    b_, h_, hd = q.shape
    kvh_n = k.shape[3] // hd
    out = np.zeros((b_, h_, hd))
    for b in range(b_):
        for h in range(h_):
            kvh = h // (h_ // kvh_n)
            kk = k[li, b, :, kvh * hd:(kvh + 1) * hd].astype(np.float64)
            vv = v[li, b, :, kvh * hd:(kvh + 1) * hd].astype(np.float64)
            lg = kk @ q[b, h].astype(np.float64) * hd ** -0.5
            if ks is not None:
                lg = lg * ks[li, b]
            lg = lg + bias[b]
            w = np.exp(lg - lg.max())
            w = w / w.sum()
            if vs is not None:
                w = w * vs[li, b]
            out[b, h] = w @ vv
    return out


def _masked_case(seed, b, h, kvh, hd, length, layers, kind):
    """Inputs whose batch row 0 masks the whole first split and row 1 a
    run across a split boundary; int8 caches with their row scales."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, hd).astype(np.float32)
    k = rng.randn(layers, b, length, kvh * hd).astype(np.float32)
    v = rng.randn(layers, b, length, kvh * hd).astype(np.float32)
    bias = np.zeros((b, length), np.float32)
    rows, n = da.split_plan(length, b * h, 132)
    bias[0, :min(rows, length - 1)] = NEG_INF
    if b > 1 and n > 1:
        bias[1, rows - 6:rows + 6] = NEG_INF
    bias[:, length - length // 9:] = NEG_INF
    ks = vs = None
    if kind == "int8":
        (kq, kst), (vq, vst) = (_quant_rows(torch.from_numpy(t))
                                for t in (k, v))
        k, v, ks, vs = kq.numpy(), vq.numpy(), kst.numpy(), vst.numpy()
    elif kind == "bfloat16":
        k = torch.from_numpy(k).to(torch.bfloat16).float().numpy()
        v = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    return q, k, v, bias, ks, vs


@pytest.mark.parametrize("b,h,kvh,hd,length", [
    (2, 2, 2, 128, 256), (2, 6, 3, 40, 300), (3, 4, 4, 8, 1),
    (1, 2, 2, 128, 700)])
@pytest.mark.parametrize("kind,tol", [("float32", 1e-5), ("int8", 1e-4),
                                      ("bfloat16", 1e-5)])
def test_tile_wise_softmax_matches_float64(b, h, kvh, hd, length, kind, tol):
    """The kernel's tile-wise online softmax with its splits and merges
    against float64: a wholly masked split, a masked run across a split
    boundary, GQA, an off-power-of-two head_dim, L = 1 and int8 scales
    (bf16 caches widened exactly, so float32 arithmetic throughout)."""
    args = _masked_case(b + hd + length, b, h, kvh, hd, length, 2, kind)
    got = _emulate(*args, 1, kind)
    want = _exact(*args, 1)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("kind,tol", [("float32", 1e-5), ("int8", 1e-4),
                                      ("bfloat16", 2e-2)])
def test_tile_wise_softmax_matches_the_tpu_kernel(kind, tol):
    """The same emulation against the Pallas kernel in interpret mode, at
    a geometry it takes (MHA, hd = 128, L = 256), batch row 0's first
    split wholly masked."""
    q, k, v, bias, ks, vs = _masked_case(5, 2, 2, 2, 128, 256, 2, kind)
    got = _emulate(q, k, v, bias, ks, vs, 1, kind)
    if kind == "bfloat16":
        k, v = (np.asarray(jnp.asarray(t, jnp.bfloat16)) for t in (k, v))
    want = _jax(q, k, v, 1, bias, ks, vs)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
