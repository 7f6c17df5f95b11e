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
    (1, 1, 132), (1241, 512, 132), (5000, 1, 8)])
def test_split_plan_covers_every_row_once(length, pairs, sm):
    rows, n = da.split_plan(length, pairs, sm)
    assert rows >= 1 and (n - 1) * rows < length <= n * rows
    assert n <= -(-length // da.MIN_SPLIT_ROWS)
