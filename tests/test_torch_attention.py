"""The port's short-sequence attention against the JAX packed kernel,
forward and backward.

The JAX side runs `packed_attention_pallas` / `packed_causal_attention_pallas`
(and their VJPs through `jax.vjp`) in Pallas interpret mode on this CPU host,
as tests/test_attention_kernel.py does. Inputs are numpy arrays from a seed,
handed to both sides.
Tolerance: float32, atol = rtol = 1e-5 (the two sides differ only in
summation order). bfloat16 backward: atol = rtol = 2e-2 — P and dS are
rounded to bfloat16 before their products on both sides, but a float32 value
that lands near a rounding boundary can round apart after a different
summation order, and each output is itself rounded to bfloat16 (8 bits of
mantissa, relative step 2^-8 = 3.9e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.ops.attention_kernels import (packed_attention_pallas,
                                               packed_causal_attention_pallas)
from spn4cir_tpu_torch.ops.attention_kernels import (
    kernel_takes, short_attention, short_attention_bwd,
    short_attention_bwd_reference, short_attention_reference)

torch.set_num_threads(1)

ATOL = RTOL = 1e-5


def _qkv(rng, bh, s, d):
    q = rng.standard_normal((bh, s, d)).astype(np.float32) * d ** -0.5
    k = rng.standard_normal((bh, s, d)).astype(np.float32)
    v = rng.standard_normal((bh, s, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("bh,s,d,causal", [
    (6, 50, 64, False),   # ViT-B/32 vision attention
    (4, 77, 64, True),    # CLIP text attention
    (3, 29, 16, False),   # ragged
    (3, 29, 16, True),
])
def test_reference_matches_jax_packed(bh, s, d, causal, rng):
    q, k, v = _qkv(rng, bh, s, d)
    jax_fn = packed_causal_attention_pallas if causal else packed_attention_pallas
    want = np.asarray(jax_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = short_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


BWD_SHAPES = [
    (6, 50, 64, False),   # ViT-B/32 vision attention
    (4, 77, 64, True),    # CLIP text attention (the stage-2 path)
    (3, 29, 16, False),   # ragged
    (3, 29, 16, True),
]


def _jax_vjp(q, k, v, do, causal, dtype=jnp.float32):
    jax_fn = packed_causal_attention_pallas if causal else packed_attention_pallas
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    _, vjp = jax.vjp(jax_fn, *args)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do).astype(dtype))]


@pytest.mark.parametrize("bh,s,d,causal", BWD_SHAPES)
def test_backward_reference_matches_jax_vjp(bh, s, d, causal, rng):
    q, k, v = _qkv(rng, bh, s, d)
    do = rng.standard_normal((bh, s, d)).astype(np.float32)
    want = _jax_vjp(q, k, v, do, causal)
    got = short_attention_bwd_reference(*(torch.from_numpy(a)
                                          for a in (q, k, v, do)), causal)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("bh,s,d,causal", BWD_SHAPES)
def test_autograd_through_wrapper_matches_jax_vjp(bh, s, d, causal, rng):
    """loss.backward() through `short_attention` on the CPU runs the plain
    backward and gives the JAX VJP's dq, dk, dv."""
    q, k, v = _qkv(rng, bh, s, d)
    do = rng.standard_normal((bh, s, d)).astype(np.float32)
    want = _jax_vjp(q, k, v, do, causal)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = (short_attention.launches, short_attention_bwd.launches)
    short_attention(tq, tk, tv, causal).backward(torch.from_numpy(do))
    assert (short_attention.launches, short_attention_bwd.launches) == before
    for t, w, name in zip((tq, tk, tv), want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("bh,s,d,causal", BWD_SHAPES[:2])
def test_backward_reference_matches_jax_vjp_bf16(bh, s, d, causal, rng):
    q, k, v = _qkv(rng, bh, s, d)
    do = rng.standard_normal((bh, s, d)).astype(np.float32)
    want = _jax_vjp(q, k, v, do, causal, jnp.bfloat16)
    got = short_attention_bwd_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)), causal)
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, atol=2e-2, rtol=2e-2,
                                   err_msg=f"d{name}")


def test_causal_backward_never_reads_above_the_diagonal(rng):
    """Garbage in k/v rows a query cannot see must not reach its dq, and
    the last key gets gradient from the last query only."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 9, 8))
    do = torch.from_numpy(rng.standard_normal((2, 9, 8)).astype(np.float32))
    dq, dk, dv = short_attention_bwd_reference(q, k, v, do, True)
    k2, v2 = k.clone(), v.clone()
    k2[:, 5:] = 1e3
    v2[:, 5:] = -1e3
    dq2, _, _ = short_attention_bwd_reference(q, k2, v2, do, True)
    torch.testing.assert_close(dq2[:, :5], dq[:, :5], atol=0, rtol=0)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    do_last = torch.zeros_like(do)
    do_last[:, :-1] = do[:, :-1]                 # silence the last query
    _, dk3, dv3 = short_attention_bwd_reference(q, k, v, do_last, True)
    assert (dk3[:, -1] == 0).all() and (dv3[:, -1] == 0).all()


def test_backward_wrapper_rejects_what_the_kernel_does_not_take():
    t = torch.zeros(2, 50, 64)
    with pytest.raises(ValueError, match="CUDA kernel"):
        short_attention_bwd(t, t, t, t)
    # forward and backward take the same slices: S, D <= 128
    assert kernel_takes(128, 128) and kernel_takes(77, 64)
    assert not kernel_takes(129, 64) and not kernel_takes(77, 129)
    long = torch.zeros(2, 129, 64, requires_grad=True)
    with pytest.raises(ValueError, match="S <= 128"):
        short_attention(long, long, long)


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_wrapper_takes_plain_version_without_counting(causal, rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 5, 77, 64))
    before = short_attention.launches
    got = short_attention(q, k, v, causal)
    assert short_attention.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(got, short_attention_reference(q, k, v, causal),
                               atol=0, rtol=0)


def test_causal_first_row_attends_to_itself_only(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 9, 8))
    out = short_attention(q, k, v, causal=True)
    torch.testing.assert_close(out[:, 0], v[:, 0], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape,dtype,msg", [
    ((2, 129, 64), torch.float32, "S <= 128"),
    ((2, 50, 160), torch.float32, "D <= 128"),
    ((2, 50, 64), torch.float16, "float32 or bfloat16"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(shape, dtype, msg):
    t = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=msg):
        short_attention(t, t, t)


def test_wrapper_rejects_non_contiguous():
    t = torch.zeros(2, 64, 50).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        short_attention(t, t, t)

