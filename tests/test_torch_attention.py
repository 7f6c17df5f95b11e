"""The port's short-sequence attention against the JAX packed kernel.

The JAX side runs `packed_attention_pallas` / `packed_causal_attention_pallas`
in Pallas interpret mode on this CPU host, as tests/test_attention_kernel.py
does. Inputs are numpy arrays from a seed, handed to both sides.
Tolerance: float32, atol = rtol = 1e-5 (the two sides differ only in
summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.ops.attention_kernels import (packed_attention_pallas,
                                               packed_causal_attention_pallas)
from spn4cir_tpu_torch.ops.attention_kernels import (short_attention,
                                                     short_attention_reference)

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

