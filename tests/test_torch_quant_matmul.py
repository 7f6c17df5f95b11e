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


@pytest.mark.parametrize("rows,d,f", [
    (1, 4096, 4096), (16, 4096, 11008), (8, 11008, 4096), (16, 4096, 32000),
    (5, 40, 77), (33, 300, 130), (1, 100, 1)])
def test_split_plan_covers_d_in_whole_chunks(rows, d, f):
    rt, per, n = qm.split_plan(rows, d, f, 132)
    assert rt in (1, 2, 4, 8) and (rt >= min(rows, 8))
    assert (n - 1) * per < d <= n * per
    assert n == 1 or per % qm.CHUNK == 0
