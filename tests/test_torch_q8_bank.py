"""The port's int8 bank InfoNCE against the JAX package.

The JAX side runs `bank_infonce_q8_pallas` in Pallas interpret mode on this
CPU host (as tests/test_bank_kernel.py does). The port side runs the plain
versions (`bank_infonce_q8_reference`, `bank_infonce_q8_stats_reference`,
`bank_infonce_q8_bwd_reference`) that the CUDA kernels are held against on
the card (tests/test_torch_cuda.py, chip_smoke.py). Inputs are numpy arrays
from a seed, handed to both sides; a `QuantBank` crosses as its two numpy
arrays.

Tolerances: `quantize_bank` agrees to the bit. Loss, dQ and dtau within
atol = rtol = 1e-5: both sides run the product on the int8 values widened
to float32, multiply the logits column by the row's scale and then by
1/tau, so they differ in summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.ops import bank_kernels as jbk
from spn4cir_tpu_torch.ops import bank_kernels as bk

torch.set_num_threads(1)

ATOL = RTOL = 1e-5


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _case(rng, b, m, d):
    q = _norm(rng.randn(b, d)).astype(np.float32)
    bank = _norm(rng.randn(m, d)).astype(np.float32)
    labels = rng.randint(0, m, size=b).astype(np.int64)
    return q, bank, labels


def _qbank(bank: np.ndarray) -> bk.QuantBank:
    return bk.quantize_bank(torch.from_numpy(bank))


def _jax_qbank(qbank: bk.QuantBank) -> jbk.QuantBank:
    return jbk.QuantBank(jnp.asarray(qbank.values.numpy()),
                         jnp.asarray(qbank.scales.numpy()))


@pytest.mark.parametrize("shape", [(37, 32), (300, 64), (5, 7, 16), (1, 640)])
def test_quantize_bank_equals_jax_to_the_bit(shape, rng):
    bank = rng.randn(*shape).astype(np.float32)
    bank[0] = 0.0                                       # the 1e-12 floor
    want = jbk.quantize_bank(jnp.asarray(bank))
    got = bk.quantize_bank(torch.from_numpy(bank))
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))
    assert got.shape == tuple(shape) and got.dtype == torch.int8


SHAPES = [(12, 37, 32), (16, 300, 64), (9, 130, 16), (5, 2049, 32),
          (7, 257, 640)]


@pytest.mark.parametrize("b,m,d", SHAPES)
@pytest.mark.parametrize("tau", [0.07, 0.02])
def test_int8_loss_and_grads_match_pallas(b, m, d, tau, rng):
    q, bank, labels = _case(rng, b, m, d)
    qbank = _qbank(bank)
    qt = torch.from_numpy(q).requires_grad_()
    tt = torch.tensor(tau, dtype=torch.float32, requires_grad=True)
    loss = bk.bank_infonce(qt, qbank, torch.from_numpy(labels), tt)
    loss.backward()
    jqb = _jax_qbank(qbank)
    want, (dq, dtau) = jax.value_and_grad(
        lambda q_, t_: jbk.bank_infonce_q8_pallas(
            q_, jqb, jnp.asarray(labels), t_, 8, 128), argnums=(0, 1))(
        jnp.asarray(q), jnp.float32(tau))
    np.testing.assert_allclose(loss.item(), float(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(dq), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tt.grad.item(), float(dtau), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("b,m,d", SHAPES)
def test_int8_stats_and_backward_references_are_consistent(b, m, d, rng):
    """The plain versions of kernels 7 and 8 agree with the fused plain
    loss under autograd: loss from the statistics, dQ from (mx, se), dtau
    from (se, pos, el)."""
    q, bank, labels = _case(rng, b, m, d)
    qbank, tau = _qbank(bank), 0.03
    qt = torch.from_numpy(q).requires_grad_()
    tt = torch.tensor(tau, requires_grad=True)
    lt = torch.from_numpy(labels)
    loss = bk.bank_infonce_q8_reference(qt, qbank, lt, tt)
    loss.backward()
    mx, se, pos, el = bk.bank_infonce_q8_stats_reference(qt.detach(), qbank,
                                                         lt, tau)
    np.testing.assert_allclose((se.log() + mx - pos).mean().item(),
                               loss.item(), atol=ATOL, rtol=RTOL)
    got = bk.bank_infonce_q8_bwd_reference(qt.detach(), qbank, lt, tau, mx,
                                           se, torch.tensor(1.0))
    np.testing.assert_allclose(got.numpy(), qt.grad.numpy(), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(
        bk.dtau_from_stats((mx, se, pos, el), tau).item(), tt.grad.item(),
        atol=ATOL, rtol=RTOL)


def test_int8_loss_is_close_to_the_dense_loss_and_scales_follow_the_product(
        rng):
    q, bank, labels = _case(rng, 12, 37, 32)
    qbank = _qbank(bank)
    qt, lt = torch.from_numpy(q), torch.from_numpy(labels)
    got = bk.bank_infonce(qt, qbank, lt, 0.05).item()
    dense = bk.bank_infonce(qt, torch.from_numpy(bank), lt, 0.05).item()
    assert 0 < abs(got - dense) < 0.05
    # logits = ((q @ i8ᵀ) * s) / tau, never q @ (i8 * s)ᵀ
    want = (qt @ qbank.values.float().T) * qbank.scales[None, :] / 0.05
    assert torch.equal(bk._q8_logits(qt, qbank, 0.05), want)


def test_int8_cpu_route_counts_no_launch_and_bank_gets_no_grad(rng):
    q, bank, labels = _case(rng, 4, 50, 16)
    qbank = _qbank(bank)
    qt = torch.from_numpy(q).requires_grad_()
    counters = (bk.bank_infonce_q8_fwd, bk.bank_infonce_q8_bwd,
                bk.bank_infonce_fwd, bk.bank_infonce_bwd)
    before = [c.launches for c in counters]
    bk.bank_infonce(qt, qbank, torch.from_numpy(labels), 0.1).backward()
    assert [c.launches for c in counters] == before
    assert qt.grad is not None and qbank.scales.grad is None


def test_int8_wrappers_refuse_cpu_tensors_and_the_wrong_bank(rng):
    q, bank, labels = _case(rng, 4, 50, 16)
    qt, lt = torch.from_numpy(q), torch.from_numpy(labels)
    qbank = _qbank(bank)
    with pytest.raises(ValueError, match="CUDA kernel"):
        bk.bank_infonce_q8_fwd(qt, qbank, lt, 0.1)
    with pytest.raises(ValueError, match="CUDA kernel"):
        bk.bank_infonce_q8_bwd(qt, qbank, lt, 0.1, torch.zeros(4),
                               torch.ones(4), torch.ones(()))
    with pytest.raises(ValueError, match="QuantBank"):
        bk.bank_infonce_q8_fwd(qt, torch.from_numpy(bank), lt, 0.1)
    with pytest.raises(ValueError, match="dense"):
        bk.bank_infonce_bwd(qt, qbank, lt, 0.1, torch.zeros(4), torch.ones(4),
                            torch.ones(()))


@pytest.mark.parametrize("values,scales,msg", [
    (torch.zeros(50, 16), torch.ones(50), "int8 values"),
    (torch.zeros(50, 16, dtype=torch.int8), torch.ones(50).double(),
     "float32"),
    (torch.zeros(50, 16, dtype=torch.int8), torch.ones(49), "scales must be"),
    (torch.zeros(50, 32, dtype=torch.int8), torch.ones(50), "share D"),
    (torch.zeros(50, 16, dtype=torch.int8), torch.ones(100)[::2],
     "contiguous"),
])
def test_int8_wrappers_reject_what_the_kernels_do_not_take(values, scales, msg):
    with pytest.raises(ValueError, match=msg):
        bk.bank_infonce_q8_fwd(torch.zeros(4, 16), bk.QuantBank(values, scales),
                               torch.zeros(4).long(), 0.1)


@pytest.mark.parametrize("m,b,sms,slices", [
    (65536, 256, 132, 2), (2049, 5, 132, 2), (65536, 256, 132, 3),
    (300, 3, 132, 4)])
def test_split_plan_counts_the_dq_slices(m, b, sms, slices):
    tps, n_splits = bk.split_plan(m, b, sms, 1, slices)
    tiles = -(-m // bk.TILE_COLS)
    assert tps * n_splits >= tiles > tps * (n_splits - 1)
    row_tiles = -(-b // bk.TILE_ROWS)
    assert n_splits * row_tiles * slices <= max(sms, row_tiles * slices)
