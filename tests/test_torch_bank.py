"""The port's bank InfoNCE, banks and negative sampling against the JAX
package.

The JAX side runs `bank_infonce_pallas` in Pallas interpret mode on this
CPU host (as tests/test_bank_kernel.py does) and the XLA oracle
`ops/infonce.bank_infonce` under `jax.grad`. The port side runs the plain
versions (`bank_infonce_reference`, `bank_infonce_stats_reference`,
`bank_infonce_bwd_reference`) that the CUDA kernels are held against on the
card (tests/test_torch_cuda.py, chip_smoke.py). Inputs are numpy arrays from
a seed, handed to both sides.

Tolerances: float32 loss, dQ and dtau within atol = rtol = 1e-5 (the sides
differ in summation order only). bfloat16 bank: both sides widen the bank to
float32 before the product, so the same 1e-5 holds against the Pallas
kernel; against the XLA oracle fed the widened bank likewise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.bank import bank as jax_bank
from spn4cir_tpu.bank.bank import Bank as JaxBank
from spn4cir_tpu.ops import infonce as jax_infonce
from spn4cir_tpu.ops.bank_kernels import bank_infonce_pallas
from spn4cir_tpu.train.stage2 import sample_negatives as jax_sample_negatives
from spn4cir_tpu_torch.bank.bank import (Bank, extend_target_bank,
                                         extract_banks,
                                         extract_unlabeled_features)
from spn4cir_tpu_torch.ops import bank_kernels as bk
from spn4cir_tpu_torch.ops import infonce
from spn4cir_tpu_torch.train.stage2 import sample_negatives

torch.set_num_threads(1)

ATOL = RTOL = 1e-5


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _case(rng, b, m, d):
    q = _norm(rng.randn(b, d)).astype(np.float32)
    bank = _norm(rng.randn(m, d)).astype(np.float32)
    labels = rng.randint(0, m, size=b).astype(np.int64)
    return q, bank, labels


def _port_loss_and_grads(fn, q, bank, labels, tau, bank_dtype=torch.float32):
    qt = torch.from_numpy(q).requires_grad_()
    tt = torch.tensor(tau, dtype=torch.float32, requires_grad=True)
    loss = fn(qt, torch.from_numpy(bank).to(bank_dtype),
              torch.from_numpy(labels), tt)
    loss.backward()
    return loss.item(), qt.grad.numpy(), tt.grad.item()


SHAPES = [(8, 64, 32), (16, 300, 64), (9, 130, 16), (5, 2049, 32)]


@pytest.mark.parametrize("b,m,d", SHAPES)
@pytest.mark.parametrize("tau", [0.07, 0.02])
def test_loss_and_grads_match_pallas_and_xla(b, m, d, tau, rng):
    q, bank, labels = _case(rng, b, m, d)
    jq, jb, jl = jnp.asarray(q), jnp.asarray(bank), jnp.asarray(labels)
    got = _port_loss_and_grads(bk.bank_infonce, q, bank, labels, tau)
    for jax_fn in (lambda q_, t_: bank_infonce_pallas(q_, jb, jl, t_, 8, 128),
                   lambda q_, t_: jax_infonce.bank_infonce(q_, jb, jl, t_)):
        want, (dq, dtau) = jax.value_and_grad(jax_fn, argnums=(0, 1))(
            jq, jnp.float32(tau))
        np.testing.assert_allclose(got[0], float(want), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got[1], np.asarray(dq), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got[2], float(dtau), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,m,d", [(9, 130, 16), (5, 2049, 32)])
def test_bf16_bank_matches_pallas(b, m, d, rng):
    """Both sides widen the bfloat16 bank to float32 before the product."""
    q, bank, labels = _case(rng, b, m, d)
    tau = 0.05
    jb16 = jnp.asarray(bank).astype(jnp.bfloat16)
    bank16 = np.array(jb16.astype(jnp.float32))         # the rounded values
    got = _port_loss_and_grads(bk.bank_infonce, q, bank16, labels, tau,
                               bank_dtype=torch.bfloat16)
    want, (dq, dtau) = jax.value_and_grad(
        lambda q_, t_: bank_infonce_pallas(q_, jb16, jnp.asarray(labels), t_,
                                           8, 128), argnums=(0, 1))(
        jnp.asarray(q), jnp.float32(tau))
    np.testing.assert_allclose(got[0], float(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[1], np.asarray(dq), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[2], float(dtau), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,m,d", SHAPES)
def test_stats_and_backward_references_are_consistent(b, m, d, rng):
    """The plain versions of the two kernels agree with the fused plain
    loss: loss from the four statistics, dQ from (mx, se), dtau from
    (se, pos, el)."""
    q, bank, labels = _case(rng, b, m, d)
    tau = 0.03
    loss, dq, dtau = _port_loss_and_grads(bk.bank_infonce_reference, q, bank,
                                          labels, tau)
    qt, bt, lt = (torch.from_numpy(a) for a in (q, bank, labels))
    mx, se, pos, el = bk.bank_infonce_stats_reference(qt, bt, lt, tau)
    np.testing.assert_allclose((se.log() + mx - pos).mean().item(), loss,
                               atol=ATOL, rtol=RTOL)
    got_dq = bk.bank_infonce_bwd_reference(qt, bt, lt, tau, mx, se,
                                           torch.tensor(1.0))
    np.testing.assert_allclose(got_dq.numpy(), dq, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        bk.dtau_from_stats((mx, se, pos, el), tau).item(), dtau,
        atol=ATOL, rtol=RTOL)


def test_cpu_route_counts_no_launch_and_bank_gets_no_grad(rng):
    q, bank, labels = _case(rng, 4, 50, 16)
    qt = torch.from_numpy(q).requires_grad_()
    bt = torch.from_numpy(bank).requires_grad_()
    before = (bk.bank_infonce_fwd.launches, bk.bank_infonce_bwd.launches)
    bk.bank_infonce(qt, bt, torch.from_numpy(labels), 0.1).backward()
    assert (bk.bank_infonce_fwd.launches, bk.bank_infonce_bwd.launches) == before
    assert qt.grad is not None and bt.grad is None


def test_each_kernel_wrapper_refuses_the_other_bank_type(rng):
    """The dense wrappers refuse a QuantBank and the int8 wrappers a dense
    bank, before any device check: a launch is never counted on the wrong
    kernel. (`bank_infonce` takes both; tests/test_torch_q8_bank.py holds
    the int8 numbers.)"""
    q, bank, labels = _case(rng, 4, 50, 16)
    qt, lt = torch.from_numpy(q), torch.from_numpy(labels)
    dense = torch.from_numpy(bank)
    qbank = bk.quantize_bank(dense)
    stats = (torch.zeros(4), torch.ones(4), torch.tensor(1.0))
    with pytest.raises(ValueError, match="dense float32 or bfloat16"):
        bk.bank_infonce_fwd(qt, qbank, lt, 0.1)
    with pytest.raises(ValueError, match="dense float32 or bfloat16"):
        bk.bank_infonce_bwd(qt, qbank, lt, 0.1, *stats)
    with pytest.raises(ValueError, match="QuantBank"):
        bk.bank_infonce_q8_fwd(qt, dense, lt, 0.1)
    with pytest.raises(ValueError, match="QuantBank"):
        bk.bank_infonce_q8_bwd(qt, dense, lt, 0.1, *stats)


@pytest.mark.parametrize("b,m,d", [(5, 131, 640), (70, 257, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_reference_at_widths_past_512(b, m, d, dtype, rng):
    """`bank_infonce_bwd_reference` at RN50x4's and ViT-L/14's widths with
    ragged B and M, against autograd through the plain loss and against the
    JAX package's Pallas kernel in interpret mode."""
    q, bank, labels = _case(rng, b, m, d)
    tau = 0.02
    bt = torch.from_numpy(bank).to(dtype)
    loss, dq, _ = _port_loss_and_grads(bk.bank_infonce_reference, q,
                                       bt.float().numpy(), labels, tau,
                                       bank_dtype=dtype)
    qt, lt = torch.from_numpy(q), torch.from_numpy(labels)
    mx, se, _, _ = bk.bank_infonce_stats_reference(qt, bt, lt, tau)
    got = bk.bank_infonce_bwd_reference(qt, bt, lt, tau, mx, se,
                                        torch.tensor(1.0))
    np.testing.assert_allclose(got.numpy(), dq, atol=ATOL, rtol=RTOL)
    jb = jnp.asarray(bt.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want, jdq = jax.value_and_grad(
        lambda q_: bank_infonce_pallas(q_, jb, jnp.asarray(labels),
                                       jnp.float32(tau), 8, 128))(
        jnp.asarray(q))
    np.testing.assert_allclose(loss, float(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jdq), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("shape,msg", [
    (((4, 16), (50, 32), (4,)), "share D"),
    (((4, 16), (50, 16), (5,)), "labels"),
    (((4, 24), (50, 24), (4,)), "D % 16"),
])
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(shape, msg):
    q, bank, labels = (torch.zeros(s) for s in shape)
    with pytest.raises(ValueError, match=msg):
        bk.bank_infonce_fwd(q, bank, labels.long(), 0.1)


def test_kernel_wrappers_refuse_cpu_tensors():
    q, bank, labels = torch.zeros(4, 16), torch.zeros(9, 16), torch.zeros(4).long()
    with pytest.raises(ValueError, match="CUDA kernel"):
        bk.bank_infonce_fwd(q, bank, labels, 0.1)
    with pytest.raises(ValueError, match="CUDA kernel"):
        bk.bank_infonce_bwd(q, bank, labels, 0.1, torch.zeros(4), torch.ones(4),
                            torch.ones(()))


@pytest.mark.parametrize("m,b,sms,per_sm", [
    (2049, 256, 132, 2), (65536, 256, 132, 2), (65536, 256, 132, 1),
    (100, 5, 132, 1), (16384, 1024, 132, 1), (60000, 256, 108, 2)])
def test_split_plan_covers_the_bank_with_no_empty_split(m, b, sms, per_sm):
    tps, n_splits = bk.split_plan(m, b, sms, per_sm)
    tiles = -(-m // bk.TILE_COLS)
    assert tps * n_splits >= tiles > tps * (n_splits - 1)
    row_tiles = -(-b // bk.TILE_ROWS)
    assert n_splits * row_tiles <= max(sms * per_sm, row_tiles)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_batch_and_sampled_neg_infonce_match_jax(dtype, rng):
    q, bank, labels = _case(rng, 6, 40, 16)
    neg_idx = np.stack([rng.choice(39, 7, replace=False) for _ in range(6)])
    neg_idx = neg_idx + (neg_idx >= labels[:, None])
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    tq, tb = torch.from_numpy(q).to(tdt), torch.from_numpy(bank).to(tdt)
    jq, jb = jnp.asarray(q).astype(jdt), jnp.asarray(bank).astype(jdt)
    got = infonce.sampled_neg_infonce(tq, tb, torch.from_numpy(labels),
                                      torch.from_numpy(neg_idx), 0.05)
    want = jax_infonce.sampled_neg_infonce(jq, jb, jnp.asarray(labels),
                                           jnp.asarray(neg_idx), 0.05)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=RTOL)
    got = infonce.in_batch_infonce(tq, tb[:6], 0.05)
    want = jax_infonce.in_batch_infonce(jq, jb[:6], 0.05)
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=RTOL)
    got = infonce.bank_infonce(tq, tb, torch.from_numpy(labels), 0.05)
    want = jax_infonce.bank_infonce(jq, jb, jnp.asarray(labels), 0.05)
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=RTOL)
    logits = rng.randn(6, 11).astype(np.float32)
    np.testing.assert_allclose(
        infonce.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels % 11)).item(),
        float(jax_infonce.cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(labels % 11))),
        atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("num_images,neg_num", [(50, 7), (20, 19), (1000, 64)])
def test_sample_negatives_draw_for_draw(num_images, neg_num):
    pos = np.random.RandomState(1).randint(0, num_images, size=9)
    want = jax_sample_negatives(np.random.RandomState(7), pos, num_images, neg_num)
    got = sample_negatives(np.random.RandomState(7), pos, num_images, neg_num)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    assert not (got == pos[:, None]).any()
    assert all(len(set(row)) == neg_num for row in got)
    with pytest.raises(ValueError, match="neg_num"):
        sample_negatives(np.random.RandomState(0), pos, 5, 5)


def _bank_arrays(rng):
    refer = rng.randn(11, 8).astype(np.float32)
    target = _norm(rng.randn(11, 8)).astype(np.float32)
    return refer, target


def test_bank_npz_round_trip_across_packages(tmp_path, rng):
    refer, target = _bank_arrays(rng)
    batch = {"refer_image_id": np.array([3, 0, 10]), "triplet_idx": np.array([1, 2, 4])}

    ours = Bank(refer=refer, target=torch.from_numpy(target))
    ours.save(str(tmp_path / "ours"))              # extensionless: .npz appended
    theirs = JaxBank.load(str(tmp_path / "ours"))
    np.testing.assert_array_equal(theirs.refer, refer)
    np.testing.assert_array_equal(np.asarray(theirs.target), target)
    assert theirs.refer_key == "image"

    JaxBank(refer=refer, target=jnp.asarray(target), refer_key="triplet").save(
        str(tmp_path / "theirs.npz"))
    back = Bank.load(str(tmp_path / "theirs.npz"))
    np.testing.assert_array_equal(back.refer, refer)
    np.testing.assert_array_equal(back.target.numpy(), target)
    assert back.refer_key == "triplet" and back.num_images == 11
    np.testing.assert_array_equal(back.gather_refer(batch), refer[[1, 2, 4]])
    np.testing.assert_array_equal(ours.gather_refer(batch), refer[[3, 0, 10]])

    # a bfloat16 target is stored widened to float32 (exact)
    Bank(refer=refer, target=torch.from_numpy(target).to(torch.bfloat16)).save(
        str(tmp_path / "bf16"))
    wide = Bank.load(str(tmp_path / "bf16"))
    assert wide.target.dtype == torch.float32
    np.testing.assert_array_equal(
        wide.target.numpy(),
        torch.from_numpy(target).to(torch.bfloat16).float().numpy())


def test_extract_banks_scatter_padding_and_cache(tmp_path, rng):
    refer, target = _bank_arrays(rng)
    images = rng.randn(11, 4, 4, 3).astype(np.float32)
    calls = []

    def features(batch):
        calls.append(batch.shape[0])
        idx = [int(np.argmin(np.abs(images - b.numpy()).sum(axis=(1, 2, 3))))
               for b in batch]
        return torch.from_numpy(refer[idx]), torch.from_numpy(target[idx])

    def batches():
        for start in range(0, 11, 4):
            ids = np.arange(start, min(start + 4, 11))
            pad = 4 - len(ids)
            imgs = images[ids]
            if pad:
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
                ids = np.concatenate([ids, np.full(pad, -1)])
            yield ids, imgs

    cache = str(tmp_path / "bank")
    bank = extract_banks(features, batches(), 11, cache_path=cache)
    np.testing.assert_array_equal(bank.refer, refer)
    np.testing.assert_array_equal(bank.target.numpy(), target)
    assert calls == [4, 4, 4] and not bank.target.is_inference()
    again = extract_banks(features, batches(), 11, cache_path=cache)
    assert calls == [4, 4, 4]                       # loaded, not re-encoded
    np.testing.assert_array_equal(again.target.numpy(), target)
    extract_banks(features, batches(), 11, cache_path=cache, reload=True)
    assert len(calls) == 6
    with pytest.raises(ValueError, match="no image batches"):
        extract_banks(features, iter(()), 11)


def _unlabeled_batches(images, batch=4):
    n = len(images)
    for start in range(0, n, batch):
        ids = np.arange(start, min(start + batch, n))
        pad = batch - len(ids)
        imgs = images[ids]
        if pad:
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
            ids = np.concatenate([ids, np.full(pad, -1)])
        yield ids, imgs


def test_unlabeled_features_equal_jax_row_for_row_and_share_the_cache(
        tmp_path, rng):
    images = rng.randn(10, 4, 4, 3).astype(np.float32)
    w = rng.randn(48, 8).astype(np.float32)

    def encode_np(batch):
        return _norm(batch.reshape(len(batch), -1) @ w).astype(np.float32)

    calls = []

    def encode_t(batch):
        calls.append(len(batch))
        return torch.from_numpy(encode_np(batch.numpy()))

    want = jax_bank.extract_unlabeled_features(
        lambda b: jnp.asarray(encode_np(np.asarray(b))),
        _unlabeled_batches(images), 10,
        cache_path=str(tmp_path / "jax_unlabeled.npz"))
    cache = str(tmp_path / "bank_unlabeled.npz")
    got = extract_unlabeled_features(encode_t, _unlabeled_batches(images), 10,
                                     cache_path=cache)
    np.testing.assert_array_equal(got, want)
    assert calls == [4, 4, 4]
    # same key in the file: either package reads the other's cache
    assert list(np.load(cache).keys()) == ["unlabeled"]
    np.testing.assert_array_equal(
        jax_bank.extract_unlabeled_features(None, iter(()), 10,
                                            cache_path=cache), want)
    again = extract_unlabeled_features(
        encode_t, iter(()), 10, cache_path=str(tmp_path / "jax_unlabeled.npz"))
    np.testing.assert_array_equal(again, want)
    assert calls == [4, 4, 4]
    extract_unlabeled_features(encode_t, _unlabeled_batches(images), 10,
                               cache_path=cache, reload=True)
    assert len(calls) == 6
    with pytest.raises(ValueError, match="no unlabeled batches"):
        extract_unlabeled_features(encode_t, iter(()), 10)


@pytest.mark.parametrize("neg_num", [0, 3, 50])
def test_extend_target_bank_matches_jax(neg_num, rng):
    refer, target = _bank_arrays(rng)
    extra = _norm(rng.randn(6, 8)).astype(np.float32)
    want = jax_bank.extend_target_bank(
        JaxBank(refer=refer, target=jnp.asarray(target)), extra, neg_num)
    got = extend_target_bank(Bank(refer=refer,
                                  target=torch.from_numpy(target)),
                             extra, neg_num)
    np.testing.assert_array_equal(got.target.numpy(), np.asarray(want.target))
    assert got.num_images == 11 + (3 if neg_num == 3 else 6)
    assert got.refer is refer and got.refer_key == "image"
    # the positives keep their ids in the first rows
    np.testing.assert_array_equal(got.target[:11].numpy(), target)
