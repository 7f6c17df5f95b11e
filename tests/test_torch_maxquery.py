"""The port's max-over-query bank InfoNCE (kernels #9 and #10) against the
JAX package.

The JAX side runs `max_query_infonce_pallas` (and its `_run_forward` /
`_run_backward`) in Pallas interpret mode on this CPU host, as the JAX
package's own tests do, and `infonce.max_query_infonce`, its XLA reference.
The port side runs the plain versions (`max_query_infonce_reference`,
`max_query_infonce_stats_reference`, `max_query_infonce_bwd_reference`) that
the CUDA kernels are held against on the card (tests/test_torch_cuda.py,
chip_smoke.py). Inputs are numpy arrays from a seed, handed to both sides; a
`QuantBank` crosses as its two numpy arrays.

Tolerance 1e-5 (absolute and relative): both sides take float32 sims of
float32 feats and of bank values widened exactly to float32, (int8: times
the (m, q) scale before the max), then 1/tau; they differ in summation
order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.ops import bank_kernels as jbk
from spn4cir_tpu.ops import infonce as jinfonce
from spn4cir_tpu.ops import maxquery_kernels as jmq
from spn4cir_tpu_torch.ops import bank_kernels as bk
from spn4cir_tpu_torch.ops import infonce
from spn4cir_tpu_torch.ops import maxquery_kernels as mk

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
TAU = 0.05


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _case(rng, b, m, q, d=32):
    feats = _norm(rng.randn(b, d)).astype(np.float32)
    bank = _norm(rng.randn(m, q, d)).astype(np.float32)
    labels = rng.randint(0, m, size=b).astype(np.int64)
    return feats, bank, labels


def _banks(bank, kind):
    """(JAX bank, port bank) of one kind from the same float32 values."""
    if kind == "float32":
        return jnp.asarray(bank), torch.from_numpy(bank)
    if kind == "bfloat16":
        t = torch.from_numpy(bank).to(torch.bfloat16)
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t
    jq = jbk.quantize_bank(jnp.asarray(bank))
    return jq, bk.QuantBank(torch.from_numpy(np.array(jq.values)),
                            torch.from_numpy(np.array(jq.scales)))


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b,m,q", [(5, 37, 1), (9, 40, 8), (3, 19, 32)])
def test_plain_forward_matches_interpreted_pallas_kernel(kind, b, m, q, rng):
    """The four statistics and the loss, over ragged B and M (block_m 8
    leaves a partial last block on the JAX side)."""
    feats, bank, labels = _case(rng, b, m, q)
    jbank, tbank = _banks(bank, kind)
    want = jmq._run_forward(jnp.asarray(feats), jbank, jnp.asarray(labels),
                            TAU, block_b=8, block_m=8)
    got = mk.max_query_infonce_stats_reference(
        torch.from_numpy(feats), tbank, torch.from_numpy(labels), TAU)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)
    loss = mk.max_query_infonce_reference(torch.from_numpy(feats), tbank,
                                          torch.from_numpy(labels), TAU)
    np.testing.assert_allclose(
        loss.item(), float(jmq.max_query_infonce_pallas(
            jnp.asarray(feats), jbank, jnp.asarray(labels), TAU, 8, 8)),
        **TOL)
    # and the XLA route of the JAX package's dispatcher
    np.testing.assert_allclose(
        loss.item(), float(jmq.max_query_infonce(
            jnp.asarray(feats), jbank, jnp.asarray(labels), TAU,
            impl="xla")), **TOL)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b,m,q", [(5, 37, 1), (9, 40, 8), (3, 19, 32)])
def test_plain_gradients_match_pallas_vjp(kind, b, m, q, rng):
    """dfeats and dtau: autograd through the plain loss and the plain
    backward against `jax.grad` of the Pallas custom_vjp."""
    feats, bank, labels = _case(rng, b, m, q)
    jbank, tbank = _banks(bank, kind)
    jl = jnp.asarray(labels)
    want_df, want_dt = jax.grad(
        lambda f, t: jmq.max_query_infonce_pallas(f, jbank, jl, t, 8, 8),
        argnums=(0, 1))(jnp.asarray(feats), jnp.float32(TAU))
    leaf = torch.from_numpy(feats).requires_grad_()
    tau = torch.tensor(TAU, requires_grad=True)
    mk.max_query_infonce_reference(leaf, tbank, torch.from_numpy(labels),
                                   tau).backward()
    np.testing.assert_allclose(leaf.grad.numpy(), _np(want_df), **TOL)
    np.testing.assert_allclose(tau.grad.item(), float(want_dt), **TOL)

    ft, lt = torch.from_numpy(feats), torch.from_numpy(labels)
    stats = mk.max_query_infonce_stats_reference(ft, tbank, lt, TAU)
    dq = mk.max_query_infonce_bwd_reference(ft, tbank, lt, TAU, stats[0],
                                            stats[1], torch.tensor(1.0))
    np.testing.assert_allclose(dq.numpy(), _np(want_df), **TOL)
    np.testing.assert_allclose(bk.dtau_from_stats(stats, TAU).item(),
                               float(want_dt), **TOL)
    # the JAX backward kernel alone, from the same statistics
    g_rows = jnp.full((b,), 1.0 / (b * TAU), jnp.float32)
    jdq = jmq._run_backward(jnp.asarray(feats), jbank, jl, TAU,
                            jnp.asarray(stats[0].numpy()),
                            jnp.asarray(stats[1].numpy()), g_rows,
                            block_b=8, block_m=8)
    np.testing.assert_allclose(dq.numpy(), _np(jdq), **TOL)


def test_tie_routes_to_the_first_query_as_the_pallas_kernel(rng):
    """Exact ties with different bank rows behind them: small integers over
    8 keep every sim exact in float32, and query 3 of each bank row is query
    1 plus a vector orthogonal to every feats row (it lives in the last 8
    coordinates, where the feats are zero). The Pallas backward routes a
    tied weight to the first of the tied queries; so do the port's plain
    versions. amax's autograd (the materialising `infonce.
    max_query_infonce`) splits it between the two and gets another
    dfeats."""
    b, m, q, d = 4, 12, 5, 32
    feats = rng.randint(-3, 4, (b, d)).astype(np.float32) / 8
    feats[:, 24:] = 0.0
    bank = rng.randint(-3, 4, (m, q, d)).astype(np.float32) / 8
    bank[:, 1, :24] += feats.sum(0)[:24]   # query 1 wins nearly everywhere
    bank[:, 3] = bank[:, 1]
    bank[:, 3, 24:] += rng.randint(1, 4, (m, 8)).astype(np.float32) / 8
    labels = rng.randint(0, m, size=b).astype(np.int64)
    tau = 0.5
    ft, bt, lt = (torch.from_numpy(a) for a in (feats, bank, labels))
    sims = mk._sims(ft, bt)
    ties = (sims[..., 1] == sims[..., 3]) & (sims.argmax(-1) == 1)
    assert bool(ties.all()), ties.float().mean()
    want = jax.grad(lambda f: jmq.max_query_infonce_pallas(
        f, jnp.asarray(bank), jnp.asarray(labels), tau, 8, 8))(
            jnp.asarray(feats))
    leaf = ft.clone().requires_grad_()
    mk.max_query_infonce_reference(leaf, bt, lt, tau).backward()
    np.testing.assert_allclose(leaf.grad.numpy(), _np(want), **TOL)
    stats = mk.max_query_infonce_stats_reference(ft, bt, lt, tau)
    dq = mk.max_query_infonce_bwd_reference(ft, bt, lt, tau, stats[0],
                                            stats[1], torch.tensor(1.0))
    np.testing.assert_allclose(dq.numpy(), _np(want), **TOL)
    split = ft.clone().requires_grad_()
    infonce.max_query_infonce(split, bt, lt, tau).backward()
    assert (split.grad - leaf.grad)[:, 24:].abs().max() > 1e-3
    np.testing.assert_allclose(split.grad[:, :24].numpy(),
                               leaf.grad[:, :24].numpy(), **TOL)


@pytest.mark.parametrize("q", [1, 8])
def test_plain_losses_and_scores_match_jax(q, rng):
    """The materialising `infonce.max_query_infonce` / `max_query_scores`
    and the int8 gallery scores against the JAX package."""
    from spn4cir_tpu.serve.service import quantized_score_queries as jqs
    from spn4cir_tpu_torch.eval.retrieval import quantized_score_queries

    feats, bank, labels = _case(rng, 6, 23, q)
    ft, bt, lt = (torch.from_numpy(a) for a in (feats, bank, labels))
    np.testing.assert_allclose(
        infonce.max_query_infonce(ft, bt, lt, TAU).item(),
        float(jinfonce.max_query_infonce(jnp.asarray(feats),
                                         jnp.asarray(bank),
                                         jnp.asarray(labels), TAU)), **TOL)
    np.testing.assert_allclose(
        infonce.max_query_scores(ft, bt).numpy(),
        _np(jinfonce.max_query_scores(jnp.asarray(feats), jnp.asarray(bank))),
        **TOL)
    jq, tq = _banks(bank, "int8")
    np.testing.assert_allclose(quantized_score_queries(ft, tq).numpy(),
                               _np(jqs(jnp.asarray(feats), jq)), **TOL)
    # a flat int8 gallery still scores by the cosine dot
    flat = bk.quantize_bank(torch.from_numpy(bank[:, 0]))
    np.testing.assert_allclose(
        quantized_score_queries(ft, flat).numpy(),
        (ft @ flat.dequantize().T).numpy(), **TOL)


def test_quantize_bank_3d_equals_jax(rng):
    bank = rng.randn(7, 5, 32).astype(np.float32)
    want = jbk.quantize_bank(jnp.asarray(bank))
    got = bk.quantize_bank(torch.from_numpy(bank))
    assert got.values.shape == (7, 5, 32) and got.scales.shape == (7, 5)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


def test_cpu_route_is_the_plain_version_and_counts_nothing(rng):
    feats, bank, labels = _case(rng, 4, 9, 3)
    before = (mk.max_query_infonce_fwd.launches,
              mk.max_query_infonce_bwd.launches)
    leaf = torch.from_numpy(feats).requires_grad_()
    loss = mk.max_query_infonce(leaf, torch.from_numpy(bank),
                                torch.from_numpy(labels), TAU)
    loss.backward()
    assert torch.equal(loss, mk.max_query_infonce_reference(
        torch.from_numpy(feats), torch.from_numpy(bank),
        torch.from_numpy(labels), TAU))
    assert (mk.max_query_infonce_fwd.launches,
            mk.max_query_infonce_bwd.launches) == before
    # a wrapper launches on CUDA or raises: never the plain version
    with pytest.raises(ValueError, match="CUDA"):
        mk.max_query_infonce_fwd(torch.from_numpy(feats),
                                 torch.from_numpy(bank),
                                 torch.from_numpy(labels), TAU)
    with pytest.raises(ValueError, match="CUDA"):
        mk.max_query_infonce_bwd(torch.from_numpy(feats),
                                 torch.from_numpy(bank),
                                 torch.from_numpy(labels), TAU,
                                 torch.zeros(4), torch.ones(4),
                                 torch.tensor(1.0))


@pytest.mark.parametrize("b,m", [(1, 1), (5, 1000), (32, 65536), (33, 65536),
                                 (256, 4001)])
def test_split_plan_covers_the_bank(b, m):
    """Every tile of 256 bank rows in exactly one split, no empty split,
    about one CTA per SM (132 on an H100) counting the 32-row tiles of
    feats."""
    tps, n = mk.split_plan(m, b, 132)
    tiles = -(-m // mk.TILE_COLS)
    assert tps * n >= tiles > tps * (n - 1)
    row_tiles = -(-b // mk.TILE_ROWS)
    assert n * row_tiles <= max(132, row_tiles)
    assert (mk.TILE_ROWS, mk.TILE_COLS) == (32, 256)


def test_shapes_the_kernels_refuse():
    """Checked before any launch: the bank must be (M, Q, D) sharing feats'
    D; int8 scales must be (M, Q); and, on CUDA tensors, D must be a
    multiple of 32 and at most 512."""
    f = torch.zeros(4, 40)
    lab = torch.zeros(4, dtype=torch.long)
    with pytest.raises(ValueError, match="share D"):
        mk._check(f, torch.zeros(3, 40), lab)
    with pytest.raises(ValueError, match="scales must be"):
        mk._check(f, bk.QuantBank(torch.zeros(3, 2, 40, dtype=torch.int8),
                                  torch.zeros(3)), lab)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mk._check(f, torch.zeros(3, 2, 40, dtype=torch.float16), lab)
    assert (mk.CHUNK, mk.MAX_DIM) == (32, 512)
