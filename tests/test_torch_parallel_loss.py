"""The port's process groups (`parallel/mesh.py`) and bank-sharded InfoNCE
(`parallel/loss.py`) against the JAX package, on the CPU.

The torch side runs in gloo process groups of 2 and 4 ranks spawned by
`torch_dist.DistPool` (one pool per world size for the module, each task
under a 120 s watchdog); the oracle is the JAX package's
`sharded_bank_infonce` / `sharded_max_query_infonce` on the 8-device CPU
mesh of `tests/conftest.py`, and its single-device losses. The same numpy
inputs from a seed go to both. Tolerances: the loss within 1e-5 relative at
float32, dQ and dtau within 1e-4 (the JAX package's own tests,
`tests/test_parallel.py:28-53`, `:95-117`, `:206-240`).

Also: the init gate, the rank layout, the plain shard statistics with
labels outside the shard (the bank kernels' contract) against the JAX
shard bodies, and the route the loss takes on a CUDA tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.ops import bank_kernels as jbk
from spn4cir_tpu.ops import infonce as jinfonce
from spn4cir_tpu.parallel import loss as jloss
from spn4cir_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spn4cir_tpu_torch.ops import bank_kernels as bk
from spn4cir_tpu_torch.ops import maxquery_kernels as mq
from spn4cir_tpu_torch.parallel import loss as ploss
from spn4cir_tpu_torch.parallel import mesh as pm
from torch_dist import Pools

TAU = 0.05
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pools():
    p = Pools()
    yield p
    p.close()


def _norm(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _q8(x):
    q = bk.quantize_bank(torch.from_numpy(x))
    return q.values.numpy(), q.scales.numpy()


def _jax_bank(bank):
    if isinstance(bank, tuple):
        return jbk.QuantBank(jnp.asarray(bank[0]), jnp.asarray(bank[1]))
    return jnp.asarray(bank)


def _jax_sharded(q, bank, labels, data, n_bank, m, max_query):
    """Loss, dQ and dtau of the JAX package's sharded loss."""
    mesh = jax_make_mesh(data=data, bank=n_bank,
                         devices=jax.devices()[:data * n_bank])
    padded = jloss.pad_bank_rows(_jax_bank(bank), n_bank)
    fn = (jloss.sharded_max_query_infonce if max_query
          else jloss.sharded_bank_infonce)
    loss, (dq, dtau) = jax.value_and_grad(
        lambda q_, t: fn(q_, padded, jnp.asarray(labels), t, mesh,
                         m_actual=m), argnums=(0, 1))(jnp.asarray(q),
                                                      jnp.float32(TAU))
    return float(loss), np.asarray(dq), float(dtau)


def _jax_shard_bodies(q, bank, labels, n_bank, m, max_query):
    """The JAX package's shard bodies (`_local_bank_infonce`,
    `_local_max_query_infonce`: the masked positive, the pmax / psum
    combine) over `n_bank` shards, run under nested vmaps named 'data' and
    'bank' in place of shard_map; the loss."""
    padded = jloss.pad_bank_rows(_jax_bank(bank), n_bank)

    def split(x):
        return x.reshape(n_bank, x.shape[0] // n_bank, *x.shape[1:])

    shards = (jbk.QuantBank(split(padded.values), split(padded.scales))
              if isinstance(padded, jbk.QuantBank) else split(padded))
    body = (jloss._local_max_query_infonce if max_query
            else jloss._local_bank_infonce)
    inner = jax.vmap(lambda q_, b_, l_: body(q_, b_, l_, TAU, m),
                     in_axes=(None, 0, None), axis_name="bank")
    outer = jax.vmap(inner, in_axes=(0, None, 0), axis_name="data")
    return float(outer(jnp.asarray(q)[None], shards,
                       jnp.asarray(labels)[None])[0, 0])


def _assemble(outs):
    """The global dQ (data shards in order; every bank rank of a data shard
    holds the whole of it) and dtau (the data shards' shares summed)."""
    first = {o["data"]: o for o in outs if o["bank"] == 0}
    dq = np.concatenate([first[i]["dq"] for i in sorted(first)])
    return dq, sum(o["dtau"] for o in first.values())


# --------------------------------------------------------------------------
# the gate, the layout, the helpers
# --------------------------------------------------------------------------

def test_initialize_distributed_noop_without_gate(monkeypatch):
    """No variables, no arguments: False, and no process group."""
    for var in ("SPN4CIR_DISTRIBUTED", "SPN4CIR_DIST_COORDINATOR",
                "SPN4CIR_DIST_NPROCS", "SPN4CIR_DIST_PROC_ID", "WORLD_SIZE",
                "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert pm.initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert pm.world_size() == 1 and pm.rank() == 0 and pm.process_is_main()


def test_mesh_of_one_process_has_no_groups():
    mesh = pm.make_mesh()
    assert mesh.shape == {"data": 1, "bank": 1, "model": 1}
    assert all(mesh.group(a) is None for a in pm.AXES)
    assert pm.make_hybrid_mesh(bank=1).shape == mesh.shape
    with pytest.raises(ValueError, match="world size"):
        pm.make_mesh(data=1, bank=2)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 4), (4, 2, 1)])
def test_axis_groups_follow_the_jax_row_major_layout(shape):
    """A group of an axis: the ranks that differ only in it, the devices
    of one line of the JAX `make_mesh` array reshaped (data, bank, model)."""
    mesh = pm.Mesh.__new__(pm.Mesh)
    mesh.sizes = dict(zip(pm.AXES, shape))
    grid = np.arange(np.prod(shape)).reshape(shape)
    for k, axis in enumerate(pm.AXES):
        want = sorted(sorted(line) for line in
                      np.moveaxis(grid, k, -1).reshape(-1, shape[k]).tolist())
        assert sorted(mesh.axis_ranks(axis)) == want, axis


def test_mesh_groups_on_four_ranks(pools):
    outs = pools(4).run("torch_dist_workers:mesh_layout", 1, 2, 2)
    for rank, o in enumerate(outs):
        assert o["coords"] == {"data": 0, "bank": rank // 2,
                               "model": rank % 2}
        assert o["groups"]["model"] == [rank - rank % 2, rank - rank % 2 + 1]
        assert o["groups"]["bank"] == [rank % 2, rank % 2 + 2]
        assert o["groups"]["data"] == [rank]


def test_pad_and_shard_rows():
    bank = torch.arange(10.0).reshape(5, 2)
    padded = pm.pad_bank_rows(bank, 4)
    assert padded.shape == (8, 2) and torch.equal(padded[:5], bank)
    assert not padded[5:].any()
    q = bk.quantize_bank(bank)
    pq = pm.pad_bank_rows(q, 3)
    assert pq.values.shape == (6, 2) and pq.scales.shape == (6,)
    assert pm.shard_extent(5, 4, 3) == (6, 2)
    assert [ploss.shard_valid_rows(5, o, 2) for o in (0, 2, 4, 6)] == [
        2, 2, 1, 0]
    mesh = pm.Mesh.__new__(pm.Mesh)
    mesh.sizes = {"data": 2, "bank": 1, "model": 1}
    mesh.coords = {"data": 1, "bank": 0, "model": 0}
    batch = {"x": np.arange(6), "caps": list("abcdef")}
    assert pm.local_rows(batch, mesh)["caps"] == list("def")
    with pytest.raises(ValueError, match="split"):
        pm.local_rows(np.arange(5), mesh)


# --------------------------------------------------------------------------
# labels outside the shard: the plain versions against the JAX shard body
# --------------------------------------------------------------------------

def _shard_stats_combined(q, shards, labels, tau, max_query):
    """The port's plain shard statistics, combined as the Function does."""
    mxs, ses, poss, els = [], [], [], []
    offset = 0
    for shard in shards:
        m = shard.shape[0]
        local = labels - offset
        if max_query:
            res = mq.max_query_infonce_residuals_reference(q, shard, tau)
            stats = bk._stats(res[0], local)
        else:
            ref = (bk.bank_infonce_q8_stats_reference
                   if isinstance(shard, bk.QuantBank)
                   else bk.bank_infonce_stats_reference)
            stats = ref(q, shard, local, tau)
        for acc, s in zip((mxs, ses, poss, els), stats):
            acc.append(s)
        offset += m
    mx = torch.stack(mxs)
    gmax = mx.max(0).values
    e = torch.exp(mx - gmax)
    gse = (torch.stack(ses) * e).sum(0)
    gpos = torch.stack(poss).sum(0)
    return (torch.log(gse) + gmax - gpos).mean()


@pytest.mark.parametrize("kind", ["float32", "int8", "max_query",
                                  "max_query_int8"])
def test_out_of_shard_labels_in_the_plain_versions(kind, rng):
    """Every label lies in one shard and outside the others: each shard's
    plain statistics take pos = 0 there, and combined they give the JAX
    sharded loss (whose shard bodies mask the positive the same way) and
    the single-device loss."""
    b, m, d = 6, 24, 16
    max_query = kind.startswith("max_query")
    shape = (m, 4, d) if max_query else (m, d)
    bank = _norm(rng.randn(*shape))
    q = _norm(rng.randn(b, d))
    labels = rng.randint(0, m, b).astype(np.int64)
    t_bank = (bk.QuantBank(*map(torch.from_numpy, _q8(bank)))
              if kind.endswith("int8") else torch.from_numpy(bank))
    shards = ([bk.QuantBank(t_bank.values[i:i + 8], t_bank.scales[i:i + 8])
               for i in range(0, m, 8)] if kind.endswith("int8")
              else list(t_bank.split(8)))
    got = _shard_stats_combined(torch.from_numpy(q), shards,
                                torch.from_numpy(labels), TAU, max_query)
    want = _jax_shard_bodies(q, _q8(bank) if kind.endswith("int8") else bank,
                             labels, 3, m, max_query)
    np.testing.assert_allclose(got.item(), want, rtol=LOSS_RTOL)
    # each label is outside two of the three shards: pos 0 there
    for i, shard in enumerate(shards):
        local = torch.from_numpy(labels) - 8 * i
        logits = (mq.max_query_infonce_residuals_reference(
                      torch.from_numpy(q), shard, TAU)[0] if max_query else
                  bk._q8_logits(torch.from_numpy(q), shard, TAU)
                  if kind.endswith("int8") else
                  bk._logits(torch.from_numpy(q), shard, TAU))
        pos = bk._stats(logits, local)[2]
        outside = (local < 0) | (local >= 8)
        assert (pos[outside] == 0).all()
        inside = ~outside
        rows = torch.arange(b)[inside]
        assert torch.equal(pos[inside], logits[rows, local[inside]])
        # the coefficient has no one-hot in an outside row
        mx, se = logits.amax(1), torch.exp(logits - logits.amax(1,
                                                                keepdim=True)
                                           ).sum(1)
        coef = bk._coefficient(logits, local, TAU, mx, se, torch.ones(1))
        p = torch.exp(logits - mx[:, None]) / se[:, None] / (b * TAU)
        torch.testing.assert_close(coef[outside], p[outside])


def test_plain_stats_match_the_jax_single_device_loss_with_global_labels(rng):
    """With no label outside, the plain loss is the JAX package's."""
    q, bank = _norm(rng.randn(5, 16)), _norm(rng.randn(30, 16))
    labels = rng.randint(0, 30, 5)
    got = bk.bank_infonce_reference(torch.from_numpy(q),
                                    torch.from_numpy(bank),
                                    torch.from_numpy(labels), TAU)
    want = jinfonce.bank_infonce(jnp.asarray(q), jnp.asarray(bank),
                                 jnp.asarray(labels), TAU)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


# --------------------------------------------------------------------------
# the sharded losses over gloo ranks against the JAX package
# --------------------------------------------------------------------------

KINDS = ("float32", "bfloat16", "int8", "max_query", "max_query_int8")
M = 9        # over 4 shards of 3 rows the last one holds only padding


@pytest.fixture(scope="module")
def oracle():
    """Per bank kind: the inputs (numpy, from a seed) and the JAX package's
    sharded loss, dQ and dtau on them at (data 1, bank 4), with M = 9 (the
    value does not depend on the mesh), checked once against its
    single-device loss. One JAX evaluation per kind serves every mesh."""
    cache = {}

    def get(kind):
        if kind in cache:
            return cache[kind]
        rng = np.random.RandomState(KINDS.index(kind))
        b, d = 8, 32
        max_query = kind.startswith("max_query")
        bank = _norm(rng.randn(*((M, 4, d) if max_query else (M, d))))
        q = _norm(rng.randn(b, d))
        labels = rng.randint(0, M, b).astype(np.int64)
        if kind.endswith("int8"):
            bank = _q8(bank)
        elif kind == "bfloat16":
            # both sides widen the same bf16 values
            bank = torch.from_numpy(bank).bfloat16().float().numpy()
        want = _jax_sharded(q, bank, labels, 1, 4, M, max_query)
        if not kind.endswith("int8"):
            single = (jinfonce.max_query_infonce if max_query
                      else jinfonce.bank_infonce)
            np.testing.assert_allclose(
                want[0], float(single(jnp.asarray(q), jnp.asarray(bank),
                                      jnp.asarray(labels), TAU)),
                rtol=LOSS_RTOL)
        cache[kind] = (q, bank, labels, max_query, want)
        return cache[kind]

    return get


CASES = [(1, 2, "float32"), (2, 1, "float32"), (2, 2, "float32"),
         (1, 4, "float32"), (2, 2, "bfloat16"), (2, 2, "int8"),
         (1, 4, "max_query"), (2, 2, "max_query"), (2, 2, "max_query_int8")]


@pytest.mark.parametrize("data,n_bank,kind", CASES)
def test_sharded_loss_matches_jax(pools, oracle, data, n_bank, kind):
    """M = 9 rows over the bank axis: no shard count divides it, and over 4
    shards the last holds only padding (it launches nothing and adds
    mx = -inf, se = 0)."""
    q, bank, labels, max_query, (want_loss, want_dq, want_dtau) = \
        oracle(kind)
    outs = pools(data * n_bank).run(
        "torch_dist_workers:sharded_loss", data, n_bank, max_query, q, bank,
        labels, TAU, M, kind == "bfloat16")
    for o in outs:
        np.testing.assert_allclose(o["loss"], want_loss, rtol=LOSS_RTOL)
    dq, dtau = _assemble(outs)
    np.testing.assert_allclose(dq, want_dq, **GRAD_TOL)
    np.testing.assert_allclose(dtau, want_dtau, **GRAD_TOL)


# --------------------------------------------------------------------------
# the route on a CUDA tensor
# --------------------------------------------------------------------------

def test_shard_route_is_the_kernels_on_cuda():
    assert ploss.shard_route(torch.device("cuda", 0)) == "kernels"
    assert ploss.shard_route(torch.device("cpu")) == "plain"


@pytest.mark.parametrize("quant,max_query", [(False, False), (True, False),
                                             (False, True)])
def test_kernel_route_launches_the_wrappers_and_never_the_plain_body(
        monkeypatch, quant, max_query):
    """On the "kernels" route the shard's statistics and dQ come from #5/#6
    (#7/#8, #9/#10) and no plain shard body runs: the wrappers are replaced
    by recorders (CPU tensors stand in for CUDA ones), the plain versions
    by traps."""
    calls = []

    def trap(*a, **k):
        raise AssertionError("the plain shard body ran")

    b, m, d = 4, 6, 16
    stats = tuple(torch.ones(b) for _ in range(4))

    def fwd(name):
        def run(q, bank, labels, tau, routing=False):
            calls.append(name)
            if max_query:
                res = (torch.zeros(b, m), torch.zeros(b, m, dtype=torch.int16))
                return torch.zeros(()), stats, torch.zeros(()), res
            return torch.zeros(()), stats, torch.zeros(())
        return run

    def bwd(name):
        def run(*a):
            calls.append(name)
            return torch.zeros(b, d)
        return run

    for name in ("bank_infonce_fwd", "bank_infonce_q8_fwd"):
        monkeypatch.setattr(bk, name, fwd(name))
    for name in ("bank_infonce_bwd", "bank_infonce_q8_bwd"):
        monkeypatch.setattr(bk, name, bwd(name))
    monkeypatch.setattr(mq, "max_query_infonce_fwd", fwd("mq_fwd"))
    monkeypatch.setattr(mq, "max_query_infonce_bwd", bwd("mq_bwd"))
    for name in ("bank_infonce_stats_reference",
                 "bank_infonce_q8_stats_reference",
                 "bank_infonce_bwd_reference", "bank_infonce_q8_bwd_reference"):
        monkeypatch.setattr(bk, name, trap)
    for name in ("max_query_infonce_residuals_reference",
                 "max_query_infonce_routed_bwd_reference"):
        monkeypatch.setattr(mq, name, trap)
    q = torch.zeros(b, d)
    bank = torch.zeros((m, 2, d) if max_query else (m, d))
    if quant:
        bank = bk.quantize_bank(bank)
    labels = torch.zeros(b, dtype=torch.int32)
    got, res = ploss._local_stats(q, bank, labels, TAU, max_query, True,
                                  "kernels")
    ploss._local_dq(q, bank, labels, TAU, stats[0], stats[1],
                    torch.ones(1), max_query, res, "kernels")
    want = (["mq_fwd", "mq_bwd"] if max_query else
            ["bank_infonce_q8_fwd", "bank_infonce_q8_bwd"] if quant else
            ["bank_infonce_fwd", "bank_infonce_bwd"])
    assert calls == want
