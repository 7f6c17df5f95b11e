"""Bank-sharded InfoNCE: the stage-2 loss whose negatives span the ranks.

Counterpart of `spn4cir_tpu/parallel/loss.py`. The InfoNCE denominator
covers every train image (the paper's "scaling negatives"); when the bank
outgrows one card, its rows are split over the mesh's `bank` axis. Each
rank holds rows [offset, offset + M_loc) of `pad_bank_rows(bank, n_bank)`
and the query rows of its `data` shard, computes the per-row statistics of
its shard, and the softmax is combined across shards, the stable-softmax
merge of ring attention:

    gmax = max over bank of mx                 (all_reduce MAX)
    gse, gel, gpos = sum over bank of se·e, el·e, pos,  e = exp(mx - gmax)
    per_row = log(gse) + gmax - gpos
    loss = sum over the global batch / its count  (all_reduce SUM over data)

which is `_combine_masked_logits` (JAX `:26-46`). Labels stay global: a
shard sees `labels - offset`, and a label outside its rows adds 0 to the
positive (the contract of the bank kernels, `ops/bank_kernels.py`).

Routes, as everywhere in the port: on a CUDA tensor the shard's statistics
come from the bank kernels, #5 (#7 over an int8 bank, #9 for blip2's
max-over-query bank) launched on the shard's valid rows only, its M the
valid count, so the padding needs no mask; the backward launches #6 (#8,
#10) on the shard, fed the GLOBAL (gmax, gse) and the upstream gradient
scaled to the global count, and the full dQ is the SUM of the shard
partials over `bank`. On the CPU the plain versions play both parts (the
JAX shard body in torch: float32 products, the padding cut off, a masked
positive). A shard with no valid rows launches nothing and contributes
mx = -inf, se = 0.

Gradients are counted once: dQ is all-reduced over `bank` inside the
autograd Function, so every rank of a bank group holds the full gradient
of its query rows; the caller all-reduces parameter gradients over `data`
only (`parallel/train.py`). dtau (blip4cir's and blip2's learnable
temperature) is each data shard's share, mean((gpos - gel/gse)/tau) over
its rows divided by the global count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spn4cir_tpu_torch.ops import bank_kernels as bk
from spn4cir_tpu_torch.ops import maxquery_kernels as mq
from spn4cir_tpu_torch.ops.bank_kernels import QuantBank, Tau
from spn4cir_tpu_torch.parallel.mesh import (AXIS_BANK, AXIS_DATA, Mesh,
                                             all_reduce, pad_bank_rows)

__all__ = ["pad_bank_rows", "shard_route",
           "shard_valid_rows", "sharded_bank_infonce",
           "sharded_max_query_infonce"]


def shard_valid_rows(m_actual: int, offset: int, m_local: int) -> int:
    """Rows of the shard at `offset` that hold a real bank row."""
    return max(0, min(m_actual - offset, m_local))


def _rows(bank, n: int):
    return (QuantBank(bank.values[:n], bank.scales[:n])
            if isinstance(bank, QuantBank) else bank[:n])


class _Shard(NamedTuple):
    """What the Function needs of the bank and the mesh (not tensors)."""
    max_query: bool
    offset: int
    valid: int
    mesh: Mesh


def shard_route(device: torch.device) -> str:
    """"kernels" on a CUDA device (#5-#10, or raise), "plain" elsewhere."""
    return "kernels" if torch.device(device).type == "cuda" else "plain"


def _local_stats(query, bank, labels, tau: float, max_query: bool,
                 residuals: bool, route: str):
    """(mx, se, pos, el) of the shard's valid rows, and for max-query the
    backward's residuals, by `route` (`shard_route`)."""
    if route == "kernels":
        if max_query:
            _, stats, _, res = mq.max_query_infonce_fwd(
                query, bank, labels, tau, routing=residuals)
            return stats, res
        fwd = (bk.bank_infonce_q8_fwd if isinstance(bank, QuantBank)
               else bk.bank_infonce_fwd)
        return fwd(query, bank, labels, tau)[1], None
    if max_query:
        res = mq.max_query_infonce_residuals_reference(query, bank, tau)
        return bk._stats(res[0], labels), res
    ref = (bk.bank_infonce_q8_stats_reference if isinstance(bank, QuantBank)
           else bk.bank_infonce_stats_reference)
    return ref(query, bank, labels, tau), None


def _local_dq(query, bank, labels, tau: float, gmax, gse, gout, max_query,
              residuals, route: str):
    """The shard's partial dQ from the global (gmax, gse), by `route`."""
    cuda = route == "kernels"
    if max_query:
        bwd = (mq.max_query_infonce_bwd if cuda
               else mq.max_query_infonce_routed_bwd_reference)
        return bwd(bank, labels, tau, gmax, gse, gout, residuals)
    quant = isinstance(bank, QuantBank)
    if cuda:
        bwd = bk.bank_infonce_q8_bwd if quant else bk.bank_infonce_bwd
    else:
        bwd = (bk.bank_infonce_q8_bwd_reference if quant
               else bk.bank_infonce_bwd_reference)
    return bwd(query, bank, labels, tau, gmax, gse, gout)


class _ShardedInfoNCE(torch.autograd.Function):
    """loss over the global batch and the whole bank from this rank's
    query rows and bank shard. A QuantBank crosses as (values, scales)."""

    @staticmethod
    def forward(ctx, query, rows, scales, labels, tau, shard: _Shard):
        tau_value = float(tau)
        mesh = shard.mesh
        bank = _rows(rows if scales is None else QuantBank(rows, scales),
                     shard.valid)
        local = (labels.long() - shard.offset).to(torch.int32)
        b = query.shape[0]
        f32 = dict(device=query.device, dtype=torch.float32)
        residuals = None
        if shard.valid:
            (mx, se, pos, el), residuals = _local_stats(
                query, bank, local, tau_value, shard.max_query,
                ctx.needs_input_grad[0], shard_route(query.device))
        else:  # an all-padding shard
            mx = torch.full((b,), float("-inf"), **f32)
            se, pos, el = (torch.zeros(b, **f32) for _ in range(3))
        gmax = all_reduce(mx.clone(), mesh.group(AXIS_BANK),
                          torch.distributed.ReduceOp.MAX)
        rescale = torch.exp(mx - gmax)
        sums = all_reduce(torch.stack([se * rescale, el * rescale, pos]),
                          mesh.group(AXIS_BANK))
        gse, gel, gpos = sums
        per_row = torch.log(gse) + gmax - gpos
        total = all_reduce(torch.stack([per_row.sum(),
                                        torch.tensor(float(b), **f32)]),
                           mesh.group(AXIS_DATA))
        count = total[1]
        ctx.save_for_backward(query, rows, scales, local, gmax, gse,
                              ((gpos - gel / gse) / tau_value).sum() / count,
                              count)
        ctx.residuals = residuals
        ctx.shard = shard
        ctx.tau_value = tau_value
        ctx.tau_grad = isinstance(tau, torch.Tensor) and tau.requires_grad
        ctx.tau_like = tau if ctx.tau_grad else None
        return total[0] / count

    @staticmethod
    def backward(ctx, gout):
        query, rows, scales, local, gmax, gse, dtau_share, count = \
            ctx.saved_tensors
        shard = ctx.shard
        dq = None
        if ctx.needs_input_grad[0]:
            if shard.valid:
                bank = _rows(rows if scales is None
                             else QuantBank(rows, scales), shard.valid)
                # the kernels divide by their own B: scale to the global count
                g = (gout.float() * (query.shape[0] / count)).reshape(1)
                dq = _local_dq(query, bank, local, ctx.tau_value, gmax, gse,
                               g, shard.max_query, ctx.residuals,
                               shard_route(query.device))
            else:
                dq = torch.zeros_like(query, dtype=torch.float32)
            dq = all_reduce(dq.contiguous(), shard.mesh.group(AXIS_BANK))
        ctx.residuals = None
        dtau = None
        if ctx.tau_grad:
            dtau = (gout * dtau_share).to(ctx.tau_like.dtype).to(
                ctx.tau_like.device).reshape(ctx.tau_like.shape)
        return dq, None, None, None, dtau, None


def _sharded(query, bank_shard, labels, tau: Tau, mesh: Mesh,
             m_actual: Optional[int], max_query: bool):
    m_local = bank_shard.shape[0]
    n = mesh.size(AXIS_BANK)
    offset = mesh.index(AXIS_BANK) * m_local
    m_actual = m_local * n if m_actual is None else int(m_actual)
    if m_actual > m_local * n:
        raise ValueError(f"m_actual={m_actual} exceeds {n} shards of "
                         f"{m_local} rows")
    shard = _Shard(max_query, offset, shard_valid_rows(m_actual, offset,
                                                       m_local), mesh)
    rows, scales = ((bank_shard.values, bank_shard.scales)
                    if isinstance(bank_shard, QuantBank)
                    else (bank_shard, None))
    # the kernels take float32 rows; a narrower query is widened here, and
    # autograd casts dQ back to its dtype
    return _ShardedInfoNCE.apply(query.float().contiguous(), rows, scales,
                                 labels, tau, shard)


def sharded_bank_infonce(query: torch.Tensor, bank_shard, labels: torch.Tensor,
                         tau: Tau, mesh: Mesh,
                         m_actual: Optional[int] = None) -> torch.Tensor:
    """Full-bank InfoNCE with the bank's rows split over `bank` and the
    batch's over `data`. query (B_loc, D): this rank's rows; bank_shard
    (M_loc, D) dense or an int8 `QuantBank`: this rank's rows of the bank
    padded to a multiple of the bank size (`parallel.mesh.bank_shard`);
    labels
    (B_loc,) global image ids; `m_actual` the bank's true row count.
    Returns the loss over the global batch, the same on every rank;
    differentiable in `query` and in a tensor `tau`."""
    return _sharded(query, bank_shard, labels, tau, mesh, m_actual, False)


def sharded_max_query_infonce(feats: torch.Tensor, bank_shard,
                              labels: torch.Tensor, tau: Tau, mesh: Mesh,
                              m_actual: Optional[int] = None) -> torch.Tensor:
    """blip2's max-over-query InfoNCE with the (M, Q, D) target bank split
    over `bank` (the largest device-resident tensor of blip2's stage 2) and
    the batch over `data`; `bank_shard` is dense or a 3-D int8 QuantBank.
    The forward writes #10's residuals whenever feats needs a gradient."""
    return _sharded(feats, bank_shard, labels, tau, mesh, m_actual, True)

