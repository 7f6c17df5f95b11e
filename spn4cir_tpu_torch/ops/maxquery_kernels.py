"""Max-over-query bank InfoNCE (the BLIP-2 stage-2 loss) and its kernels.

Counterpart of `spn4cir_tpu/ops/maxquery_kernels.py`:

    sims   = einsum('bd,mqd->bmq', feats, bank)   # Q = 32 query tokens
    logits = max_q(sims) / tau                    # (B, M)
    loss   = mean CE(logits, labels)

`max_query_infonce(feats, bank, labels, tau)` never materialises the (B, M,
Q) sims on the card. The forward kernel (`max_query_infonce_fwd`, replacing
the TPU `_fwd_kernel`) forms the sims on the tensor cores over the bank as
its (M·Q, D) matrix (split TF32 over a float32 bank; over a bf16 or int8
one bf16 products of feats as three exact bf16 terms), takes the max over
each m's queries and emits per-row statistics (max, sum-exp, positive
logit, Σ exp·logit); asked for them (`routing=True`, whenever feats needs a
gradient) it also writes the residuals of the backward: the (B, M) float32
logits and the (B, M) int16 routed query q*, the FIRST query that reaches
the max. The backward
kernel (`max_query_infonce_bwd`, replacing `_bwd_kernel`) recomputes
nothing: it reads the residuals, gathers only the routed rows bank[m, q*]
and accumulates dfeats. Both take a dense (M, Q, D) float32 or bfloat16
bank, or an int8 `QuantBank` with (M, Q) scales, where the scale
multiplies each sim before the max and 1/tau follows. They live in
`csrc/max_query_infonce.cu`, are built with nvcc at first use, and count
their launches in `<wrapper>.launches`; `mq_plan` cuts the m axis into the
splits of both.

Routes:
  - tensors on a CUDA device: the kernels, through `torch.autograd.Function`;
    a CUDA input they cannot take raises;
  - tensors on the CPU: `max_query_infonce_reference`, the plain PyTorch
    version (autograd differentiates it), counting nothing.

Labels: as in `ops/bank_kernels.py`, a label outside [0, M) says that the
positive lies in another shard of the bank: its positive logit is 0 and
the backward puts no one-hot in its row (the kernels and the plain
versions alike), so a bank split over devices runs them per shard.

Gradients: dfeats and dtau are exact; the bank is a frozen feature cache and
gets none. The max's gradient goes to the first argmax query alone, in the
kernels and in the plain versions (they gather at `argmax`): `amax`'s
autograd, like XLA's max vjp in the JAX package's plain path, would split a
tie between the tied queries.

The JAX package relays the frozen bank out once to its kernel's (Q, Mp, D)
blocks (`PreparedMaxQueryBank` / `prepare_max_query_bank`). The Hopper
kernels read the (M, Q, D) bank as it is and mask its tail themselves, so
there is no prepared layout here.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from spn4cir_tpu_torch.ops import bank_kernels
from spn4cir_tpu_torch.ops.bank_kernels import QuantBank, Stats, Tau
from spn4cir_tpu_torch.ops.cuda_build import (counted, launch, load_library,
                                              sm_count)

# the kernels' layout, as csrc/max_query_infonce.cu fixes it at compile time
# (which also asserts that the widest D fits the shared memory)
CHUNK = 32              # D % CHUNK == 0: the products' 32-deep blocks
MAX_DIM = 512           # widest D (kMaxD)
TILE_ROWS = 32          # feats rows per CTA, both kernels (kRows)
TILE_COLS = 256         # rows of the (M·Q, D) bank per forward tile (kCols)
FWD_CTAS_PER_SM = 1     # the forward's shared memory holds one CTA an SM
BWD_CTAS_PER_SM = 2

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# (logits (B, M) float32, route (B, M) int16): the forward's residuals
Residuals = Tuple[torch.Tensor, torch.Tensor]


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------

def _sims(feats: torch.Tensor, bank) -> torch.Tensor:
    """(B, M, Q) float32 sims; over an int8 bank the (M, Q) scales multiply
    the products of the raw values."""
    if isinstance(bank, QuantBank):
        return torch.einsum("bd,mqd->bmq", feats.float(),
                            bank.values.float()) * bank.scales[None]
    return torch.einsum("bd,mqd->bmq", feats.float(), bank.float())


def _max_logits(feats: torch.Tensor, bank, tau: Tau
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, M), routed query (B, M)): the max over q taken as a
    gather at the first argmax, so that autograd routes to that query
    alone, then / tau."""
    sims = _sims(feats, bank)
    arg = sims.argmax(dim=-1)
    return sims.gather(-1, arg[..., None])[..., 0] / tau, arg


def max_query_infonce_stats_reference(feats: torch.Tensor, bank,
                                      labels: torch.Tensor, tau: Tau
                                      ) -> Stats:
    """The forward kernel's four per-row statistics from materialised
    float32 logits: mx, se = Σ_m exp(l - mx), pos = l[label],
    el = Σ_m exp(l - mx)·l."""
    return bank_kernels._stats(_max_logits(feats, bank, tau)[0], labels)


def max_query_infonce_reference(feats: torch.Tensor, bank,
                                labels: torch.Tensor, tau: Tau
                                ) -> torch.Tensor:
    """Plain version of the fused loss, mean(log se + mx - pos); autograd
    through it gives the dfeats and dtau the kernels compute."""
    if isinstance(bank, QuantBank):
        bank = QuantBank(bank.values, bank.scales.detach())
    else:
        bank = bank.detach()
    return bank_kernels._loss(_max_logits(feats, bank, tau)[0], labels)


def max_query_infonce_residuals_reference(feats: torch.Tensor, bank,
                                          tau: Tau) -> Residuals:
    """The forward kernel's residuals from materialised float32 sims: the
    (B, M) logits and the (B, M) int16 first argmax query."""
    logits, arg = _max_logits(feats, bank, tau)
    return logits, arg.to(torch.int16)


def max_query_infonce_routed_bwd_reference(bank, labels: torch.Tensor,
                                           tau: Tau, mx: torch.Tensor,
                                           se: torch.Tensor,
                                           gout: torch.Tensor,
                                           residuals: Residuals
                                           ) -> torch.Tensor:
    """Plain version of the backward kernel from the forward's residuals:
    w = (P - onehot)·g with P = exp(logits - mx)/se and g = gout/(B·tau),
    put at each (b, m)'s routed query (times its scale over an int8 bank),
    then one product with the bank's (M·Q, D) rows. feats is not needed."""
    logits, route = residuals
    coef = bank_kernels._coefficient(logits.float(), labels, tau, mx, se,
                                     gout)
    b, m = coef.shape
    rows = bank.values if isinstance(bank, QuantBank) else bank
    nq, d = rows.shape[1], rows.shape[2]
    w = torch.zeros(b, m, nq, dtype=torch.float32, device=coef.device)
    w.scatter_(-1, route.long()[..., None], coef[..., None])
    if isinstance(bank, QuantBank):
        w = w * bank.scales[None]
    return w.reshape(b, m * nq) @ rows.reshape(m * nq, d).float()


def max_query_infonce_bwd_reference(feats: torch.Tensor, bank,
                                    labels: torch.Tensor, tau: Tau,
                                    mx: torch.Tensor, se: torch.Tensor,
                                    gout: torch.Tensor) -> torch.Tensor:
    """The backward from (feats, bank): the sims recomputed, routed at each
    (b, m)'s first argmax query, then the routed product (the oracle of
    the residual route)."""
    return max_query_infonce_routed_bwd_reference(
        bank, labels, tau, mx, se, gout,
        max_query_infonce_residuals_reference(feats, bank, tau))


# --------------------------------------------------------------------------
# The kernels
# --------------------------------------------------------------------------

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# forward: feats, values, scales, labels; tau; B, M, Q, D, dtype code,
# m_per_split, n_splits; part, mx, se, pos, el, out2, logits, route; stream.
# backward: values, scales, labels, mx, se, gout, logits, route; tau; B, M,
# Q, D, dtype code, m_per_split, splits; dq_part, dq; stream
ENTRY_POINTS = {
    "max_query_infonce_fwd": [_PTR] * 4 + [_F32] + [_I32] * 7 + [_PTR] * 9,
    "max_query_infonce_bwd": [_PTR] * 8 + [_F32] + [_I32] * 7 + [_PTR] * 3,
}


class MqPlan(NamedTuple):
    """How the kernels cut the m axis (a pure function of the shapes and
    the SM count, so the order of every sum is fixed for a given device).
    Forward: tiles of `m_per_tile` whole m's (TILE_COLS // Q; past Q =
    TILE_COLS one m, its rows over `tiles_per_m` tiles), `n_splits` splits
    of `m_per_split` m's, a multiple of `m_per_tile`, about
    FWD_CTAS_PER_SM CTAs an SM with the row tiles. Backward: `bwd_splits`
    splits of `bwd_m_per_split` m's, about BWD_CTAS_PER_SM an SM."""
    m_per_tile: int
    tiles_per_m: int
    m_per_split: int
    n_splits: int
    bwd_m_per_split: int
    bwd_splits: int


def mq_plan(b: int, m: int, q: int, sm_count: int) -> MqPlan:
    mt = TILE_COLS // q if q <= TILE_COLS else 1
    qt = 1 if q <= TILE_COLS else -(-q // TILE_COLS)
    row_tiles = -(-b // TILE_ROWS)
    groups = -(-m // mt)
    want = max(1, sm_count * FWD_CTAS_PER_SM // row_tiles)
    per = -(-groups // want)
    bwd_per = -(-m // max(1, sm_count * BWD_CTAS_PER_SM // row_tiles))
    return MqPlan(mt, qt, per * mt, -(-groups // per), bwd_per,
                  -(-m // bwd_per))


def _check_bank(bank, device: torch.device) -> None:
    """The bank's types, shape and layout, on `device`, which is CUDA."""
    quant = isinstance(bank, QuantBank)
    rows = bank.values if quant else bank
    if rows.dim() != 3:
        raise ValueError(f"the bank must be (M, Q, D); got "
                         f"{tuple(rows.shape)}")
    if quant:
        if rows.dtype != torch.int8 or bank.scales.dtype != torch.float32:
            raise ValueError(f"a QuantBank holds int8 values and float32 "
                             f"scales; got {rows.dtype}, {bank.scales.dtype}")
        if bank.scales.shape != rows.shape[:2]:
            raise ValueError(f"scales must be (M, Q) = {tuple(rows.shape[:2])}"
                             f"; got {tuple(bank.scales.shape)}")
        if (bank.scales.device != rows.device
                or not bank.scales.is_contiguous()):
            raise ValueError("scales must be contiguous, on the values' device")
    elif rows.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the bank must be float32 or bfloat16; got "
                         f"{rows.dtype}")
    if rows.device != device:
        raise ValueError("feats, bank and labels must lie on one device")
    if device.type != "cuda":
        raise ValueError(f"the max-query InfoNCE kernels launch on CUDA; the "
                         f"tensors lie on {device}")
    d = rows.shape[2]
    if d % CHUNK or d > MAX_DIM:
        raise ValueError(f"the kernels take D % {CHUNK} == 0 and D <= "
                         f"{MAX_DIM}; got D={d}")
    if rows.shape[1] > 32767:
        raise ValueError(f"the kernels take Q <= 32767; got {rows.shape[1]}")
    if not rows.is_contiguous():
        raise ValueError("the bank must be contiguous")
    if rows.data_ptr() % 16:
        raise ValueError("the bank must be 16-byte aligned")


def _check(feats: torch.Tensor, bank, labels: torch.Tensor) -> None:
    """Types, shapes and layout. A label outside [0, M) is allowed: the
    positive lies in another shard (pos 0, no one-hot)."""
    rows = bank.values if isinstance(bank, QuantBank) else bank
    if feats.dim() != 2 or rows.dim() != 3 or feats.shape[1] != rows.shape[2]:
        raise ValueError(f"feats (B, D) and bank (M, Q, D) must share D; got "
                         f"{tuple(feats.shape)}, {tuple(rows.shape)}")
    if labels.shape != (feats.shape[0],):
        raise ValueError(f"labels must be (B,) = ({feats.shape[0]},); got "
                         f"{tuple(labels.shape)}")
    if feats.dtype != torch.float32:
        raise ValueError(f"the kernels take float32 feats; got {feats.dtype}")
    if labels.device != feats.device:
        raise ValueError("feats, bank and labels must lie on one device")
    _check_bank(bank, feats.device)
    if not feats.is_contiguous():
        raise ValueError("feats and bank must be contiguous")
    if feats.data_ptr() % 16:
        raise ValueError("feats and bank must be 16-byte aligned")


def _bank_args(bank):
    """(values pointer, scales pointer or None, dtype code, M, Q)."""
    if isinstance(bank, QuantBank):
        return (bank.values.data_ptr(), bank.scales.data_ptr(), 2,
                *bank.values.shape[:2])
    return (bank.data_ptr(), None, _DTYPE_CODES[bank.dtype], *bank.shape[:2])


def max_query_infonce_fwd(feats: torch.Tensor, bank, labels: torch.Tensor,
                          tau: float, routing: bool = False
                          ) -> Tuple[torch.Tensor, Stats, torch.Tensor,
                                     Optional[Residuals]]:
    """Launch the forward kernel on CUDA tensors (a dense (M, Q, D) bank or
    an int8 QuantBank). Returns (loss, (mx, se, pos, el), dtau_unit,
    residuals): a float32 scalar, four (B,) float32 vectors, the scalar
    d loss / d tau, and with `routing` the backward's residuals (logits,
    route), (B, M) views of the kernel's (M, B) float32 and int16 buffers
    (else None, and the kernel writes none)."""
    _check(feats, bank, labels)
    lib = load_library("max_query_infonce", ENTRY_POINTS)
    b, d = feats.shape
    values, scales, code, m, nq = _bank_args(bank)
    dev, index = feats.device, feats.get_device()
    plan = mq_plan(b, m, nq, sm_count(index))
    labels32 = labels.to(torch.int32).contiguous()
    part = torch.empty(plan.n_splits, b, 4, device=dev, dtype=torch.float32)
    stats = torch.empty(4, b, device=dev, dtype=torch.float32)
    out2 = torch.empty(2, device=dev, dtype=torch.float32)
    logits_t = route_t = None
    if routing:
        logits_t = torch.empty(m, b, device=dev, dtype=torch.float32)
        route_t = torch.empty(m, b, device=dev, dtype=torch.int16)
    launch(max_query_infonce_fwd, lib.max_query_infonce_fwd, index,
           feats.data_ptr(), values, scales, labels32.data_ptr(), float(tau),
           b, m, nq, d, code, plan.m_per_split, plan.n_splits,
           part.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
           stats[2].data_ptr(), stats[3].data_ptr(), out2.data_ptr(),
           None if logits_t is None else logits_t.data_ptr(),
           None if route_t is None else route_t.data_ptr())
    residuals = None if logits_t is None else (logits_t.t(), route_t.t())
    return (out2[0], (stats[0], stats[1], stats[2], stats[3]), out2[1],
            residuals)


def max_query_infonce_bwd(bank, labels: torch.Tensor, tau: float,
                          mx: torch.Tensor, se: torch.Tensor,
                          gout: torch.Tensor,
                          residuals: Residuals) -> torch.Tensor:
    """Launch the backward kernel on CUDA tensors: dfeats (B, D) float32
    from the forward's statistics (mx, se), its residuals (logits, route)
    (B, M) and the upstream scalar gradient `gout`. No sim is recomputed:
    feats is not an argument."""
    logits, route = residuals
    b, m = logits.shape
    rows = bank.values if isinstance(bank, QuantBank) else bank
    if rows.dim() != 3 or rows.shape[0] != m or route.shape != (b, m):
        raise ValueError(f"the residuals must be (B, M) with M the bank's; "
                         f"got {tuple(logits.shape)}, {tuple(route.shape)}, "
                         f"bank {tuple(rows.shape)}")
    if logits.dtype != torch.float32 or route.dtype != torch.int16:
        raise ValueError(f"the residuals are float32 logits and int16 "
                         f"routes; got {logits.dtype}, {route.dtype}")
    if labels.shape != (b,):
        raise ValueError(f"labels must be (B,) = ({b},); got "
                         f"{tuple(labels.shape)}")
    if not (labels.device == logits.device == route.device):
        raise ValueError("feats, bank and labels must lie on one device")
    _check_bank(bank, logits.device)
    lib = load_library("max_query_infonce", ENTRY_POINTS)
    values, scales, code, _, nq = _bank_args(bank)
    d = rows.shape[2]
    dev, index = logits.device, logits.get_device()
    plan = mq_plan(b, m, nq, sm_count(index))
    labels32 = labels.to(torch.int32).contiguous()
    # the kernel reads them (M, B): the forward's own are views of such
    logits_t = logits.t().contiguous()
    route_t = route.t().contiguous()
    mx = mx.float().contiguous()
    se = se.float().contiguous()
    gout = gout.float().reshape(1).contiguous()
    dq_part = torch.empty(plan.bwd_splits, b, d, device=dev,
                          dtype=torch.float32)
    dq = torch.empty(b, d, device=dev, dtype=torch.float32)
    launch(max_query_infonce_bwd, lib.max_query_infonce_bwd, index, values,
           scales, labels32.data_ptr(), mx.data_ptr(), se.data_ptr(),
           gout.data_ptr(), logits_t.data_ptr(), route_t.data_ptr(),
           float(tau), b, m, nq, d, code, plan.bwd_m_per_split,
           plan.bwd_splits, dq_part.data_ptr(), dq.data_ptr())
    return dq


counted(max_query_infonce_fwd, max_query_infonce_bwd)


class _MaxQueryInfoNCE(torch.autograd.Function):
    """loss = max_query_infonce(feats, bank, labels, tau) through the forward
    and the backward kernel. A QuantBank crosses as (values, scales) and a
    dense bank as (rows, None). `tau` is a float, or a 0-d tensor when its
    gradient is wanted (its value is read on the host once per call). The
    forward writes the backward's residuals only when feats needs a
    gradient."""

    @staticmethod
    def forward(ctx, feats, rows, scales, labels, tau):
        tau_value = float(tau)
        bank = rows if scales is None else QuantBank(rows, scales)
        routing = ctx.needs_input_grad[0]
        loss, (mx, se, _, _), dtau_unit, residuals = max_query_infonce_fwd(
            feats, bank, labels, tau_value, routing=routing)
        logits, route = residuals if routing else (None, None)
        ctx.save_for_backward(rows, scales, labels, mx, se, dtau_unit, logits,
                              route)
        ctx.tau_value = tau_value
        ctx.tau_grad = isinstance(tau, torch.Tensor) and tau.requires_grad
        ctx.tau_like = tau if ctx.tau_grad else None
        return loss

    @staticmethod
    def backward(ctx, gout):
        rows, scales, labels, mx, se, dtau_unit, logits, route = \
            ctx.saved_tensors
        dfeats = None
        if ctx.needs_input_grad[0]:
            bank = rows if scales is None else QuantBank(rows, scales)
            dfeats = max_query_infonce_bwd(bank, labels, ctx.tau_value, mx,
                                           se, gout.contiguous(),
                                           (logits, route))
        dtau = None
        if ctx.tau_grad:
            dtau = (gout * dtau_unit).to(ctx.tau_like.dtype).to(
                ctx.tau_like.device).reshape(ctx.tau_like.shape)
        return dfeats, None, None, None, dtau


def max_query_infonce(feats: torch.Tensor, bank, labels: torch.Tensor,
                      tau: Tau) -> torch.Tensor:
    """Max-over-query bank InfoNCE over a dense (M, Q, D) bank or a 3-D int8
    `QuantBank`; see the module docstring for the routes."""
    if feats.device.type == "cpu":
        return max_query_infonce_reference(feats, bank, labels, tau)
    rows, scales = ((bank.values, bank.scales) if isinstance(bank, QuantBank)
                    else (bank, None))
    # the kernels take float32 rows; a narrower feats is widened here, and
    # autograd casts dfeats back to its dtype
    return _MaxQueryInfoNCE.apply(feats.float().contiguous(), rows, scales,
                                  labels, tau)
