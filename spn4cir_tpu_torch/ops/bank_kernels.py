"""Full-bank InfoNCE (the stage-2 "scaling negatives" loss) and int8 banks.

Counterpart of `spn4cir_tpu/ops/bank_kernels.py`:

    logits = (Q @ bankᵀ) / tau          # (B, M), M = all train images
    loss   = mean_i [ logsumexp_j logits[i, j] - logits[i, labels[i]] ]

`bank_infonce(query, bank, labels, tau)` never materialises the (B, M)
logits on the card: the forward kernel (`bank_infonce_fwd`, replacing the
TPU `_fwd_kernel`) sweeps the bank and emits per-row statistics (max,
sum-exp, positive logit, Σ exp·logit), and the backward kernel
(`bank_infonce_bwd`, replacing `_bwd_kernel`) recomputes the softmax from
the saved statistics and accumulates dQ. Over an int8 `QuantBank` the same
pair exists as `bank_infonce_q8_fwd` / `bank_infonce_q8_bwd` (replacing the
TPU `_q8_fwd_kernel` / `_q8_bwd_kernel`): the product runs on the raw int8
values widened to float32, the row's scale multiplies the logits column
afterwards and 1/tau follows, `logits = ((Q @ i8ᵀ) * s) / tau`, and dQ is
`((P - onehot) * g * s) @ i8`. All four live in `csrc/bank_infonce.cu`, are
built with nvcc at first use, and count their launches in
`<wrapper>.launches`.

Routes:
  - a dense float32 / bfloat16 bank or a `QuantBank` on a CUDA device: the
    kernels, through `torch.autograd.Function`; a CUDA input they cannot
    take raises;
  - tensors on the CPU: `bank_infonce_reference` /
    `bank_infonce_q8_reference`, the plain PyTorch versions (autograd
    differentiates them), counting nothing.

Labels: a label in [0, M) names the positive's bank row. A label outside
[0, M) says that the positive lies in another shard of a bank split over
devices (`parallel/loss.py`): that row's positive logit is 0 and its
backward has no one-hot, in the kernels and in the plain versions alike;
the statistics stay valid and the caller combines them across shards.

Gradients: dquery and dtau are exact; the bank is a frozen feature cache in
stage 2 and gets none. The bfloat16 bank is widened to float32 before the
product in the kernels and in the plain version alike. Every product of
the kernels from D = 256 on runs on the tensor cores in split TF32 (each
float32 operand as a sum of two TF32 values, three products; two over a
bfloat16 bank or int8 values, which TF32 holds exactly), one design for
all three bank types; below D = 256 the logits run as float32 FMAs on the
CUDA cores. The forward (`fwd_plan`) folds its split's logits tiles into
running statistics; its bound is the TF32 peak at 3 x 2·B·M·D operations
over a float32 bank, 2 x over the others. The backward (`bwd_plan`) forms
the coefficient (P - onehot)·g (·s over an int8 bank) over the full depth
into a (B, M) float32 scratch, then dQ = coefficient · bank split over the
bank axis and summed in index order; its bound is 3 x 4·B·M·D, 2 x over
the others. The forward and the coefficient share one logits mainloop, so
both form bit-identical logits.

The JAX package pads the frozen bank once to its kernel's block multiple
(`PreparedBank` / `prepare_bank`) and caches that relayout beside the bank.
The Hopper kernels mask the tail of M and of B themselves, so there is no
prepared layout here and nothing to cache.

`QuantBank` / `quantize_bank` (per-row absmax int8) serve `--bank_dtype
int8` in training and `--gallery_dtype int8` in the retrieval service.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple, Union

import torch

from spn4cir_tpu_torch.ops.cuda_build import (counted, launch, load_library,
                                              sm_count)

TILE_ROWS = 64     # query rows per CTA   (kTileR in csrc/bank_infonce.cu)
TILE_COLS = 128    # bank rows per tile   (kTileC)
DQ_COLS = 128      # dQ columns per CTA of the backward's dQ kernel (kTcCols)
DQ_CTAS_PER_SM = 2  # CTAs of that kernel an SM holds (__launch_bounds__)
FWD_CTAS_PER_SM = 2  # CTAs of either forward kernel an SM holds
# the forward and the backward form the logits on the tensor cores from this
# depth on and on the CUDA cores below it (see `fwd_plan`, `bwd_plan`)
TC_LOGITS_MIN_D = 256

_BANK_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

Tau = Union[float, torch.Tensor]
Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class QuantBank(NamedTuple):
    """Per-row absmax-quantized feature bank: values int8 (M, D), scales
    float32 (M,)."""

    values: torch.Tensor
    scales: torch.Tensor

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def shape(self):
        return self.values.shape


    def dequantize(self) -> torch.Tensor:
        return self.values.float() * self.scales[..., None]


def quantize_bank(bank: torch.Tensor) -> QuantBank:
    """Per-feature-row absmax int8 quantization (the last axis is the
    feature axis; every leading axis keeps its own scale)."""
    bank = bank.float()
    scales = bank.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    vals = torch.round(bank / scales[..., None]).clamp(-127, 127)
    return QuantBank(vals.to(torch.int8), scales)


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------

def _logits(query: torch.Tensor, bank: torch.Tensor, tau: Tau) -> torch.Tensor:
    return query.float() @ bank.float().T / tau


def _q8_logits(query: torch.Tensor, qbank: QuantBank, tau: Tau) -> torch.Tensor:
    """The scale multiplies the product's column, then 1/tau: the order of
    roundings of the kernel (the bank rows are never dequantized)."""
    return (query.float() @ qbank.values.float().T) * qbank.scales[None, :] / tau


def _in_shard(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the label names a column of `logits`. A label outside
    [0, M) says that the positive lies in another shard of the bank."""
    labels = labels.long()
    return (labels >= 0) & (labels < logits.shape[-1])


def _positive(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[i, labels[i]], 0 where the label is outside [0, M): a masked
    gather, as the kernels compute it."""
    inside = _in_shard(logits, labels)
    safe = torch.where(inside, labels.long(), 0)
    pos = logits.gather(-1, safe[:, None])[:, 0]
    return torch.where(inside, pos, torch.zeros_like(pos))


def _stats(logits: torch.Tensor, labels: torch.Tensor) -> Stats:
    mx = logits.amax(dim=-1)
    e = torch.exp(logits - mx[:, None])
    return mx, e.sum(dim=-1), _positive(logits, labels), (e * logits).sum(dim=-1)


def _loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    mx = logits.detach().amax(dim=-1)
    se = torch.exp(logits - mx[:, None]).sum(dim=-1)
    return (torch.log(se) + mx - _positive(logits, labels)).mean()


def _coefficient(logits: torch.Tensor, labels: torch.Tensor, tau: Tau,
                 mx: torch.Tensor, se: torch.Tensor, gout: torch.Tensor
                 ) -> torch.Tensor:
    """(P - onehot)·g with P = exp(logits - mx) / se, g = gout/(B·tau); a
    row whose label lies outside [0, M) has no one-hot."""
    p = torch.exp(logits - mx[:, None]) / se[:, None]
    inside = _in_shard(logits, labels)
    rows = torch.arange(p.shape[0], device=p.device)[inside]
    p[rows, labels.long()[inside]] -= 1.0
    return p * (gout.float() / (logits.shape[0] * tau))


def bank_infonce_stats_reference(query: torch.Tensor, bank: torch.Tensor,
                                 labels: torch.Tensor, tau: Tau) -> Stats:
    """The forward kernel's four per-row statistics, from materialised
    float32 logits: mx = max_j l, se = Σ_j exp(l - mx), pos = l[label],
    el = Σ_j exp(l - mx)·l."""
    return _stats(_logits(query, bank, tau), labels)


def bank_infonce_reference(query: torch.Tensor, bank: torch.Tensor,
                           labels: torch.Tensor, tau: Tau) -> torch.Tensor:
    """Plain version of the fused loss: mean(log se + mx - pos). The max is
    a constant shift of the logsumexp, so it is detached; autograd through
    this gives the dQ and dtau the kernels compute."""
    return _loss(_logits(query, bank.detach(), tau), labels)


def bank_infonce_bwd_reference(query: torch.Tensor, bank: torch.Tensor,
                               labels: torch.Tensor, tau: Tau,
                               mx: torch.Tensor, se: torch.Tensor,
                               gout: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward kernel: dQ = ((P - onehot)·g) @ bank,
    P = exp(logits - mx) / se from the saved statistics, g = gout/(B·tau)."""
    coef = _coefficient(_logits(query, bank, tau), labels, tau, mx, se, gout)
    return coef @ bank.float()


def bank_infonce_q8_stats_reference(query: torch.Tensor, qbank: QuantBank,
                                    labels: torch.Tensor, tau: Tau) -> Stats:
    """`bank_infonce_stats_reference` over an int8 bank (scales after the
    product)."""
    return _stats(_q8_logits(query, qbank, tau), labels)


def bank_infonce_q8_reference(query: torch.Tensor, qbank: QuantBank,
                              labels: torch.Tensor, tau: Tau) -> torch.Tensor:
    """Plain version of the fused loss over an int8 bank."""
    return _loss(_q8_logits(query, qbank, tau), labels)


def bank_infonce_q8_bwd_reference(query: torch.Tensor, qbank: QuantBank,
                                  labels: torch.Tensor, tau: Tau,
                                  mx: torch.Tensor, se: torch.Tensor,
                                  gout: torch.Tensor) -> torch.Tensor:
    """Plain version of the int8 backward kernel:
    dQ = ((P - onehot)·g·s) @ i8, the second product on the raw values."""
    coef = _coefficient(_q8_logits(query, qbank, tau), labels, tau, mx, se,
                        gout)
    return (coef * qbank.scales[None, :]) @ qbank.values.float()


def dtau_from_stats(stats: Stats, tau: Tau) -> torch.Tensor:
    """d loss / d tau = mean((pos - el/se) / tau)."""
    _, se, pos, el = stats
    return ((pos - el / se) / tau).mean()


# --------------------------------------------------------------------------
# The kernels
# --------------------------------------------------------------------------

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# query, bank | values, scales, labels (bwd: mx, se, gout); tau; B, M, D
# (dense: the dtype code), tiles_per_split, n_splits, tc_logits; the scratch
# and the outputs; stream
ENTRY_POINTS = {
    "bank_infonce_fwd": [_PTR] * 3 + [_F32] + [_I32] * 7 + [_PTR] * 7,
    "bank_infonce_bwd": [_PTR] * 6 + [_F32] + [_I32] * 7 + [_PTR] * 4,
    "bank_infonce_q8_fwd": [_PTR] * 4 + [_F32] + [_I32] * 6 + [_PTR] * 7,
    "bank_infonce_q8_bwd": [_PTR] * 7 + [_F32] + [_I32] * 6 + [_PTR] * 4,
}


def split_plan(m: int, b: int, sm_count: int, ctas_per_sm: int,
               d_slices: int = 1) -> Tuple[int, int]:
    """(tiles_per_split, n_splits): cut the bank's ceil(M/128) tiles into
    contiguous splits so that splits x row tiles x `d_slices` is about
    sm_count * ctas_per_sm CTAs. A pure function of its arguments, so the
    order of every sum is fixed for a given device."""
    tiles = -(-m // TILE_COLS)
    row_tiles = -(-b // TILE_ROWS) * d_slices
    want = max(1, (sm_count * ctas_per_sm) // row_tiles)
    tiles_per_split = -(-tiles // want)
    return tiles_per_split, -(-tiles // tiles_per_split)


class FwdPlan(NamedTuple):
    """The forward's grid, any bank type: the bank splits
    (`tiles_per_split` tiles of 128 rows each, `n_splits` of them; the
    statistics scratch is (n_splits, B) float4) and whether the logits run
    on the tensor cores (`tc_logits`)."""

    tiles_per_split: int
    n_splits: int
    tc_logits: bool


def fwd_plan(b: int, m: int, d: int, sm_count: int) -> FwdPlan:
    """Plan of the forward over a dense or an int8 bank (the bank's type
    changes nothing). One CTA per (64 query rows, bank split); the splits
    are cut so that the card holds `FWD_CTAS_PER_SM` CTAs an SM, which both
    routes' kernels do (256 threads at 128 registers; the tensor-core
    kernel's ring and statistics take 101 KB of shared memory over a
    float32 bank). The logits run on the tensor cores by the backward's
    rule (`bwd_plan`: D >= `TC_LOGITS_MIN_D`), so the forward and the
    backward always form them by the same route. A pure function of its
    arguments, so the order of every sum is fixed for a given device."""
    tps, n_splits = split_plan(m, b, sm_count, FWD_CTAS_PER_SM)
    return FwdPlan(tps, n_splits, d >= TC_LOGITS_MIN_D)


class BwdPlan(NamedTuple):
    """The backward's grid and scratch, any bank type: the dQ product's
    bank splits (`tiles_per_split` tiles of 128 rows each, `n_splits` of
    them), whether the logits run on the tensor cores (`tc_logits`), the
    coefficient scratch (B, ceil(M/128)*128) and the per-split partial dQ
    (n_splits, B, D), both float32."""

    tiles_per_split: int
    n_splits: int
    tc_logits: bool
    coef_shape: Tuple[int, int]
    dq_part_shape: Tuple[int, int, int]


def bwd_plan(b: int, m: int, d: int, sm_count: int) -> BwdPlan:
    """Plan of the backward over a dense or an int8 bank (the bank's type
    changes neither grid nor scratch). The coefficient kernel takes one CTA
    per (64 query rows, 128 bank rows) tile and forms the logits in split
    TF32 on the tensor cores when D >= `TC_LOGITS_MIN_D` (every model's
    embedding: 256..1024), else in float32 FMAs on the CUDA cores: a
    shallow bank of unit rows has logits up to 1/tau, and there a product
    summed in another order than the plain version's misses dQ's
    tolerance (an exactly rounded product does too). The dQ kernel (split
    TF32 at every D) has only ceil(B/64) x ceil(D/128) output tiles (20 at
    B=256, D=640), so it splits the bank axis until the card holds
    `DQ_CTAS_PER_SM` CTAs an SM, and the splits are summed in index order.
    A pure function of its arguments, so the order of every sum is fixed
    for a given device."""
    tps, n_splits = split_plan(m, b, sm_count, DQ_CTAS_PER_SM,
                               -(-d // DQ_COLS))
    return BwdPlan(tps, n_splits, d >= TC_LOGITS_MIN_D,
                   (b, -(-m // TILE_COLS) * TILE_COLS), (n_splits, b, d))


def _check(query: torch.Tensor, bank, labels: torch.Tensor) -> None:
    quant = isinstance(bank, QuantBank)
    rows = bank.values if quant else bank
    if query.dim() != 2 or rows.dim() != 2 or query.shape[1] != rows.shape[1]:
        raise ValueError(f"query (B, D) and bank (M, D) must share D; got "
                         f"{tuple(query.shape)}, {tuple(rows.shape)}")
    # a label outside [0, M) is allowed: the positive lies in another
    # shard (pos 0, no one-hot; see the module docstring)
    if labels.shape != (query.shape[0],):
        raise ValueError(f"labels must be (B,) = ({query.shape[0]},); got "
                         f"{tuple(labels.shape)}")
    if query.dtype != torch.float32:
        raise ValueError(f"the kernels take a float32 query; got {query.dtype}")
    if quant:
        if rows.dtype != torch.int8 or bank.scales.dtype != torch.float32:
            raise ValueError(f"a QuantBank holds int8 values and float32 "
                             f"scales; got {rows.dtype}, {bank.scales.dtype}")
        if bank.scales.shape != (rows.shape[0],):
            raise ValueError(f"scales must be (M,) = ({rows.shape[0]},); got "
                             f"{tuple(bank.scales.shape)}")
        if (bank.scales.device != rows.device
                or not bank.scales.is_contiguous()):
            raise ValueError("scales must be contiguous, on the values' device")
    elif rows.dtype not in _BANK_DTYPE_CODES:
        raise ValueError(f"the bank must be float32 or bfloat16; got "
                         f"{rows.dtype}")
    if not (query.device == rows.device == labels.device):
        raise ValueError("query, bank and labels must lie on one device")
    if query.shape[1] % 16:
        raise ValueError(f"the kernels take D % 16 == 0; got D={query.shape[1]}")
    if not (query.is_contiguous() and rows.is_contiguous()):
        raise ValueError("query and bank must be contiguous")
    if query.data_ptr() % 16 or rows.data_ptr() % 16:
        raise ValueError("query and bank must be 16-byte aligned")


def _bank_args(lib, bank, name: str):
    """(public wrapper that counts the launch, C entry point, leading bank
    pointers, trailing dtype code) of the dense or the int8 kernel `name`
    ("fwd" / "bwd"): the one place that tells the two bank types apart."""
    if isinstance(bank, QuantBank):
        entry = f"bank_infonce_q8_{name}"
        return (globals()[entry], getattr(lib, entry),
                (bank.values.data_ptr(), bank.scales.data_ptr()), ())
    entry = f"bank_infonce_{name}"
    return (globals()[entry], getattr(lib, entry), (bank.data_ptr(),),
            (_BANK_DTYPE_CODES[bank.dtype],))


def _launch_fwd(query: torch.Tensor, bank, labels: torch.Tensor, tau: float
                ) -> Tuple[torch.Tensor, Stats, torch.Tensor]:
    _check(query, bank, labels)
    if query.device.type != "cuda":
        raise ValueError(f"the bank InfoNCE forward launches a CUDA kernel; "
                         f"the tensors lie on {query.device}")
    lib = load_library("bank_infonce", ENTRY_POINTS)
    b, d = query.shape
    m = bank.shape[0]
    dev, index = query.device, query.get_device()
    plan = fwd_plan(b, m, d, sm_count(index))
    labels32 = labels.to(torch.int32).contiguous()
    part = torch.empty(plan.n_splits, b, 4, device=dev, dtype=torch.float32)
    stats = torch.empty(4, b, device=dev, dtype=torch.float32)
    out2 = torch.empty(2, device=dev, dtype=torch.float32)
    wrapper, fn, bank_ptrs, code = _bank_args(lib, bank, "fwd")
    launch(wrapper, fn, index, query.data_ptr(), *bank_ptrs,
           labels32.data_ptr(), float(tau), b, m, d, *code,
           plan.tiles_per_split, plan.n_splits, int(plan.tc_logits),
           part.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
           stats[2].data_ptr(), stats[3].data_ptr(), out2.data_ptr())
    return out2[0], (stats[0], stats[1], stats[2], stats[3]), out2[1]


def _launch_bwd(query: torch.Tensor, bank, labels: torch.Tensor, tau: float,
                mx: torch.Tensor, se: torch.Tensor, gout: torch.Tensor
                ) -> torch.Tensor:
    _check(query, bank, labels)
    if query.device.type != "cuda":
        raise ValueError(f"the bank InfoNCE backward launches a CUDA kernel; "
                         f"the tensors lie on {query.device}")
    lib = load_library("bank_infonce", ENTRY_POINTS)
    b, d = query.shape
    m = bank.shape[0]
    dev, index = query.device, query.get_device()
    f32 = dict(device=dev, dtype=torch.float32)
    plan = bwd_plan(b, m, d, sm_count(index))
    coef = torch.empty(plan.coef_shape, **f32)
    dq_part = torch.empty(plan.dq_part_shape, **f32)
    labels32 = labels.to(torch.int32).contiguous()
    mx = mx.float().contiguous()
    se = se.float().contiguous()
    gout = gout.float().reshape(1).contiguous()
    dq = torch.empty(b, d, **f32)
    wrapper, fn, bank_ptrs, code = _bank_args(lib, bank, "bwd")
    launch(wrapper, fn, index, query.data_ptr(), *bank_ptrs,
           labels32.data_ptr(), mx.data_ptr(), se.data_ptr(), gout.data_ptr(),
           float(tau), b, m, d, *code, plan.tiles_per_split, plan.n_splits,
           int(plan.tc_logits), coef.data_ptr(), dq_part.data_ptr(),
           dq.data_ptr())
    return dq


def _want(bank, quant: bool, name: str) -> None:
    if isinstance(bank, QuantBank) != quant:
        raise ValueError(f"{name} takes " + (
            "a QuantBank (int8 values, float32 scales)" if quant
            else "a dense float32 or bfloat16 bank tensor"))


def bank_infonce_fwd(query: torch.Tensor, bank: torch.Tensor,
                     labels: torch.Tensor, tau: float
                     ) -> Tuple[torch.Tensor, Stats, torch.Tensor]:
    """Launch the forward kernel on CUDA tensors. Returns (loss, (mx, se,
    pos, el), dtau_unit): a float32 scalar, four (B,) float32 vectors and
    the scalar d loss / d tau."""
    _want(bank, False, "bank_infonce_fwd")
    return _launch_fwd(query, bank, labels, tau)


def bank_infonce_bwd(query: torch.Tensor, bank: torch.Tensor,
                     labels: torch.Tensor, tau: float, mx: torch.Tensor,
                     se: torch.Tensor, gout: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel on CUDA tensors: dQ (B, D) float32 from
    the saved (mx, se) and the upstream scalar gradient `gout`."""
    _want(bank, False, "bank_infonce_bwd")
    return _launch_bwd(query, bank, labels, tau, mx, se, gout)


def bank_infonce_q8_fwd(query: torch.Tensor, qbank: QuantBank,
                        labels: torch.Tensor, tau: float
                        ) -> Tuple[torch.Tensor, Stats, torch.Tensor]:
    """`bank_infonce_fwd` over an int8 `QuantBank`: launches the int8
    forward kernel on CUDA tensors."""
    _want(qbank, True, "bank_infonce_q8_fwd")
    return _launch_fwd(query, qbank, labels, tau)


def bank_infonce_q8_bwd(query: torch.Tensor, qbank: QuantBank,
                        labels: torch.Tensor, tau: float, mx: torch.Tensor,
                        se: torch.Tensor, gout: torch.Tensor) -> torch.Tensor:
    """`bank_infonce_bwd` over an int8 `QuantBank`: launches the int8
    backward kernel on CUDA tensors."""
    _want(qbank, True, "bank_infonce_q8_bwd")
    return _launch_bwd(query, qbank, labels, tau, mx, se, gout)


counted(bank_infonce_fwd, bank_infonce_bwd, bank_infonce_q8_fwd,
        bank_infonce_q8_bwd)


class _BankInfoNCE(torch.autograd.Function):
    """loss = bank_infonce(query, bank, labels, tau) through a forward and a
    backward kernel. autograd saves tensors only, so a QuantBank crosses as
    (rows, scales) and a dense bank as (rows, None); the launchers pick the
    kernel pair, and the counter of its public wrapper, from the bank's
    type. `tau` is a float, or a 0-d tensor when its gradient is wanted (its
    value is read on the host once per call)."""

    @staticmethod
    def forward(ctx, query, rows, scales, labels, tau):
        tau_value = float(tau)
        bank = rows if scales is None else QuantBank(rows, scales)
        loss, (mx, se, _, _), dtau_unit = _launch_fwd(query, bank, labels,
                                                      tau_value)
        ctx.save_for_backward(query, rows, scales, labels, mx, se, dtau_unit)
        ctx.tau_value = tau_value
        ctx.tau_grad = isinstance(tau, torch.Tensor) and tau.requires_grad
        ctx.tau_like = tau if ctx.tau_grad else None
        return loss

    @staticmethod
    def backward(ctx, gout):
        # autograd's thread, whose current device is the tensors': the
        # launch takes its current stream again
        query, rows, scales, labels, mx, se, dtau_unit = ctx.saved_tensors
        dq = None
        if ctx.needs_input_grad[0]:
            bank = rows if scales is None else QuantBank(rows, scales)
            dq = _launch_bwd(query, bank, labels, ctx.tau_value, mx, se,
                             gout.contiguous())
        dtau = None
        if ctx.tau_grad:
            dtau = (gout * dtau_unit).to(ctx.tau_like.dtype).to(
                ctx.tau_like.device).reshape(ctx.tau_like.shape)
        return dq, None, None, None, dtau


def bank_infonce(query: torch.Tensor, bank, labels: torch.Tensor, tau: Tau
                 ) -> torch.Tensor:
    """Full-bank InfoNCE over a dense bank tensor or an int8 `QuantBank`;
    see the module docstring for the routes."""
    quant = isinstance(bank, QuantBank)
    if query.device.type == "cpu":
        reference = bank_infonce_q8_reference if quant else bank_infonce_reference
        return reference(query, bank, labels, tau)
    # the kernels take float32 rows; a narrower query is widened here, and
    # autograd casts dQ back to its dtype
    rows, scales = (bank.values, bank.scales) if quant else (bank, None)
    return _BankInfoNCE.apply(query.float().contiguous(), rows, scales,
                              labels, tau)
