"""Max-over-query bank InfoNCE (the BLIP-2 stage-2 loss) and its kernels.

Counterpart of `spn4cir_tpu/ops/maxquery_kernels.py`:

    sims   = einsum('bd,mqd->bmq', feats, bank)   # Q = 32 query tokens
    logits = max_q(sims) / tau                    # (B, M)
    loss   = mean CE(logits, labels)

`max_query_infonce(feats, bank, labels, tau)` never materialises the (B, M,
Q) sims on the card: the forward kernel (`max_query_infonce_fwd`, replacing
the TPU `_fwd_kernel`) sweeps the bank with a running max over the queries
and emits per-row statistics (max, sum-exp, positive logit, Σ exp·logit);
the backward kernel (`max_query_infonce_bwd`, replacing `_bwd_kernel`)
recomputes the sims, routes each (b, m) weight to the FIRST query that
reaches the max and accumulates dfeats. Both take a dense (M, Q, D) float32
or bfloat16 bank, or an int8 `QuantBank` with (M, Q) scales, where the scale
multiplies each sim before the max and 1/tau follows. They live in
`csrc/max_query_infonce.cu`, are built with nvcc at first use, and count
their launches in `<wrapper>.launches`.

Routes:
  - tensors on a CUDA device: the kernels, through `torch.autograd.Function`;
    a CUDA input they cannot take raises;
  - tensors on the CPU: `max_query_infonce_reference`, the plain PyTorch
    version (autograd differentiates it), counting nothing.

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
import functools
from typing import Tuple

import torch

from spn4cir_tpu_torch.ops import bank_kernels
from spn4cir_tpu_torch.ops.bank_kernels import QuantBank, Stats, Tau

# the kernels' layout, as csrc/max_query_infonce.cu fixes it at compile time
# (which also asserts that the widest D fits the shared memory)
CHUNK = 32              # depth of a bank chunk: D % CHUNK == 0 (kBK)
MAX_DIM = 512           # widest D of the backward's routed sum (kMaxD)
TILE_ROWS = 32          # feats rows per CTA (kRows)
TILE_COLS = 256         # bank rows per tile (kCols)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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


def max_query_infonce_bwd_reference(feats: torch.Tensor, bank,
                                    labels: torch.Tensor, tau: Tau,
                                    mx: torch.Tensor, se: torch.Tensor,
                                    gout: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward kernel: w = (P - onehot)·g with P from
    the saved (mx, se) and g = gout/(B·tau), put at each (b, m)'s first
    argmax query (times its scale over an int8 bank), then one product
    with the bank's (M·Q, D) rows."""
    logits, arg = _max_logits(feats, bank, tau)
    coef = bank_kernels._coefficient(logits, labels, tau, mx, se, gout)
    b, m = coef.shape
    rows = bank.values if isinstance(bank, QuantBank) else bank
    nq, d = rows.shape[1], rows.shape[2]
    w = torch.zeros(b, m, nq, dtype=torch.float32, device=coef.device)
    w.scatter_(-1, arg[..., None], coef[..., None])
    if isinstance(bank, QuantBank):
        w = w * bank.scales[None]
    return w.reshape(b, m * nq) @ rows.reshape(m * nq, d).float()


# --------------------------------------------------------------------------
# The kernels
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from spn4cir_tpu_torch.ops.cuda_build import build_library

    lib = ctypes.CDLL(str(build_library("max_query_infonce",
                                       ["max_query_infonce.cu"])))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, argtypes in (
            (lib.max_query_infonce_fwd,
             [ptr] * 4 + [f32] + [i32] * 7 + [ptr] * 7),
            (lib.max_query_infonce_bwd,
             [ptr] * 7 + [f32] + [i32] * 7 + [ptr] * 3)):
        fn.restype = i32
        fn.argtypes = argtypes
    return lib


def split_plan(m: int, b: int, sm_count: int) -> Tuple[int, int]:
    """(tiles_per_split, n_splits): cut the bank's tiles into contiguous
    splits so that splits x row tiles is about one CTA per SM. A pure
    function of its arguments, so the order of every sum is fixed for a
    given device."""
    tiles = -(-m // TILE_COLS)
    want = max(1, sm_count // -(-b // TILE_ROWS))
    tiles_per_split = -(-tiles // want)
    return tiles_per_split, -(-tiles // tiles_per_split)


def _check(feats: torch.Tensor, bank, labels: torch.Tensor) -> None:
    quant = isinstance(bank, QuantBank)
    rows = bank.values if quant else bank
    if feats.dim() != 2 or rows.dim() != 3 or feats.shape[1] != rows.shape[2]:
        raise ValueError(f"feats (B, D) and bank (M, Q, D) must share D; got "
                         f"{tuple(feats.shape)}, {tuple(rows.shape)}")
    if labels.shape != (feats.shape[0],):
        raise ValueError(f"labels must be (B,) = ({feats.shape[0]},); got "
                         f"{tuple(labels.shape)}")
    if feats.dtype != torch.float32:
        raise ValueError(f"the kernels take float32 feats; got {feats.dtype}")
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
    if not (feats.device == rows.device == labels.device):
        raise ValueError("feats, bank and labels must lie on one device")
    if feats.device.type != "cuda":
        raise ValueError(f"the max-query InfoNCE kernels launch on CUDA; the "
                         f"tensors lie on {feats.device}")
    d = feats.shape[1]
    if d % CHUNK or d > MAX_DIM:
        raise ValueError(f"the kernels take D % {CHUNK} == 0 and D <= "
                         f"{MAX_DIM}; got D={d}")
    if rows.shape[1] > 32767:
        raise ValueError(f"the kernels take Q <= 32767; got {rows.shape[1]}")
    if not (feats.is_contiguous() and rows.is_contiguous()):
        raise ValueError("feats and bank must be contiguous")
    if feats.data_ptr() % 16 or rows.data_ptr() % 16:
        raise ValueError("feats and bank must be 16-byte aligned")


def _bank_args(bank):
    """(values pointer, scales pointer or None, dtype code, M, Q)."""
    if isinstance(bank, QuantBank):
        return (bank.values.data_ptr(), bank.scales.data_ptr(), 2,
                *bank.values.shape[:2])
    return (bank.data_ptr(), None, _DTYPE_CODES[bank.dtype], *bank.shape[:2])


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def max_query_infonce_fwd(feats: torch.Tensor, bank, labels: torch.Tensor,
                          tau: float) -> Tuple[torch.Tensor, Stats,
                                               torch.Tensor]:
    """Launch the forward kernel on CUDA tensors (a dense (M, Q, D) bank or
    an int8 QuantBank). Returns (loss, (mx, se, pos, el), dtau_unit): a
    float32 scalar, four (B,) float32 vectors and the scalar d loss / d tau."""
    _check(feats, bank, labels)
    lib = _library()
    b, d = feats.shape
    values, scales, code, m, nq = _bank_args(bank)
    dev = feats.device
    tps, n_splits = split_plan(m, b, _sm_count(dev))
    labels32 = labels.to(torch.int32).contiguous()
    part = torch.empty(n_splits, b, 4, device=dev, dtype=torch.float32)
    stats = torch.empty(4, b, device=dev, dtype=torch.float32)
    out2 = torch.empty(2, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.max_query_infonce_fwd(
            feats.data_ptr(), values, scales, labels32.data_ptr(), float(tau),
            b, m, nq, d, code, tps, n_splits,
            part.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            stats[2].data_ptr(), stats[3].data_ptr(), out2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"max_query_infonce_fwd launch failed with CUDA "
                           f"error {err} (B={b}, M={m}, Q={nq}, D={d}, "
                           f"{bank.dtype})")
    max_query_infonce_fwd.launches += 1
    return out2[0], (stats[0], stats[1], stats[2], stats[3]), out2[1]


def max_query_infonce_bwd(feats: torch.Tensor, bank, labels: torch.Tensor,
                          tau: float, mx: torch.Tensor, se: torch.Tensor,
                          gout: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel on CUDA tensors: dfeats (B, D) float32
    from the saved (mx, se) and the upstream scalar gradient `gout`."""
    _check(feats, bank, labels)
    lib = _library()
    b, d = feats.shape
    values, scales, code, m, nq = _bank_args(bank)
    dev = feats.device
    tps, n_splits = split_plan(m, b, _sm_count(dev))
    labels32 = labels.to(torch.int32).contiguous()
    mx = mx.float().contiguous()
    se = se.float().contiguous()
    gout = gout.float().reshape(1).contiguous()
    dq_part = torch.empty(n_splits, b, d, device=dev, dtype=torch.float32)
    dq = torch.empty(b, d, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.max_query_infonce_bwd(
            feats.data_ptr(), values, scales, labels32.data_ptr(),
            mx.data_ptr(), se.data_ptr(), gout.data_ptr(), float(tau), b, m,
            nq, d, code, tps, n_splits, dq_part.data_ptr(),
            dq.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"max_query_infonce_bwd launch failed with CUDA "
                           f"error {err} (B={b}, M={m}, Q={nq}, D={d}, "
                           f"{bank.dtype})")
    max_query_infonce_bwd.launches += 1
    return dq


max_query_infonce_fwd.launches = 0
max_query_infonce_bwd.launches = 0


class _MaxQueryInfoNCE(torch.autograd.Function):
    """loss = max_query_infonce(feats, bank, labels, tau) through the forward
    and the backward kernel. A QuantBank crosses as (values, scales) and a
    dense bank as (rows, None). `tau` is a float, or a 0-d tensor when its
    gradient is wanted (its value is read on the host once per call)."""

    @staticmethod
    def forward(ctx, feats, rows, scales, labels, tau):
        tau_value = float(tau)
        bank = rows if scales is None else QuantBank(rows, scales)
        loss, (mx, se, _, _), dtau_unit = max_query_infonce_fwd(
            feats, bank, labels, tau_value)
        ctx.save_for_backward(feats, rows, scales, labels, mx, se, dtau_unit)
        ctx.tau_value = tau_value
        ctx.tau_grad = isinstance(tau, torch.Tensor) and tau.requires_grad
        ctx.tau_like = tau if ctx.tau_grad else None
        return loss

    @staticmethod
    def backward(ctx, gout):
        feats, rows, scales, labels, mx, se, dtau_unit = ctx.saved_tensors
        dfeats = None
        if ctx.needs_input_grad[0]:
            bank = rows if scales is None else QuantBank(rows, scales)
            dfeats = max_query_infonce_bwd(feats, bank, labels, ctx.tau_value,
                                           mx, se, gout.contiguous())
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
