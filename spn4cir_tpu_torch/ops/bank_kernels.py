"""Full-bank InfoNCE (the stage-2 "scaling negatives" loss) and int8 banks.

Counterpart of `spn4cir_tpu/ops/bank_kernels.py`:

    logits = (Q @ bankᵀ) / tau          # (B, M), M = all train images
    loss   = mean_i [ logsumexp_j logits[i, j] - logits[i, labels[i]] ]

`bank_infonce(query, bank, labels, tau)` never materialises the (B, M)
logits on the card: the forward kernel (`bank_infonce_fwd`, replacing the
TPU `_fwd_kernel`) sweeps the bank and emits per-row statistics (max,
sum-exp, positive logit, Σ exp·logit), and the backward kernel
(`bank_infonce_bwd`, replacing `_bwd_kernel`) recomputes the softmax from
the saved statistics and accumulates dQ. Both live in
`csrc/bank_infonce.cu`, are built with nvcc at first use, and count their
launches in `bank_infonce_fwd.launches` / `bank_infonce_bwd.launches`.

Routes:
  - dense float32 / bfloat16 bank on a CUDA device: the kernels, through
    `torch.autograd.Function`; a CUDA input they cannot take raises;
  - tensors on the CPU: `bank_infonce_reference`, the plain PyTorch version
    (autograd differentiates it), counting nothing;
  - `QuantBank` (int8): NotImplementedError, kernels 7-8 are not ported yet.

Gradients: dquery and dtau are exact; the bank is a frozen feature cache in
stage 2 and gets none. The bfloat16 bank is widened to float32 before the
product in the kernels and in the plain version alike.

The JAX package pads the frozen bank once to its kernel's block multiple
(`PreparedBank` / `prepare_bank`) and caches that relayout beside the bank.
The Hopper kernels mask the tail of M and of B themselves, so there is no
prepared layout here and nothing to cache.

`QuantBank` / `quantize_bank` (per-row absmax int8) serve
`--gallery_dtype int8` in the retrieval service.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple, Union

import torch

TILE_ROWS = 64     # query rows per CTA   (kTileR in csrc/bank_infonce.cu)
TILE_COLS = 128    # bank rows per tile   (kTileC)
MAX_BWD_DIM = 512  # backward accumulator width (kMaxD)

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


def bank_infonce_stats_reference(query: torch.Tensor, bank: torch.Tensor,
                                 labels: torch.Tensor, tau: Tau) -> Stats:
    """The forward kernel's four per-row statistics, from materialised
    float32 logits: mx = max_j l, se = Σ_j exp(l - mx), pos = l[label],
    el = Σ_j exp(l - mx)·l."""
    logits = _logits(query, bank, tau)
    mx = logits.amax(dim=-1)
    e = torch.exp(logits - mx[:, None])
    pos = logits.gather(-1, labels.long()[:, None])[:, 0]
    return mx, e.sum(dim=-1), pos, (e * logits).sum(dim=-1)


def bank_infonce_reference(query: torch.Tensor, bank: torch.Tensor,
                           labels: torch.Tensor, tau: Tau) -> torch.Tensor:
    """Plain version of the fused loss: mean(log se + mx - pos). The max is
    a constant shift of the logsumexp, so it is detached; autograd through
    this gives the dQ and dtau the kernels compute."""
    logits = _logits(query, bank.detach(), tau)
    mx = logits.detach().amax(dim=-1)
    se = torch.exp(logits - mx[:, None]).sum(dim=-1)
    pos = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (torch.log(se) + mx - pos).mean()


def bank_infonce_bwd_reference(query: torch.Tensor, bank: torch.Tensor,
                               labels: torch.Tensor, tau: Tau,
                               mx: torch.Tensor, se: torch.Tensor,
                               gout: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward kernel: dQ = ((P - onehot)·g) @ bank,
    P = exp(logits - mx) / se from the saved statistics, g = gout/(B·tau)."""
    logits = _logits(query, bank, tau)
    p = torch.exp(logits - mx[:, None]) / se[:, None]
    p[torch.arange(p.shape[0], device=p.device), labels.long()] -= 1.0
    g = gout.float() / (query.shape[0] * tau)
    return (p * g) @ bank.float()


def dtau_from_stats(stats: Stats, tau: Tau) -> torch.Tensor:
    """d loss / d tau = mean((pos - el/se) / tau)."""
    _, se, pos, el = stats
    return ((pos - el / se) / tau).mean()


# --------------------------------------------------------------------------
# The kernels
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from spn4cir_tpu_torch.ops.cuda_build import build_library

    lib = ctypes.CDLL(str(build_library("bank_infonce", ["bank_infonce.cu"])))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bank_infonce_fwd.restype = i32
    lib.bank_infonce_fwd.argtypes = ([ptr] * 3 + [f32] + [i32] * 6
                                     + [ptr] * 7)
    lib.bank_infonce_bwd.restype = i32
    lib.bank_infonce_bwd.argtypes = ([ptr] * 6 + [f32] + [i32] * 6
                                     + [ptr] * 3)
    return lib


def split_plan(m: int, b: int, sm_count: int, ctas_per_sm: int
               ) -> Tuple[int, int]:
    """(tiles_per_split, n_splits): cut the bank's ceil(M/128) tiles into
    contiguous splits so that splits x row tiles is about
    sm_count * ctas_per_sm CTAs. A pure function of its arguments, so the
    order of every sum is fixed for a given device."""
    tiles = -(-m // TILE_COLS)
    row_tiles = -(-b // TILE_ROWS)
    want = max(1, (sm_count * ctas_per_sm) // row_tiles)
    tiles_per_split = -(-tiles // want)
    return tiles_per_split, -(-tiles // tiles_per_split)


def _check(query: torch.Tensor, bank: torch.Tensor, labels: torch.Tensor
           ) -> None:
    if query.dim() != 2 or bank.dim() != 2 or query.shape[1] != bank.shape[1]:
        raise ValueError(f"query (B, D) and bank (M, D) must share D; got "
                         f"{tuple(query.shape)}, {tuple(bank.shape)}")
    if labels.shape != (query.shape[0],):
        raise ValueError(f"labels must be (B,) = ({query.shape[0]},); got "
                         f"{tuple(labels.shape)}")
    if query.dtype != torch.float32:
        raise ValueError(f"the kernels take a float32 query; got {query.dtype}")
    if bank.dtype not in _BANK_DTYPE_CODES:
        raise ValueError(f"the bank must be float32 or bfloat16; got "
                         f"{bank.dtype}")
    if not (query.device == bank.device == labels.device):
        raise ValueError("query, bank and labels must lie on one device")
    if query.shape[1] % 16:
        raise ValueError(f"the kernels take D % 16 == 0; got D={query.shape[1]}")
    if not (query.is_contiguous() and bank.is_contiguous()):
        raise ValueError("query and bank must be contiguous")
    if query.data_ptr() % 16 or bank.data_ptr() % 16:
        raise ValueError("query and bank must be 16-byte aligned")


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def bank_infonce_fwd(query: torch.Tensor, bank: torch.Tensor,
                     labels: torch.Tensor, tau: float
                     ) -> Tuple[torch.Tensor, Stats, torch.Tensor]:
    """Launch the forward kernel on CUDA tensors. Returns (loss, (mx, se,
    pos, el), dtau_unit): a float32 scalar, four (B,) float32 vectors and
    the scalar d loss / d tau."""
    _check(query, bank, labels)
    if query.device.type != "cuda":
        raise ValueError(f"bank_infonce_fwd launches a CUDA kernel; the "
                         f"tensors lie on {query.device}")
    lib = _library()
    b, d = query.shape
    m = bank.shape[0]
    dev = query.device
    tps, n_splits = split_plan(m, b, _sm_count(dev), 2)
    labels32 = labels.to(torch.int32).contiguous()
    part = torch.empty(n_splits, b, 4, device=dev, dtype=torch.float32)
    stats = torch.empty(4, b, device=dev, dtype=torch.float32)
    out2 = torch.empty(2, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bank_infonce_fwd(
            query.data_ptr(), bank.data_ptr(), labels32.data_ptr(), float(tau),
            b, m, d, _BANK_DTYPE_CODES[bank.dtype], tps, n_splits,
            part.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            stats[2].data_ptr(), stats[3].data_ptr(), out2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bank_infonce_fwd launch failed with CUDA error "
                           f"{err} (B={b}, M={m}, D={d}, {bank.dtype})")
    bank_infonce_fwd.launches += 1
    return out2[0], (stats[0], stats[1], stats[2], stats[3]), out2[1]


bank_infonce_fwd.launches = 0


def bank_infonce_bwd(query: torch.Tensor, bank: torch.Tensor,
                     labels: torch.Tensor, tau: float, mx: torch.Tensor,
                     se: torch.Tensor, gout: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel on CUDA tensors: dQ (B, D) float32 from
    the saved (mx, se) and the upstream scalar gradient `gout`."""
    _check(query, bank, labels)
    if query.device.type != "cuda":
        raise ValueError(f"bank_infonce_bwd launches a CUDA kernel; the "
                         f"tensors lie on {query.device}")
    b, d = query.shape
    if d > MAX_BWD_DIM:
        raise ValueError(f"bank_infonce_bwd takes D <= {MAX_BWD_DIM}; got "
                         f"D={d}")
    lib = _library()
    m = bank.shape[0]
    dev = query.device
    tps, n_splits = split_plan(m, b, _sm_count(dev), 1)
    labels32 = labels.to(torch.int32).contiguous()
    mx = mx.float().contiguous()
    se = se.float().contiguous()
    gout = gout.float().reshape(1).contiguous()
    dq_part = torch.empty(n_splits, b, d, device=dev, dtype=torch.float32)
    dq = torch.empty(b, d, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bank_infonce_bwd(
            query.data_ptr(), bank.data_ptr(), labels32.data_ptr(),
            mx.data_ptr(), se.data_ptr(), gout.data_ptr(), float(tau), b, m,
            d, _BANK_DTYPE_CODES[bank.dtype], tps, n_splits,
            dq_part.data_ptr(), dq.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bank_infonce_bwd launch failed with CUDA error "
                           f"{err} (B={b}, M={m}, D={d}, {bank.dtype})")
    bank_infonce_bwd.launches += 1
    return dq


bank_infonce_bwd.launches = 0


class _BankInfoNCE(torch.autograd.Function):
    """loss = bank_infonce(query, bank, labels, tau) through the two
    kernels. `tau` is a float, or a 0-d tensor when its gradient is wanted
    (its value is read on the host once per call)."""

    @staticmethod
    def forward(ctx, query, bank, labels, tau):
        tau_value = float(tau)
        loss, (mx, se, _, _), dtau_unit = bank_infonce_fwd(
            query, bank, labels, tau_value)
        ctx.save_for_backward(query, bank, labels, mx, se, dtau_unit)
        ctx.tau_value = tau_value
        ctx.tau_grad = isinstance(tau, torch.Tensor) and tau.requires_grad
        ctx.tau_like = tau if ctx.tau_grad else None
        return loss

    @staticmethod
    def backward(ctx, gout):
        # autograd's thread: the wrapper takes the current stream and
        # device again
        query, bank, labels, mx, se, dtau_unit = ctx.saved_tensors
        dq = None
        if ctx.needs_input_grad[0]:
            dq = bank_infonce_bwd(query, bank, labels, ctx.tau_value, mx, se,
                                  gout.contiguous())
        dtau = None
        if ctx.tau_grad:
            dtau = (gout * dtau_unit).to(ctx.tau_like.dtype).to(
                ctx.tau_like.device).reshape(ctx.tau_like.shape)
        return dq, None, None, dtau


def bank_infonce(query: torch.Tensor, bank, labels: torch.Tensor, tau: Tau
                 ) -> torch.Tensor:
    """Full-bank InfoNCE; see the module docstring for the routes."""
    if isinstance(bank, QuantBank):
        raise NotImplementedError("int8 bank InfoNCE: kernels 7-8, not yet "
                                  "ported")
    if query.device.type == "cpu":
        return bank_infonce_reference(query, bank, labels, tau)
    # the kernels take float32 rows; a narrower query is widened here, and
    # autograd casts dQ back to its dtype
    return _BankInfoNCE.apply(query.float().contiguous(), bank, labels, tau)
