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

Gradients: dquery and dtau are exact; the bank is a frozen feature cache in
stage 2 and gets none. The bfloat16 bank is widened to float32 before the
product in the kernels and in the plain version alike. The backward kernels
keep a dQ tile of at most 512 columns in registers; a wider D (640, 768) is
cut into equal slices along a grid axis (`dq_slices`).

The JAX package pads the frozen bank once to its kernel's block multiple
(`PreparedBank` / `prepare_bank`) and caches that relayout beside the bank.
The Hopper kernels mask the tail of M and of B themselves, so there is no
prepared layout here and nothing to cache.

`QuantBank` / `quantize_bank` (per-row absmax int8) serve `--bank_dtype
int8` in training and `--gallery_dtype int8` in the retrieval service.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple, Union

import torch

TILE_ROWS = 64     # query rows per CTA   (kTileR in csrc/bank_infonce.cu)
TILE_COLS = 128    # bank rows per tile   (kTileC)
BWD_SLICE = 512    # widest dQ slice per CTA of the backward (kSliceD)

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


def _stats(logits: torch.Tensor, labels: torch.Tensor) -> Stats:
    mx = logits.amax(dim=-1)
    e = torch.exp(logits - mx[:, None])
    pos = logits.gather(-1, labels.long()[:, None])[:, 0]
    return mx, e.sum(dim=-1), pos, (e * logits).sum(dim=-1)


def _loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    mx = logits.detach().amax(dim=-1)
    se = torch.exp(logits - mx[:, None]).sum(dim=-1)
    pos = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (torch.log(se) + mx - pos).mean()


def _coefficient(logits: torch.Tensor, labels: torch.Tensor, tau: Tau,
                 mx: torch.Tensor, se: torch.Tensor, gout: torch.Tensor
                 ) -> torch.Tensor:
    """(P - onehot)·g with P = exp(logits - mx) / se, g = gout/(B·tau)."""
    p = torch.exp(logits - mx[:, None]) / se[:, None]
    p[torch.arange(p.shape[0], device=p.device), labels.long()] -= 1.0
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

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from spn4cir_tpu_torch.ops.cuda_build import build_library

    lib = ctypes.CDLL(str(build_library("bank_infonce", ["bank_infonce.cu"])))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, argtypes in (
            (lib.bank_infonce_fwd, [ptr] * 3 + [f32] + [i32] * 6 + [ptr] * 7),
            (lib.bank_infonce_bwd, [ptr] * 6 + [f32] + [i32] * 7 + [ptr] * 3),
            (lib.bank_infonce_q8_fwd,
             [ptr] * 4 + [f32] + [i32] * 5 + [ptr] * 7),
            (lib.bank_infonce_q8_bwd,
             [ptr] * 7 + [f32] + [i32] * 6 + [ptr] * 3)):
        fn.restype = i32
        fn.argtypes = argtypes
    return lib


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


def dq_slices(d: int) -> Tuple[int, int]:
    """(n_slices, width) of the backward's grid axis over dQ's columns: the
    fewest equal slices of at most `BWD_SLICE` columns, the width rounded up
    to the 64 columns that one pass of a CTA's threads covers."""
    n = -(-d // BWD_SLICE)
    width = -(-(-(-d // n)) // 64) * 64
    return -(-d // width), width


def _check(query: torch.Tensor, bank, labels: torch.Tensor) -> None:
    quant = isinstance(bank, QuantBank)
    rows = bank.values if quant else bank
    if query.dim() != 2 or rows.dim() != 2 or query.shape[1] != rows.shape[1]:
        raise ValueError(f"query (B, D) and bank (M, D) must share D; got "
                         f"{tuple(query.shape)}, {tuple(rows.shape)}")
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


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    lib = _library()
    b, d = query.shape
    m = bank.shape[0]
    dev = query.device
    tps, n_splits = split_plan(m, b, _sm_count(dev), 2)
    labels32 = labels.to(torch.int32).contiguous()
    part = torch.empty(n_splits, b, 4, device=dev, dtype=torch.float32)
    stats = torch.empty(4, b, device=dev, dtype=torch.float32)
    out2 = torch.empty(2, device=dev, dtype=torch.float32)
    wrapper, fn, bank_ptrs, code = _bank_args(lib, bank, "fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(query.data_ptr(), *bank_ptrs, labels32.data_ptr(),
                 float(tau), b, m, d, *code, tps, n_splits, part.data_ptr(),
                 stats[0].data_ptr(), stats[1].data_ptr(),
                 stats[2].data_ptr(), stats[3].data_ptr(), out2.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed with CUDA error "
                           f"{err} (B={b}, M={m}, D={d}, {bank.dtype})")
    wrapper.launches += 1
    return out2[0], (stats[0], stats[1], stats[2], stats[3]), out2[1]


def _launch_bwd(query: torch.Tensor, bank, labels: torch.Tensor, tau: float,
                mx: torch.Tensor, se: torch.Tensor, gout: torch.Tensor
                ) -> torch.Tensor:
    _check(query, bank, labels)
    if query.device.type != "cuda":
        raise ValueError(f"the bank InfoNCE backward launches a CUDA kernel; "
                         f"the tensors lie on {query.device}")
    lib = _library()
    b, d = query.shape
    m = bank.shape[0]
    dev = query.device
    n_slices, width = dq_slices(d)
    tps, n_splits = split_plan(m, b, _sm_count(dev), 1, n_slices)
    labels32 = labels.to(torch.int32).contiguous()
    mx = mx.float().contiguous()
    se = se.float().contiguous()
    gout = gout.float().reshape(1).contiguous()
    dq_part = torch.empty(n_splits, b, d, device=dev, dtype=torch.float32)
    dq = torch.empty(b, d, device=dev, dtype=torch.float32)
    wrapper, fn, bank_ptrs, code = _bank_args(lib, bank, "bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(query.data_ptr(), *bank_ptrs, labels32.data_ptr(),
                 mx.data_ptr(), se.data_ptr(), gout.data_ptr(), float(tau), b,
                 m, d, *code, tps, n_splits, width, dq_part.data_ptr(),
                 dq.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed with CUDA error "
                           f"{err} (B={b}, M={m}, D={d}, {bank.dtype})")
    wrapper.launches += 1
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


for _wrapper in (bank_infonce_fwd, bank_infonce_bwd, bank_infonce_q8_fwd,
                 bank_infonce_q8_bwd):
    _wrapper.launches = 0


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
        # autograd's thread: the wrapper takes the current stream and
        # device again
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
