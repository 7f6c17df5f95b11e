"""Self-attention: the Hopper kernels and their plain versions.

Counterpart of `spn4cir_tpu/ops/attention_kernels.py`, in two pairs.

Short sequences: the packed attention (`packed_attention_pallas`,
`packed_causal_attention_pallas`; kernel bodies `_packed_fwd_kernel` and
`_packed_bwd_kernel`). It serves the CLIP towers: ViT-B/32 vision attention
at S=50 and the causal text attention at S=77, both at head_dim 64.

`short_attention(q, k, v, causal)` takes (BH, S, D) tensors with q already
scaled by head_dim**-0.5 and is differentiable:
  - on CUDA tensors the forward launches `short_attention_fwd` and the
    backward `short_attention_bwd` of `csrc/short_attention.cu` (built with
    nvcc at first use), counted in `short_attention.launches` and
    `short_attention_bwd.launches`;
  - on CPU tensors it runs `short_attention_reference` and
    `short_attention_bwd_reference`, the plain PyTorch versions, and counts
    nothing.
There is no other route: a CUDA tensor that a kernel cannot take raises.

Long sequences: the maskless fused attention (`fused_attention_pallas`;
kernel bodies `_fwd_kernel` and `_bwd_kernel`). It serves the ViT towers
whose sequence passes 128: BLIP's ViT-B/16 at 384 (S=577), CLIP ViT-L/14
(S=257) and ViT-B/16 (S=197), EVA-g (head_dim 88).
`long_attention(q, k, v)` has the same contract as `short_attention`
without the causal option: on CUDA tensors `long_attention_fwd` and
`long_attention_bwd` of `csrc/long_attention.cu`, counted in
`long_attention.launches` and `long_attention_bwd.launches`; on CPU tensors
`long_attention_reference` and `long_attention_bwd_reference`. It takes
every S >= 1 and every head_dim <= 128 that is a multiple of 8.

`attention_route` is the one place that decides which of the three routes
(short kernel, long kernel, plain tensor code) a self-attention takes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_SEQ = 128
MAX_HEAD_DIM = 128

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def short_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False
                              ) -> torch.Tensor:
    """softmax(q kᵀ [+ causal mask]) v per leading slice, in plain PyTorch:
    float32 logits and softmax, weights cast to the input dtype before the
    weights·v product (the JAX einsum path, models/layers.py:103-110)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if causal:
        s = q.shape[-2]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights, v)


def short_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, dout: torch.Tensor,
                                  causal: bool = False):
    """(dq, dk, dv) of `short_attention_reference` in plain PyTorch, with
    the roundings of the JAX kernel: P recomputed in float32; P and dS cast
    to the input dtype before their products; products accumulate in
    float32; dout cast to q's dtype."""
    dt = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    do = dout.to(dt).float()
    logits = torch.matmul(qf, kf.transpose(-1, -2))
    if causal:
        s = q.shape[-2]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    pb = p.to(dt).float()
    dv = torch.matmul(pb.transpose(-1, -2), do)
    dp = torch.matmul(do, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsb = ds.to(dt).float()
    dq = torch.matmul(dsb, kf)
    dk = torch.matmul(dsb.transpose(-1, -2), qf)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def kernel_takes(s: int, d: int) -> bool:
    """Whether the short-sequence kernels, forward and backward, take an
    (S, D) slice."""
    return s <= MAX_SEQ and d <= MAX_HEAD_DIM


def attention_route(s: int, d: int, causal: bool, masked: bool,
                    fused: str = "auto") -> str:
    """Which route a self-attention over (S, D) slices takes: "short"
    (`short_attention`), "long" (`long_attention`) or "plain" (tensor code in
    the layer). The rule looks at no device: with `fused="auto"` a maskless
    or causal self-attention always goes to a kernel wrapper (which, on a
    CUDA tensor, launches or raises), so such an attention on a CUDA tensor
    can never reach the plain path. Only an explicit (data-dependent) mask
    or `fused="plain"` takes the plain path.

    Maskless: S <= 128 and D <= 128 -> short, S > 128 -> long. Causal (the
    CLIP text towers, S=77) -> short; a causal S > 128 has no kernel and
    raises."""
    if fused == "plain" or masked:
        return "plain"
    if fused != "auto":
        raise ValueError(f"fused must be 'auto' or 'plain', not {fused!r}")
    if causal:
        if not kernel_takes(s, d):
            raise ValueError(f"causal attention has a kernel for S <= "
                             f"{MAX_SEQ}, D <= {MAX_HEAD_DIM} only; got "
                             f"S={s}, D={d}")
        return "short"
    return "short" if kernel_takes(s, d) else "long"


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from spn4cir_tpu_torch.ops.cuda_build import build_library

    lib = ctypes.CDLL(str(build_library("short_attention",
                                        ["short_attention.cu"])))
    fn = lib.short_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn = lib.short_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           long: bool = False) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (BH, S, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q, k, v must all be float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    _, s, d = q.shape
    if long:
        if q.shape[0] < 1 or s < 1 or d > MAX_HEAD_DIM or d % 8:
            raise ValueError(f"long_attention takes BH, S >= 1 and a D <= "
                             f"{MAX_HEAD_DIM} that is a multiple of 8; got "
                             f"{tuple(q.shape)}")
    elif s > MAX_SEQ or d > MAX_HEAD_DIM:
        raise ValueError(f"short_attention takes S <= {MAX_SEQ} and "
                         f"D <= {MAX_HEAD_DIM}; got S={s}, D={d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")


def _launch_fwd(q, k, v, causal: bool) -> torch.Tensor:
    lib = _library()
    out = torch.empty_like(q)
    bh, s, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.short_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      out.data_ptr(), bh, s, d,
                                      _DTYPE_CODES[q.dtype], int(causal),
                                      stream)
    if err != 0:
        raise RuntimeError(f"short_attention launch failed with CUDA error "
                           f"{err} (BH={bh}, S={s}, D={d}, {q.dtype})")
    short_attention.launches += 1
    return out


def short_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, causal: bool = False):
    """(dq, dk, dv) for CUDA tensors through the backward kernel; `dout`
    must already have q's dtype and shape and be contiguous."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"short_attention_bwd launches a CUDA kernel; the "
                         f"tensors lie on {q.device}")
    if (dout.shape != q.shape or dout.dtype != q.dtype
            or dout.device != q.device or not dout.is_contiguous()):
        raise ValueError("dout must match q in shape, dtype and device and "
                         "be contiguous")
    bh, s, d = q.shape
    lib = _library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.short_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, s, d,
            _DTYPE_CODES[q.dtype], int(causal), stream)
    if err != 0:
        raise RuntimeError(f"short_attention_bwd launch failed with CUDA "
                           f"error {err} (BH={bh}, S={s}, D={d}, {q.dtype})")
    short_attention_bwd.launches += 1
    return dq, dk, dv


short_attention_bwd.launches = 0


class _ShortAttention(torch.autograd.Function):
    """Forward and backward by device: the kernels on CUDA, the plain
    versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        if q.device.type == "cpu":
            return short_attention_reference(q, k, v, causal)
        return _launch_fwd(q, k, v, causal)

    @staticmethod
    def backward(ctx, dout):
        # autograd's thread: the launch takes the current stream and device
        # again
        q, k, v = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = short_attention_bwd_reference(q, k, v, dout,
                                                       ctx.causal)
        else:
            dq, dk, dv = short_attention_bwd(q, k, v, dout, ctx.causal)
        return dq, dk, dv, None


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """(BH, S, D) self-attention with caller-prescaled q; see module doc."""
    _check(q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"short_attention runs on cuda or cpu, not {q.device}")
    return _ShortAttention.apply(q, k, v, bool(causal))


short_attention.launches = 0


# ---------------------------------------------------------------------------
# Long sequences
# ---------------------------------------------------------------------------

def long_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ) v per leading slice in plain PyTorch, with the order of
    the TPU kernel: float32 logits and softmax, P normalised, then cast to
    the input dtype before P·v."""
    return short_attention_reference(q, k, v, False)


def long_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, dout: torch.Tensor):
    """(dq, dk, dv) of `long_attention_reference` in plain PyTorch, with the
    roundings of the TPU kernel (P recomputed whole; P and dS cast to the
    input dtype before their products; rowsum(dP∘P))."""
    return short_attention_bwd_reference(q, k, v, dout, False)


@functools.lru_cache(maxsize=None)
def _long_library() -> ctypes.CDLL:
    from spn4cir_tpu_torch.ops.cuda_build import build_library

    lib = ctypes.CDLL(str(build_library("long_attention",
                                        ["long_attention.cu"])))
    fn = lib.long_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn = lib.long_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    return lib


def long_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(out, lse) for CUDA tensors through the forward kernel: the output
    and the rows' log-sum-exp (BH, S) float32, which the backward takes."""
    _check(q, k, v, long=True)
    if q.device.type != "cuda":
        raise ValueError(f"long_attention_fwd launches a CUDA kernel; the "
                         f"tensors lie on {q.device}")
    lib = _long_library()
    bh, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.long_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), lse.data_ptr(), bh, s, d,
                                     _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"long_attention launch failed with CUDA error "
                           f"{err} (BH={bh}, S={s}, D={d}, {q.dtype})")
    long_attention.launches += 1
    return out, lse


def long_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, out: torch.Tensor,
                       lse: torch.Tensor):
    """(dq, dk, dv) for CUDA tensors through the backward kernels; `out`
    and `lse` are what `long_attention_fwd` returned for (q, k, v); `dout`
    must already have q's dtype and shape and be contiguous."""
    _check(q, k, v, long=True)
    if q.device.type != "cuda":
        raise ValueError(f"long_attention_bwd launches a CUDA kernel; the "
                         f"tensors lie on {q.device}")
    for name, t in (("dout", dout), ("out", out)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must match q in shape, dtype and "
                             "device and be contiguous")
    bh, s, d = q.shape
    if (lse.shape != (bh, s) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("lse must be the forward's (BH, S) float32 tensor")
    lib = _long_library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty_like(lse)       # rowsum(dO∘O), written by the kernel
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.long_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, s, d, _DTYPE_CODES[q.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"long_attention_bwd launch failed with CUDA "
                           f"error {err} (BH={bh}, S={s}, D={d}, {q.dtype})")
    long_attention_bwd.launches += 1
    return dq, dk, dv


long_attention_bwd.launches = 0


class _LongAttention(torch.autograd.Function):
    """Forward and backward by device: the kernels on CUDA, the plain
    versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return long_attention_reference(q, k, v)
        out, lse = long_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        # autograd's thread: the launch takes the current stream and device
        # again
        q, k, v, *saved = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        if q.device.type == "cpu":
            return long_attention_bwd_reference(q, k, v, dout)
        return long_attention_bwd(q, k, v, dout, *saved)


def long_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """(BH, S, D) maskless self-attention with caller-prescaled q, any S;
    see module doc."""
    _check(q, k, v, long=True)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"long_attention runs on cuda or cpu, not {q.device}")
    return _LongAttention.apply(q, k, v)


long_attention.launches = 0
