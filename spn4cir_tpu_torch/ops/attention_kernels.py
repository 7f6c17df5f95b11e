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
every S >= 1 and every head_dim <= 128 that is a multiple of 8; bfloat16
runs on the tensor cores and needs its tensors to start on a 16-byte
boundary (as every fresh allocation does), float32 on the CUDA cores.

`attention_route` is the one place that decides which of the three routes
(short kernel, long kernel, plain tensor code) a self-attention takes, and
`short_route` which of the two kernels the short forward and the short
backward each launch for a CUDA input: bfloat16 with head_dim % 8 == 0 runs
on the tensor cores and needs its tensors (the backward's dout too) to
start on a 16-byte boundary; float32, and bfloat16 at any other head_dim,
run on the CUDA cores.
"""

from __future__ import annotations

import ctypes

import torch

from spn4cir_tpu_torch.ops.cuda_build import counted, launch, load_library

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


def short_route(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """Which kernel `short_attention`'s forward and `short_attention_bwd`
    launch for CUDA (BH, S, D) inputs of `dtype`: "tensor_cores" for
    bfloat16 with D % 8 == 0 (`aligned`: q, k, v and, for the backward,
    dout start on a 16-byte boundary, as `cp.async` needs; ValueError
    otherwise), "cuda_cores" for float32 (TF32 would not hold the float32
    tolerance) and for bfloat16 with D % 8 != 0."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"short_attention takes float32 or bfloat16; got "
                         f"{dtype}")
    if dtype != torch.bfloat16 or d % 8:
        return "cuda_cores"
    if not aligned:
        raise ValueError("short_attention's bfloat16 tensor-core kernels "
                         "take tensors whose data starts on a 16-byte "
                         "boundary")
    return "tensor_cores"


def _tensor_route(*ts: torch.Tensor) -> str:
    """`short_route` for the tensors a short kernel reads: q, k, v and, for
    the backward, dout; all share the first one's dtype and head dim."""
    return short_route(ts[0].dtype, ts[0].shape[-1],
                       not any(t.data_ptr() % 16 for t in ts))


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# q, k, v, (dout,) then the outputs; BH, S, D, dtype code, causal, tensor
# cores; stream
SHORT_ENTRY_POINTS = {
    "short_attention_fwd": [_PTR] * 4 + [_I32] * 6 + [_PTR],
    "short_attention_bwd": [_PTR] * 7 + [_I32] * 6 + [_PTR],
}


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
    bh, s, d = q.shape
    route = _tensor_route(q, k, v)
    lib = load_library("short_attention", SHORT_ENTRY_POINTS)
    out = torch.empty_like(q)
    launch(short_attention, lib.short_attention_fwd, q.get_device(),
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, d,
           _DTYPE_CODES[q.dtype], int(causal), int(route == "tensor_cores"))
    return out


def short_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, causal: bool = False):
    """(dq, dk, dv) for CUDA tensors through the backward kernel that
    `short_route` picks; `dout` must already have q's dtype and shape and be
    contiguous. Every argument is checked before the device: a bf16 dout
    off a 16-byte boundary is refused for the tensor cores wherever it
    lies."""
    _check(q, k, v)
    if (dout.shape != q.shape or dout.dtype != q.dtype
            or dout.device != q.device or not dout.is_contiguous()):
        raise ValueError("dout must match q in shape, dtype and device and "
                         "be contiguous")
    route = _tensor_route(q, k, v, dout)
    if q.device.type != "cuda":
        raise ValueError(f"short_attention_bwd launches a CUDA kernel; the "
                         f"tensors lie on {q.device}")
    bh, s, d = q.shape
    lib = load_library("short_attention", SHORT_ENTRY_POINTS)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    launch(short_attention_bwd, lib.short_attention_bwd, q.get_device(),
           q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, s, d,
           _DTYPE_CODES[q.dtype], int(causal), int(route == "tensor_cores"))
    return dq, dk, dv


counted(short_attention_bwd)


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


counted(short_attention)


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


# forward: q, k, v, out, lse; backward: q, k, v, dout, out, lse, delta, dq,
# dk, dv; then BH, S, D, dtype code; stream
LONG_ENTRY_POINTS = {
    "long_attention_fwd": [_PTR] * 5 + [_I32] * 4 + [_PTR],
    "long_attention_bwd": [_PTR] * 10 + [_I32] * 4 + [_PTR],
}


def _check_aligned(*ts: torch.Tensor) -> None:
    # the bfloat16 kernels copy their operands with 16-byte cp.async
    if ts[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError("long_attention's bfloat16 kernels take tensors "
                         "whose data starts on a 16-byte boundary")


def long_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(out, lse) for CUDA tensors through the forward kernel: the output
    and the rows' log-sum-exp (BH, S) float32, which the backward takes.
    bfloat16 runs on the tensor cores, float32 on the CUDA cores; a
    bfloat16 tensor whose data does not start on a 16-byte boundary is
    refused (ValueError)."""
    _check(q, k, v, long=True)
    if q.device.type != "cuda":
        raise ValueError(f"long_attention_fwd launches a CUDA kernel; the "
                         f"tensors lie on {q.device}")
    _check_aligned(q, k, v)
    lib = load_library("long_attention", LONG_ENTRY_POINTS)
    bh, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    launch(long_attention, lib.long_attention_fwd, q.get_device(),
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           lse.data_ptr(), bh, s, d, _DTYPE_CODES[q.dtype])
    return out, lse


def long_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, out: torch.Tensor,
                       lse: torch.Tensor):
    """(dq, dk, dv) for CUDA tensors through the backward kernels; `out`
    and `lse` are what `long_attention_fwd` returned for (q, k, v); `dout`
    must already have q's dtype and shape and be contiguous; bfloat16 q,
    k, v and dout must start on a 16-byte boundary (ValueError)."""
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
    _check_aligned(q, k, v, dout)
    lib = load_library("long_attention", LONG_ENTRY_POINTS)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    delta = torch.empty_like(lse)       # rowsum(dO∘O), written by the kernel
    launch(long_attention_bwd, lib.long_attention_bwd, q.get_device(),
           q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
           out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
           dk.data_ptr(), dv.data_ptr(), bh, s, d, _DTYPE_CODES[q.dtype])
    return dq, dk, dv


counted(long_attention_bwd)


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


counted(long_attention)
