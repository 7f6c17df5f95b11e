"""Short-sequence self-attention: the Hopper kernel and its plain version.

Counterpart of the packed short-sequence attention in
`spn4cir_tpu/ops/attention_kernels.py` (`packed_attention_pallas`,
`packed_causal_attention_pallas`; kernel body `_packed_fwd_kernel`). It
serves the CLIP towers: ViT-B/32 vision attention at S=50 and the causal
text attention at S=77, both at head_dim 64. Forward only.

`short_attention(q, k, v, causal)` takes (BH, S, D) tensors with q already
scaled by head_dim**-0.5:
  - on a CUDA tensor it launches `csrc/short_attention.cu` (built with nvcc
    at first use) and counts the launch in `short_attention.launches`;
  - on a CPU tensor it runs `short_attention_reference`, the plain PyTorch
    version, and counts nothing.
There is no other route: a CUDA tensor that the kernel cannot take raises.
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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from spn4cir_tpu_torch.ops.cuda_build import build_library

    lib = ctypes.CDLL(str(build_library("short_attention",
                                        ["short_attention.cu"])))
    fn = lib.short_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (BH, S, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q, k, v must all be float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    _, s, d = q.shape
    if s > MAX_SEQ or d > MAX_HEAD_DIM:
        raise ValueError(f"short_attention takes S <= {MAX_SEQ} and "
                         f"D <= {MAX_HEAD_DIM}; got S={s}, D={d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """(BH, S, D) self-attention with caller-prescaled q; see module doc."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return short_attention_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"short_attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("short_attention is forward-only; run it under "
                           "torch.inference_mode() or torch.no_grad()")
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


short_attention.launches = 0
