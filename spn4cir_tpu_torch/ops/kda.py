"""The gated delta rule of Kimi Delta Attention (KDA), kernel #15: the
recurrence of each head over a state S of d_k x d_v in float32,

    k̂ = k / ‖k‖,  q̂ = q / ‖q‖ · d_k^-½,  α = exp(g)   (‖x‖² = Σ x² + 1e-6)
    S ← Diag(α) S
    S ← S + β k̂ (v − Sᵀk̂)ᵀ
    o = Sᵀq̂

for q, k, v, g (B, T, H, D) and β (B, T, H), all float32, g the per-channel
log decay (≤ 0). `kda_prefill` runs the T tokens of a prompt from S = 0
and leaves the final S in `state` (B, H, D, D); `kda_decode` takes one
token (T = 1) from the S in `state` and writes the new S back in place.
Both return o (B, T, H, D) float32.

On a CUDA tensor each launches `csrc/kda.cu` (built with nvcc at first use;
D = 128), one launch a call, counted in `kda_prefill.launches` and
`kda_decode.launches` (`ops/cuda_build`'s rule: under a CUDA graph each
replay counts its launches). On a CPU tensor both run `kda_reference`, the
token recurrence written out, which counts nothing.

There is no Pallas kernel behind it: the JAX package has no linear
attention.
"""

from __future__ import annotations

import ctypes

import torch

from spn4cir_tpu_torch.ops.cuda_build import counted, launch, load_library

#: the head size the kernel takes (d_k = d_v)
HEAD_DIM = 128
#: added to Σ x² before the L2 norm's square root
NORM_EPS = 1e-6

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, g, beta, state, o; batch, [tokens,] heads, dim; scale; stream
ENTRY_POINTS = {
    "kda_decode": [_PTR] * 7 + [_I32] * 3 + [_F32, _PTR],
    "kda_prefill": [_PTR] * 7 + [_I32] * 4 + [_F32, _PTR],
}


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + NORM_EPS)


def kda_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, beta: torch.Tensor, state: torch.Tensor,
                  fresh: bool) -> torch.Tensor:
    """Plain version: the recurrence token by token in float32, from S = 0
    when `fresh`, else from `state`; the final S is written into `state`."""
    s = torch.zeros_like(state) if fresh else state.clone()
    o = torch.empty_like(v)
    scale = q.shape[-1] ** -0.5
    for t in range(q.shape[1]):
        kt, qt = l2_normalize(k[:, t]), l2_normalize(q[:, t]) * scale
        s = s * torch.exp(g[:, t])[..., None]
        u = torch.einsum("bhij,bhi->bhj", s, kt)
        d = beta[:, t, :, None] * (v[:, t] - u)
        s = s + kt[..., None] * d[..., None, :]
        o[:, t] = torch.einsum("bhij,bhi->bhj", s, qt)
    state.copy_(s)
    return o


def _check(q, k, v, g, beta, state, tokens=None):
    b, t, h, d = q.shape
    tensors = (q, k, v, g, beta, state)
    if (any(x.dtype is not torch.float32 or not x.is_contiguous()
            or x.data_ptr() % 16 for x in tensors)
            or any(x.shape != q.shape for x in (k, v, g))
            or beta.shape != (b, t, h) or state.shape != (b, h, d, d)
            or d != HEAD_DIM or (tokens is not None and t != tokens)
            or any(x.device != q.device for x in tensors)):
        raise ValueError(
            f"kda takes contiguous, 16-byte aligned float32 q, k, v, g (B, T, "
            f"H, {HEAD_DIM}), beta (B, T, H) and state (B, H, {HEAD_DIM}, "
            f"{HEAD_DIM}) on one device{'' if tokens is None else ' with T = 1'}; "
            f"got q {q.dtype} {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, g {tuple(g.shape)}, beta {beta.dtype} "
            f"{tuple(beta.shape)}, state {state.dtype} {tuple(state.shape)}")


def kda_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, beta: torch.Tensor, state: torch.Tensor
                ) -> torch.Tensor:
    """o of the T tokens from S = 0; the final S written into `state`."""
    if not q.is_cuda:
        return kda_reference(q, k, v, g, beta, state, fresh=True)
    _check(q, k, v, g, beta, state)
    b, t, h, d = q.shape
    o = torch.empty_like(v)
    launch(kda_prefill, load_library("kda", ENTRY_POINTS).kda_prefill,
           q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
           g.data_ptr(), beta.data_ptr(), state.data_ptr(), o.data_ptr(), b,
           t, h, d, d ** -0.5)
    return o


def kda_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               g: torch.Tensor, beta: torch.Tensor, state: torch.Tensor
               ) -> torch.Tensor:
    """o of one token (T = 1) from the S in `state`, updated in place."""
    if not q.is_cuda:
        return kda_reference(q, k, v, g, beta, state, fresh=False)
    _check(q, k, v, g, beta, state, tokens=1)
    b, _, h, d = q.shape
    o = torch.empty_like(v)
    launch(kda_decode, load_library("kda", ENTRY_POINTS).kda_decode,
           q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
           g.data_ptr(), beta.data_ptr(), state.data_ptr(), o.data_ptr(), b,
           h, d, d ** -0.5)
    return o


counted(kda_prefill, kda_decode)
