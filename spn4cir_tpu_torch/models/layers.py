"""Shared PyTorch building blocks for the CLIP towers.

Counterpart of `spn4cir_tpu/models/layers.py`, with OpenAI-CLIP parameter
names (`in_proj_weight`, `out_proj`, `mlp.c_fc`, `resblocks.{i}`) so that an
OpenAI or clip4cir checkpoint loads with `load_state_dict` directly.

Precision policy, as in the JAX package: parameters are float32; each
module computes in its activation `dtype` (bfloat16 under `--bf16`), casting
the weights at use; LayerNorm always computes in float32 and casts back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spn4cir_tpu_torch.ops.attention_kernels import (kernel_takes,
                                                      short_attention)

ATTENTION_IMPLS = ("auto", "plain")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """`layer` applied in the dtype of `x` (float32 params cast at use)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in float32, output cast back to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Self-attention with the fused qkv projection of OpenAI CLIP
    (`nn.MultiheadAttention`'s `in_proj_weight` layout).

    `fused="auto"` (the default): every maskless self-attention that the
    kernels take (S <= 128 and head_dim <= 128) goes to `short_attention`,
    the causal text attention included; on a CUDA tensor that is the
    hand-written kernel, forward and backward.
    Longer sequences, explicit masks and `fused="plain"` (set by
    `set_attention_impl`) take the plain path, which computes exactly what
    the JAX einsum path does (models/layers.py:103-110): float32 logits and
    softmax, weights cast to the activation dtype."""

    def __init__(self, width: int, num_heads: int, causal: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.fused = "auto"
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        if self.causal and mask is not None:
            raise ValueError("causal=True with an explicit mask")
        b, s, d = x.shape
        hd = d // self.num_heads
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype),
                       self.in_proj_bias.to(x.dtype))
        q, k, v = qkv.view(b, s, 3, self.num_heads, hd).unbind(2)
        q = q * hd ** -0.5
        if self.fused == "auto" and mask is None and kernel_takes(s, hd):
            def flat(t):  # (B, S, H, Dh) -> contiguous (B*H, S, Dh)
                return t.transpose(1, 2).reshape(
                    b * self.num_heads, s, hd).contiguous()

            o = short_attention(flat(q), flat(k), flat(v), self.causal)
            out = o.view(b, self.num_heads, s, hd).transpose(1, 2)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            if self.causal:
                mask = causal_mask(s, device=x.device)
            if mask is not None:
                logits = logits + mask.float()
            weights = torch.softmax(logits, dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return linear(out.reshape(b, s, d), self.out_proj)


class MLP(nn.Module):
    def __init__(self, width: int, mult: float = 4.0):
        super().__init__()
        hidden = int(width * mult)
        self.c_fc = nn.Linear(width, hidden)
        self.c_proj = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(quick_gelu(linear(x, self.c_fc)), self.c_proj)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block (CLIP style)."""

    def __init__(self, width: int, num_heads: int, causal: bool = False):
        super().__init__()
        self.attn = MultiHeadAttention(width, num_heads, causal=causal)
        self.ln_1 = LayerNorm(width)
        self.mlp = MLP(width)
        self.ln_2 = LayerNorm(width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask=mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """A stack of pre-LN blocks (a plain ModuleList; the JAX package rolls
    the same stack with nn.scan)."""

    def __init__(self, width: int, layers: int, heads: int,
                 causal: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal=causal)
            for _ in range(layers))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, mask)
        return x


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask: zeros on and below the diagonal, -inf above."""
    return torch.full((length, length), float("-inf"), device=device).triu(1)


def set_attention_impl(module: nn.Module, fused: str) -> None:
    """Route every MultiHeadAttention under `module` through `fused`
    ("auto": the short-attention kernel where eligible; "plain")."""
    if fused not in ATTENTION_IMPLS:
        raise ValueError(f"fused must be one of {ATTENTION_IMPLS}")
    for m in module.modules():
        if isinstance(m, MultiHeadAttention):
            m.fused = fused

