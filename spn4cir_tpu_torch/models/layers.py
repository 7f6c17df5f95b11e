"""Shared PyTorch building blocks for the encoder towers.

Counterpart of `spn4cir_tpu/models/layers.py`, with OpenAI-CLIP parameter
names (`in_proj_weight`, `out_proj`, `mlp.c_fc`, `resblocks.{i}`) so that an
OpenAI or clip4cir checkpoint loads with `load_state_dict` directly. BLIP's
ViT keeps its checkpoint's timm names in `models/blip_vit.py` and shares
the attention core (`SelfAttention.attend`) and `run_blocks` from here.

Precision policy, as in the JAX package: parameters are float32; each
module computes in its activation `dtype` (bfloat16 under `--bf16`), casting
the weights at use; LayerNorm always computes in float32 and casts back.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from spn4cir_tpu_torch.ops.attention_kernels import (attention_route,
                                                      long_attention,
                                                      short_attention)
from spn4cir_tpu_torch.ops.layer_norm import layer_norm_f32

ATTENTION_IMPLS = ("auto", "plain")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU of BLIP's ViT and of BERT."""
    return F.gelu(x)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """`layer` applied in the dtype of `x` (float32 params cast at use).
    A tensor-parallel layer (`parallel.tp`) carries `tp`, which applies its
    slice with the model group's collective."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    tp = getattr(layer, "tp", None)
    if tp is not None:
        return tp(x, layer.weight.to(x.dtype), bias)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in float32, output cast back to the input dtype:
    `ops.layer_norm.layer_norm_f32`, the plain chain on the CPU and the
    LayerNorm kernel on a CUDA tensor."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_f32(x, self.normalized_shape, self.weight,
                              self.bias, self.eps)


class SelfAttention(nn.Module):
    """The attention core shared by the towers: routing and the three
    routes. Subclasses own the projections (and their checkpoint names).

    `fused="auto"` (the default): every maskless or causal self-attention
    goes to a kernel wrapper, chosen by `ops.attention_kernels.
    attention_route` from the shape alone: S <= 128 and head_dim <= 128 to
    `short_attention` (the causal text attention included), a longer
    maskless sequence to `long_attention`. On a CUDA tensor a wrapper
    launches its hand-written kernel, forward and backward, or raises; the
    plain path below is reached only with an explicit mask or with
    `fused="plain"` (set by `set_attention_impl`). It computes exactly what
    the JAX einsum path does (models/layers.py:103-110): float32 logits and
    softmax, weights cast to the activation dtype."""

    def __init__(self, num_heads: int, causal: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.fused = "auto"

    def attend(self, qkv: torch.Tensor, mask: torch.Tensor | None = None
               ) -> torch.Tensor:
        """qkv: (B, S, 3*width), the fused projection -> (B, S, width)."""
        if self.causal and mask is not None:
            raise ValueError("causal=True with an explicit mask")
        b, s, d3 = qkv.shape
        d = d3 // 3
        hd = d // self.num_heads
        q, k, v = qkv.view(b, s, 3, self.num_heads, hd).unbind(2)
        q = q * hd ** -0.5
        route = attention_route(s, hd, self.causal, mask is not None,
                                self.fused)
        if route == "plain":
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            if self.causal:
                mask = causal_mask(s, device=qkv.device)
            if mask is not None:
                logits = logits + mask.float()
            weights = torch.softmax(logits, dim=-1).to(qkv.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        else:
            def flat(t):  # (B, S, H, Dh) -> contiguous (B*H, S, Dh)
                return t.transpose(1, 2).reshape(
                    b * self.num_heads, s, hd).contiguous()

            if route == "short":
                o = short_attention(flat(q), flat(k), flat(v), self.causal)
            else:
                o = long_attention(flat(q), flat(k), flat(v))
            out = o.view(b, self.num_heads, s, hd).transpose(1, 2)
        return out.reshape(b, s, d)


class MultiHeadAttention(SelfAttention):
    """Self-attention with the fused qkv projection of OpenAI CLIP
    (`nn.MultiheadAttention`'s `in_proj_weight` layout)."""

    def __init__(self, width: int, num_heads: int, causal: bool = False):
        super().__init__(num_heads, causal)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype),
                       self.in_proj_bias.to(x.dtype))
        return linear(self.attend(qkv, mask), self.out_proj)


class MLP(nn.Module):
    def __init__(self, width: int, mult: float = 4.0):
        super().__init__()
        hidden = int(width * mult)
        self.c_fc = nn.Linear(width, hidden)
        self.c_proj = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(quick_gelu(linear(x, self.c_fc)), self.c_proj)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block (CLIP style: QuickGELU, LN eps 1e-5; BLIP's
    ViT has the same shape with exact GELU and eps 1e-6 under its
    checkpoint's names, `models/blip_vit.Block`)."""

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


def run_blocks(blocks: Iterable[nn.Module], x: torch.Tensor, *args,
               remat: bool = False) -> torch.Tensor:
    """x through `blocks` in order. `remat` keeps only each block's input
    and runs the block's forward again in the backward
    (`torch.utils.checkpoint`, non-reentrant), where gradients are wanted;
    the counterpart of the JAX package's `nn.remat` over its scanned
    stack."""
    for block in blocks:
        if remat and torch.is_grad_enabled() and x.requires_grad:
            x = checkpoint(block, x, *args, use_reentrant=False)
        else:
            x = block(x, *args)
    return x


class Transformer(nn.Module):
    """A stack of pre-LN blocks (a plain ModuleList; the JAX package rolls
    the same stack with nn.scan). `remat=True` rematerializes each block on
    the backward pass."""

    def __init__(self, width: int, layers: int, heads: int,
                 causal: bool = False, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal=causal)
            for _ in range(layers))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        return run_blocks(self.resblocks, x, mask, remat=self.remat)


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask: zeros on and below the diagonal, -inf above."""
    return torch.full((length, length), float("-inf"), device=device).triu(1)


def set_attention_impl(module: nn.Module, fused: str) -> None:
    """Route every self-attention under `module` through `fused` ("auto":
    the attention kernels; "plain": tensor code)."""
    if fused not in ATTENTION_IMPLS:
        raise ValueError(f"fused must be one of {ATTENTION_IMPLS}")
    for m in module.modules():
        if isinstance(m, SelfAttention):
            m.fused = fused

