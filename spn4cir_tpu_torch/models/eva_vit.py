"""EVA ViT-g, BLIP-2's frozen image tower, in PyTorch.

Counterpart of `EvaViTConfig` and `EvaViT` in
`spn4cir_tpu/models/blip24cir.py` (parity target: LAVIS `eva_vit.py`,
`create_eva_vit_g`): 224-pixel images in 14-pixel patches -> 257 tokens,
width 1408, 39 pre-LN blocks of 16 heads of 88, MLP `int(1408 * 4.3637)` =
6144 with exact GELU, LN eps 1e-6, and no final LayerNorm (BLIP-2 applies
its own `ln_vision` after the tower).

Parameter names are LAVIS's (`patch_embed.proj`, `cls_token` (1, 1, D),
`pos_embed` (1, T, D), `blocks.{i}.norm1 / attn.qkv / attn.q_bias /
attn.v_bias / attn.proj / norm2 / mlp.fc1 / mlp.fc2`). EVA's qkv projection
has no bias of its own: its bias is `[q_bias; 0; v_bias]`, as
`convert_eva_vit_state_dict` of the JAX package fuses it.

The blocks are BLIP's (`models/blip_vit.Block`) with this attention, and the
patch embedding is its one matmul over flattened patches. The maskless
attention at S=257, head_dim 88 goes through `SelfAttention.attend`, so
`attention_route` sends every layer to `long_attention` on a CUDA tensor.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from spn4cir_tpu_torch.models.blip_vit import Block, PatchEmbed
from spn4cir_tpu_torch.models.layers import SelfAttention, linear, run_blocks


@dataclasses.dataclass(frozen=True)
class EvaViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1408
    layers: int = 39
    heads: int = 16
    mlp_ratio: float = 4.3637

    @classmethod
    def tiny(cls) -> "EvaViTConfig":
        return cls(image_size=28, patch_size=14, width=32, layers=2, heads=2,
                   mlp_ratio=4.0)

    @property
    def num_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


class EvaAttention(SelfAttention):
    """A bias-free fused `qkv` Linear with separate `q_bias` and `v_bias`
    (the key's bias is zero), and the `proj` output."""

    def __init__(self, width: int, num_heads: int):
        super().__init__(num_heads)
        self.qkv = nn.Linear(width, 3 * width, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(width))
        self.v_bias = nn.Parameter(torch.zeros(width))
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias]).to(x.dtype)
        qkv = F.linear(x, self.qkv.weight.to(x.dtype), bias)
        return linear(self.attend(qkv), self.proj)


class EvaViT(nn.Module):
    def __init__(self, cfg: EvaViTConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.patch_embed = PatchEmbed(cfg.width, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_tokens, cfg.width))
        self.blocks = nn.ModuleList(
            Block(cfg.width, cfg.heads, cfg.mlp_ratio, EvaAttention)
            for _ in range(cfg.layers))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, 1+P, width) token features (no final LN)."""
        dt = self.dtype
        x = self.patch_embed(images.to(dt))
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        return run_blocks(self.blocks, x, remat=self.remat)
