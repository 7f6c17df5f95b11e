"""BLIP's timm-style ViT in PyTorch (exact GELU, LN eps 1e-6, no projection).

Counterpart of `spn4cir_tpu/models/blip_vit.py`: 'base' = ViT-B/16 at 384
pixels -> (B, 577, 768) token embeddings after the final LayerNorm.
Parameter names are those of the BLIP checkpoint (`patch_embed.proj`,
`cls_token` (1, 1, D), `pos_embed` (1, T, D),
`blocks.{i}.norm1 / attn.qkv / attn.proj / norm2 / mlp.fc1 / mlp.fc2`,
`norm`), so its state dict loads with `load_state_dict` directly.

Images enter NHWC `(B, H, W, 3)`. Parameters are float32; activations run
in `dtype`. The maskless attention at S=577 goes through `long_attention`
(`models/layers.SelfAttention`). `remat=True` (`--grad_ckpt`) runs each
block's forward again in the backward instead of keeping its activations.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from spn4cir_tpu_torch.models.layers import (LayerNorm, SelfAttention, gelu,
                                             linear, run_blocks)

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class BlipViTConfig:
    image_size: int = 384
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12

    @classmethod
    def base(cls) -> "BlipViTConfig":
        return cls()

    @classmethod
    def large(cls) -> "BlipViTConfig":
        return cls(image_size=384, patch_size=16, width=1024, layers=24,
                   heads=16)

    @classmethod
    def tiny(cls) -> "BlipViTConfig":
        return cls(image_size=32, patch_size=16, width=32, layers=2, heads=2)

    @property
    def num_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


class Attention(SelfAttention):
    """timm's attention: a fused `qkv` Linear and the `proj` output."""

    def __init__(self, width: int, num_heads: int):
        super().__init__(num_heads)
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.attend(linear(x, self.qkv)), self.proj)


class Mlp(nn.Module):
    def __init__(self, width: int, mult: float = 4.0):
        super().__init__()
        self.fc1 = nn.Linear(width, int(width * mult))
        self.fc2 = nn.Linear(int(width * mult), width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(gelu(linear(x, self.fc1)), self.fc2)


class Block(nn.Module):
    """Pre-LN block, the shape of the CLIP block with exact GELU and LN eps
    1e-6. EVA's block (`models/eva_vit.py`) is this one with its own
    attention class and MLP ratio."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: float = 4.0,
                 attention: type = Attention):
        super().__init__()
        self.norm1 = LayerNorm(width, eps=LN_EPS)
        self.attn = attention(width, num_heads)
        self.norm2 = LayerNorm(width, eps=LN_EPS)
        self.mlp = Mlp(width, mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """The stride-p patch convolution (with bias), held as `proj` under the
    checkpoint's name and applied as one matmul over flattened (channel,
    row, column) patches: the weight is OIHW, so its rows flatten in that
    order (the JAX kernel is HWIO; `models/convert.py` transposes)."""

    def __init__(self, width: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, width, patch, stride=patch)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, h, w, c = images.shape
        p = self.proj.kernel_size[0]
        patches = images.reshape(b, h // p, p, w // p, p, c).permute(
            0, 1, 3, 5, 2, 4).reshape(b, (h // p) * (w // p), c * p * p)
        weight = self.proj.weight.to(images.dtype).reshape(
            self.proj.out_channels, -1)
        return patches @ weight.T + self.proj.bias.to(images.dtype)


class BlipViT(nn.Module):
    def __init__(self, cfg: BlipViTConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.patch_embed = PatchEmbed(cfg.width, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.num_tokens, cfg.width))
        self.blocks = nn.ModuleList(Block(cfg.width, cfg.heads)
                                    for _ in range(cfg.layers))
        self.norm = LayerNorm(cfg.width, eps=LN_EPS)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, 1+P, width) token embeddings after the final
        LayerNorm."""
        dt = self.dtype
        x = self.patch_embed(images.to(dt))
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        return self.norm(run_blocks(self.blocks, x, remat=self.remat))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` (a CPU generator): fan-in normal
        for the matrices, 0.02 for the class token and the positions, zero
        biases, unit LayerNorms."""
        for name, p in self.named_parameters():
            if name in ("cls_token", "pos_embed"):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
            elif p.dim() >= 2:
                std = p[0].numel() ** -0.5
                p.copy_(torch.randn(p.shape, generator=generator) * std)
            elif "norm" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
