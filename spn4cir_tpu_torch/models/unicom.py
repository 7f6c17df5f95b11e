"""Unicom vision transformer (DeepGlint) in PyTorch: the SRM matcher's image
encoder.

Counterpart of `spn4cir_tpu/models/unicom.py` (parity target:
`zscir/unicom/vision_transformer.py:9-205`): a timm-style pre-LN ViT with no
class token, a qkv projection WITHOUT bias, a ReLU6 MLP, LayerNorm eps 1e-5,
a final LayerNorm over all patch tokens in float32, and a feature head over
the token-major concatenation of the patch tokens:
  Linear(P*dim -> dim, no bias) -> BatchNorm1d(eps 2e-5)
  -> Linear(dim -> embedding, no bias) -> BatchNorm1d(eps 2e-5),
the BatchNorms always from their running statistics (inference mode, as the
JAX package computes them).

Parameter names are the reference checkpoint's timm names
(`patch_embed.proj`, `pos_embed` (1, P, dim), `blocks.{i}.norm1 / attn.qkv
/ attn.proj / norm2 / mlp.fc1 / mlp.fc2`, `norm`, `feature.{0,1,2,3}`), so
a Unicom state dict, its DDP `module.` prefix stripped
(`models.convert.load_unicom_checkpoint`), loads with strict
`load_state_dict`.

Attention runs in float32 whatever the activation dtype, as the reference
forces `.float()` there (`unicom.py:89-95`): q, k and v are cast to float32
before the shared core (`models.layers.SelfAttention.attend`), which at
S = 256 sends the maskless attention to `long_attention` (kernel #3) and its
float32 kernel on a CUDA tensor; a bf16-built tower never takes the bf16
route. At ViT-L/14 the head's first weight alone is 256*1024 x 1024 =
268 M parameters (1.07 GB of float32).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from spn4cir_tpu_torch.models.blip_vit import PatchEmbed
from spn4cir_tpu_torch.models.layers import (LayerNorm, SelfAttention, linear,
                                             run_blocks)

LN_EPS = 1e-5
BN_EPS = 2e-5


@dataclasses.dataclass(frozen=True)
class UnicomConfig:
    input_size: int = 224
    patch_size: int = 14
    dim: int = 1024
    embedding_size: int = 768
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4

    @property
    def num_patches(self) -> int:
        return (self.input_size // self.patch_size) ** 2

    @classmethod
    def vit_l14(cls) -> "UnicomConfig":
        return cls()

    @classmethod
    def vit_b32(cls) -> "UnicomConfig":
        return cls(patch_size=32, dim=768, embedding_size=512, depth=12,
                   num_heads=12)

    @classmethod
    def vit_b16(cls) -> "UnicomConfig":
        return cls(patch_size=16, dim=768, embedding_size=768, depth=12,
                   num_heads=12)

    @classmethod
    def tiny(cls) -> "UnicomConfig":
        return cls(input_size=28, patch_size=14, dim=32, embedding_size=16,
                   depth=2, num_heads=2)


class Attention(SelfAttention):
    """timm's attention with a bias-free `qkv` and the `proj` output; the
    attention itself in float32, its output cast back for `proj`."""

    def __init__(self, width: int, num_heads: int):
        super().__init__(num_heads)
        self.qkv = nn.Linear(width, 3 * width, bias=False)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ctx = self.attend(linear(x, self.qkv).float())
        return linear(ctx.to(x.dtype), self.proj)


class Mlp(nn.Module):
    def __init__(self, width: int, mult: int):
        super().__init__()
        self.fc1 = nn.Linear(width, width * mult)
        self.fc2 = nn.Linear(width * mult, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.relu6(linear(x, self.fc1)), self.fc2)


class Block(nn.Module):
    def __init__(self, cfg: UnicomConfig):
        super().__init__()
        self.norm1 = LayerNorm(cfg.dim, eps=LN_EPS)
        self.attn = Attention(cfg.dim, cfg.num_heads)
        self.norm2 = LayerNorm(cfg.dim, eps=LN_EPS)
        self.mlp = Mlp(cfg.dim, cfg.mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def _batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm1d) -> torch.Tensor:
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, training=False, eps=bn.eps)


class UnicomViT(nn.Module):
    """Images (B, H, W, 3) -> feature embeddings (B, embedding_size), in
    float32. Parameters are float32; the blocks compute in `dtype`."""

    def __init__(self, cfg: UnicomConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.patch_embed = PatchEmbed(cfg.dim, cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches, cfg.dim))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(cfg.dim, eps=LN_EPS)
        self.feature = nn.Sequential(
            nn.Linear(cfg.dim * cfg.num_patches, cfg.dim, bias=False),
            nn.BatchNorm1d(cfg.dim, eps=BN_EPS),
            nn.Linear(cfg.dim, cfg.embedding_size, bias=False),
            nn.BatchNorm1d(cfg.embedding_size, eps=BN_EPS))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = self.patch_embed(images.to(dt)) + self.pos_embed.to(dt)
        x = self.norm(run_blocks(self.blocks, x).float())
        fc1, bn1, fc2, bn2 = self.feature
        x = _batch_norm_eval(F.linear(x.flatten(1), fc1.weight), bn1)
        return _batch_norm_eval(F.linear(x, fc2.weight), bn2)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights drawn on `generator`'s device: fan-in normal for
        the matrices, 0.02 for the positions, zero biases, unit LayerNorm
        and BatchNorm scales; the running statistics stay at mean 0, var
        1."""
        def draw(shape, std):
            return torch.randn(shape, generator=generator,
                               device=generator.device) * std

        for name, p in self.named_parameters():
            if name == "pos_embed":
                p.copy_(draw(p.shape, 0.02))
            elif p.dim() >= 2:
                p.copy_(draw(p.shape, p[0].numel() ** -0.5))
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
