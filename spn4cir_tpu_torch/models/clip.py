"""CLIP in PyTorch: the ViT image tower and the causal text transformer.

Counterpart of `spn4cir_tpu/models/clip.py`. Parameter names are OpenAI
CLIP's (`visual.conv1.weight`, `visual.transformer.resblocks.{i}.*`,
`token_embedding.weight`, `transformer.resblocks.{i}.*`, `ln_final.*`,
`text_projection`, `logit_scale`), so an OpenAI or clip4cir checkpoint loads
with `load_state_dict`. OpenAI keeps the text tower's parameters at the top
level of the model; here `CLIP` therefore extends `TextTransformer` and adds
the `visual` tower and `logit_scale`.

Images enter NHWC `(B, H, W, 3)` as in the JAX package. Parameters are
float32; activations run in `dtype`. The ResNet towers (RN50x4) are not
ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from spn4cir_tpu_torch.models.layers import LayerNorm, Transformer


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    # vision
    image_resolution: int
    vision_layers: Any  # int (ViT) or tuple of 4 ints (ResNet)
    vision_width: int
    vision_patch_size: Optional[int]  # None => ModifiedResNet
    # text
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def is_vit(self) -> bool:
        return self.vision_patch_size is not None

    @property
    def vision_heads(self) -> int:
        return (self.vision_width // 64 if self.is_vit
                else self.vision_width * 32 // 64)


CLIP_CONFIGS = {
    "ViT-B/32": CLIPConfig(512, 224, 12, 768, 32),
    "ViT-B/16": CLIPConfig(512, 224, 12, 768, 16),
    "ViT-L/14": CLIPConfig(
        768, 224, 24, 1024, 14,
        transformer_width=768, transformer_heads=12, transformer_layers=12,
    ),
    "RN50x4": CLIPConfig(
        640, 288, (4, 6, 10, 6), 80, None,
        transformer_width=640, transformer_heads=10, transformer_layers=12,
    ),
    # tiny config for tests (not a released CLIP size)
    "test-tiny": CLIPConfig(
        32, 32, 2, 64, 16, context_length=77,
        transformer_width=32, transformer_heads=2, transformer_layers=2,
    ),
}


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        width, p = cfg.vision_width, cfg.vision_patch_size
        self.cfg = cfg
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, width, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty((cfg.image_resolution // p) ** 2 + 1, width))
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, cfg.vision_layers,
                                       cfg.vision_heads)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, cfg.embed_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) normalized float -> (B, embed_dim)."""
        dt = self.dtype
        b, h, w, c = images.shape
        p = self.cfg.vision_patch_size
        # the stride-p patch convolution as one matmul over flattened
        # (channel, row, column) patches: cuDNN's kernel for the permuted
        # NHWC input took ~11% of a ViT-B/32 bf16 encode at batch 256 on an
        # H100 80GB HBM3 at 700 W (PERF.md)
        patches = images.to(dt).reshape(b, h // p, p, w // p, p, c).permute(
            0, 1, 3, 5, 2, 4).reshape(b, (h // p) * (w // p), c * p * p)
        x = patches @ self.conv1.weight.to(dt).reshape(
            self.conv1.out_channels, -1).T                  # (B, P, width)
        cls = self.class_embedding.to(dt).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0, :]) @ self.proj.to(dt)


class TextTransformer(nn.Module):
    """The causal text tower; pooled at the EOT token (argmax of the ids)."""

    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        tw = cfg.transformer_width
        self.cfg = cfg
        self.dtype = dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, tw)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, tw))
        self.transformer = Transformer(tw, cfg.transformer_layers,
                                       cfg.transformer_heads, causal=True)
        self.ln_final = LayerNorm(tw)
        self.text_projection = nn.Parameter(torch.empty(tw, cfg.embed_dim))

    def encode_text(self, text_ids: torch.Tensor) -> torch.Tensor:
        """text_ids: (B, context_length) integer ids -> (B, embed_dim)."""
        dt = self.dtype
        x = F.embedding(text_ids, self.token_embedding.weight).to(dt)
        x = x + self.positional_embedding.to(dt)[: x.shape[1]]
        x = self.ln_final(self.transformer(x))
        eot = text_ids.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection.to(dt)

    def forward(self, text_ids: torch.Tensor) -> torch.Tensor:
        return self.encode_text(text_ids)


class CLIP(TextTransformer):
    """The dual encoder in OpenAI CLIP's parameter layout."""

    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32):
        if not cfg.is_vit:
            raise NotImplementedError(
                "the ResNet CLIP towers (--clip-model-name RN50x4) are not "
                "yet ported to PyTorch; use a ViT model (ViT-B/32, ViT-B/16, "
                "ViT-L/14)")
        super().__init__(cfg, dtype)
        self.visual = VisionTransformer(cfg, dtype)
        self.logit_scale = nn.Parameter(torch.empty(()))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def forward(self, images: torch.Tensor, text_ids: torch.Tensor):
        return self.encode_image(images), self.encode_text(text_ids), \
            self.logit_scale

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` (a CPU generator), with the
        scales of the JAX package's initializers: fan-in normal for linear
        and conv weights, zero biases, unit LayerNorms, width**-0.5 for the
        class/positional embeddings and projections, 0.02 and 0.01 for the
        token and text positional embeddings."""
        vw, tw = self.cfg.vision_width, self.cfg.transformer_width
        stds = {"token_embedding.weight": 0.02,
                "positional_embedding": 0.01,
                "text_projection": tw ** -0.5,
                "visual.class_embedding": vw ** -0.5,
                "visual.positional_embedding": vw ** -0.5,
                "visual.proj": vw ** -0.5}
        for name, p in self.named_parameters():
            if name == "logit_scale":
                p.fill_(math.log(1 / 0.07))
            elif name in stds or p.dim() >= 2:
                std = stds.get(name) or p[0].numel() ** -0.5  # fan-in
                p.copy_(torch.randn(p.shape, generator=generator) * std)
            elif name.endswith("weight"):  # the only 1-D weights: LayerNorm
                p.fill_(1.0)
            else:
                p.zero_()


def build_clip(name: str, dtype: torch.dtype = torch.float32) -> CLIP:
    return CLIP(CLIP_CONFIGS[name], dtype=dtype)
