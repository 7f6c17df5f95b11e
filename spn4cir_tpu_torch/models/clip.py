"""CLIP in PyTorch: the ViT and ModifiedResNet image towers and the causal
text transformer.

Counterpart of `spn4cir_tpu/models/clip.py`. Parameter names are OpenAI
CLIP's (`visual.conv1.weight`, `visual.transformer.resblocks.{i}.*` for a
ViT; `visual.conv{1..3}`, `visual.bn{1..3}`,
`visual.layer{s}.{b}.conv/bn{1..3}`, `.downsample.0` / `.downsample.1`,
`visual.attnpool.{q,k,v,c}_proj` for a ResNet; `token_embedding.weight`,
`transformer.resblocks.{i}.*`, `ln_final.*`, `text_projection`,
`logit_scale`), so an OpenAI or clip4cir checkpoint loads with
`load_state_dict`. OpenAI keeps the text tower's parameters at the top
level of the model; here `CLIP` therefore extends `TextTransformer` and adds
the `visual` tower and `logit_scale`.

Images enter NHWC `(B, H, W, 3)` as in the JAX package. Parameters are
float32; activations run in `dtype`. The ResNet tower permutes to NCHW at
its entry, which makes a channels-last view of the NHWC batch without a
copy, and always normalises with the running statistics: the image tower is
frozen in stage 2, and in stage 1 the BatchNorms run on their stored
statistics while their affine parameters train, as in the JAX package
(`train/stage1.py`).
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from spn4cir_tpu_torch.models.layers import LayerNorm, Transformer, linear


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
    # tiny tgcir config for tests, the JAX package's: ViT-B/16's widths (the
    # reference TG-CIR hardcodes fc 768 -> 512 and 512-d tokens) at two
    # layers and 32 px
    "test-tgcir": CLIPConfig(
        512, 32, 2, 768, 16, context_length=77,
        transformer_width=512, transformer_heads=8, transformer_layers=2,
    ),
}


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
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
                                       cfg.vision_heads, remat=remat)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, cfg.embed_dim))

    def forward(self, images: torch.Tensor, return_tokens: bool = False):
        """images: (B, H, W, 3) normalized float -> (B, embed_dim); with
        `return_tokens` also the token sequence (B, 1+P, width) after the
        transformer and before ln_post (tgcir's heads read it)."""
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
        pooled = self.ln_post(x[:, 0, :]) @ self.proj.to(dt)
        return (pooled, x) if return_tokens else pooled


class _BatchNorm(nn.BatchNorm2d):
    """BatchNorm over the running statistics, computed in float32 and cast
    back to the input dtype (eps 1e-5). It keeps `nn.BatchNorm2d`'s
    parameters and buffers (`num_batches_tracked` included), so a reference
    checkpoint loads strictly, and never updates the statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0,
                            self.eps).to(x.dtype)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """`conv` (bias-free) applied in the dtype of `x`."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding)


class Bottleneck(nn.Module):
    """Anti-aliased bottleneck: a stride is an average pool after conv2,
    and the downsample path pools before its 1x1 convolution."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _BatchNorm(planes)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = _BatchNorm(out_ch)
        self.downsample = None
        if stride > 1 or inplanes != out_ch:
            # OpenAI's keys: the pool under "-1", the convolution "0", the
            # norm "1" (a stride-1 AvgPool2d is the identity)
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride)),
                ("0", nn.Conv2d(inplanes, out_ch, 1, bias=False)),
                ("1", _BatchNorm(out_ch))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(x, self.conv1)))
        y = F.relu(self.bn2(_conv(y, self.conv2)))
        y = self.bn3(_conv(self.avgpool(y), self.conv3))
        if self.downsample is not None:
            pool, conv, bn = self.downsample
            x = bn(_conv(pool(x), conv))
        return F.relu(y + x)


class AttentionPool2d(nn.Module):
    """QKV attention pool over the spatial positions with a learned
    positional embedding; the query is the mean token alone. q is scaled by
    head_dim ** -0.5 after its projection and bias; logits and softmax are
    float32 and the weights are cast back to the activation dtype.

    Plain PyTorch, not `short_attention`: the JAX package computes this pool
    as an einsum outside any Pallas kernel, and with one query row per
    (image, head) slice there is no S x S tile for that kernel to fuse."""

    def __init__(self, spatial: int, width: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.empty(spatial ** 2 + 1, width))
        self.k_proj = nn.Linear(width, width)
        self.q_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.c_proj = nn.Linear(width, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) -> (B, output_dim)."""
        b, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)                # (B, HW, C)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(x.dtype)
        h, hd = self.num_heads, c // self.num_heads
        q = linear(tokens[:, :1], self.q_proj).view(b, 1, h, hd) * hd ** -0.5
        k = linear(tokens, self.k_proj).view(b, -1, h, hd)
        v = linear(tokens, self.v_proj).view(b, -1, h, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, c)
        return linear(out, self.c_proj)


class ModifiedResNet(nn.Module):
    """CLIP's ResNet image tower (RN50x4): a 3-convolution stem with an
    average pool, four stages of anti-aliased bottlenecks, and an attention
    pool in place of the global average."""

    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        # `remat` is accepted for interface parity: the conv tower keeps its
        # activations
        super().__init__()
        width = cfg.vision_width
        self.cfg = cfg
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1,
                               bias=False)
        self.bn1 = _BatchNorm(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1,
                               bias=False)
        self.bn2 = _BatchNorm(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = _BatchNorm(width)
        self.avgpool = nn.AvgPool2d(2)
        inplanes = width
        for stage, blocks in enumerate(cfg.vision_layers):
            planes = width * 2 ** stage
            layer = []
            for blk in range(blocks):
                stride = 2 if (blk == 0 and stage > 0) else 1
                layer.append(Bottleneck(inplanes, planes, stride))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.attnpool = AttentionPool2d(cfg.image_resolution // 32, inplanes,
                                        cfg.vision_heads, cfg.embed_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) normalized float -> (B, embed_dim)."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = F.relu(bn(_conv(x, conv)))
        x = self.avgpool(x)
        for stage in range(len(self.cfg.vision_layers)):
            x = getattr(self, f"layer{stage + 1}")(x)
        return self.attnpool(x)


class TextTransformer(nn.Module):
    """The causal text tower; pooled at the EOT token (argmax of the ids)."""

    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        tw = cfg.transformer_width
        self.cfg = cfg
        self.dtype = dtype
        self.token_embedding = nn.Embedding(cfg.vocab_size, tw)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, tw))
        self.transformer = Transformer(tw, cfg.transformer_layers,
                                       cfg.transformer_heads, causal=True,
                                       remat=remat)
        self.ln_final = LayerNorm(tw)
        self.text_projection = nn.Parameter(torch.empty(tw, cfg.embed_dim))

    def encode_text(self, text_ids: torch.Tensor, return_tokens: bool = False):
        """text_ids: (B, context_length) integer ids -> (B, embed_dim); with
        `return_tokens` also every position's state after ln_final,
        (B, context_length, transformer_width)."""
        dt = self.dtype
        x = F.embedding(text_ids, self.token_embedding.weight).to(dt)
        x = x + self.positional_embedding.to(dt)[: x.shape[1]]
        x = self.ln_final(self.transformer(x))
        eot = text_ids.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        pooled = pooled @ self.text_projection.to(dt)
        return (pooled, x) if return_tokens else pooled

    def forward(self, text_ids: torch.Tensor) -> torch.Tensor:
        return self.encode_text(text_ids)


class CLIP(TextTransformer):
    """The dual encoder in OpenAI CLIP's parameter layout."""

    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__(cfg, dtype, remat)
        tower = VisionTransformer if cfg.is_vit else ModifiedResNet
        self.visual = tower(cfg, dtype, remat)
        self.logit_scale = nn.Parameter(torch.empty(()))

    def encode_image(self, images: torch.Tensor, return_tokens: bool = False):
        """`return_tokens` (a ViT tower's): also the token sequence."""
        if return_tokens:
            return self.visual(images, return_tokens=True)
        return self.visual(images)

    def forward(self, images: torch.Tensor, text_ids: torch.Tensor):
        return self.encode_image(images), self.encode_text(text_ids), \
            self.logit_scale

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` (a CPU generator), with the
        scales of the JAX package's initializers: fan-in normal for linear
        and conv weights, zero biases, unit LayerNorms and BatchNorms (with
        zero running means and unit running variances), width**-0.5 for the
        class/positional embeddings and projections, 0.02 and 0.01 for the
        token and text positional embeddings."""
        vw, tw = self.cfg.vision_width, self.cfg.transformer_width
        stds = {"token_embedding.weight": 0.02,
                "positional_embedding": 0.01,
                "text_projection": tw ** -0.5,
                "visual.class_embedding": vw ** -0.5,
                "visual.positional_embedding": vw ** -0.5,
                "visual.proj": vw ** -0.5}
        if not self.cfg.is_vit:
            pos = self.visual.attnpool.positional_embedding
            stds["visual.attnpool.positional_embedding"] = pos.shape[1] ** -0.5
            for m in self.visual.modules():
                if isinstance(m, _BatchNorm):
                    m.reset_running_stats()
        for name, p in self.named_parameters():
            if name == "logit_scale":
                p.fill_(math.log(1 / 0.07))
            elif name in stds or p.dim() >= 2:
                std = stds.get(name) or p[0].numel() ** -0.5  # fan-in
                p.copy_(torch.randn(p.shape, generator=generator) * std)
            elif name.endswith("weight"):  # the 1-D weights: the norms' scales
                p.fill_(1.0)
            else:
                p.zero_()


def build_clip(name: str, dtype: torch.dtype = torch.float32,
               remat: bool = False) -> CLIP:
    return CLIP(CLIP_CONFIGS[name], dtype=dtype, remat=remat)
