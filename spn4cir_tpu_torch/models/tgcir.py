"""tgcir backbone: CLIP ViT-B/16 + token learners, global masks and a gated
token-set fusion.

Counterpart of `spn4cir_tpu/models/tgcir.py`. An image and a caption each
become a set of 12 tokens of width 512: 4 global tokens (the pooled,
projected CLIP feature times 4 learned ReLU'd masks) and 8 local tokens
(a token learner over the tower's token sequence after a linear map to
512). The fusion blends the reference image's set with the caption's by a
per-token sigmoid gate, averages the 12 tokens in float32 and normalizes.

`TGCIRModule` keeps the reference checkpoint's names where the layout
allows (`clip.*`, `fc`, `text_fc`, `masks.weight`, `masks_text.weight`);
the reference's S separate Conv1d(D -> 1) token-learner slots are one
Linear(D -> S) here (`tokenlearn.attn`, `tokenlearn_text.attn`), and its
gate `s_remain_map.{0,2}` is `s_remain.fc{1,2}`
(`models.convert.load_tgcir_checkpoint` maps them).

The towers' attention goes through the kernel wrappers as in clip4cir:
ViT-B/16 at 224 has S = 197 (`long_attention`), the text S = 77
(`short_attention`); the stage-2 loss runs through `bank_infonce`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spn4cir_tpu_torch.models.api import BankSpec, CIRBackbone, register_backbone
from spn4cir_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, CLIPConfig
from spn4cir_tpu_torch.models.layers import linear
from spn4cir_tpu_torch.ops import infonce
from spn4cir_tpu_torch.ops.bank_kernels import bank_infonce
from spn4cir_tpu_torch.ops.infonce import l2_normalize
from spn4cir_tpu_torch.tokenizer.bpe import ClipTokenizer, tokenize

LOCAL_TOKENS = 8
GLOBAL_TOKENS = 4
#: the image branch, frozen in stage 2 (with `clip.visual`)
FROZEN_ROOTS = ("fc", "tokenlearn", "masks")


class TokenLearner(nn.Module):
    """S spatial-attention tokens: w = sigmoid(Linear(D -> S)(x)), token_s =
    sum_l w[l, s] x[l] / L over all L positions (padding included)."""

    def __init__(self, dim: int, num_tokens: int = LOCAL_TOKENS):
        super().__init__()
        self.attn = nn.Linear(dim, num_tokens)

    def forward(self, x: torch.Tensor) -> torch.Tensor:     # (B, L, D)
        weights = torch.sigmoid(linear(x, self.attn))        # (B, L, S)
        return torch.einsum("bls,bld->bsd", weights, x) / x.shape[1]


class GlobalMasks(nn.Module):
    """G learned masks over the pooled feature: relu(weight), in the pooled
    feature's dtype, times the feature -> (B, G, D)."""

    def __init__(self, num_tokens: int = GLOBAL_TOKENS, dim: int = 512):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_tokens, dim))

    @staticmethod
    def striped(num_tokens: int, dim: int) -> np.ndarray:
        """The reference's init: 0.1 everywhere, 1.0 on the i-th of G equal
        stripes of row i."""
        arr = np.full((num_tokens, dim), 0.1, np.float32)
        seg = dim // num_tokens
        for i in range(num_tokens):
            arr[i, i * seg:(i + 1) * seg] = 1.0
        return arr

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:  # (B, D)
        masks = F.relu(self.weight).to(pooled.dtype)
        return pooled[:, None, :] * masks[None]


class GateMLP(nn.Module):
    """sigmoid(fc2(relu(fc1(cat[a, b])))), one gate per token."""

    def __init__(self, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(2 * hidden, hidden)
        self.fc2 = nn.Linear(hidden, 1)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        h = linear(torch.cat([a, b], dim=-1).to(self.dtype), self.fc1)
        return torch.sigmoid(linear(F.relu(h), self.fc2))


class TGCIRModule(nn.Module):
    def __init__(self, cfg: CLIPConfig, local_tokens: int = LOCAL_TOKENS,
                 global_tokens: int = GLOBAL_TOKENS,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        if not cfg.is_vit:
            raise ValueError("tgcir reads a ViT tower's token sequence")
        hidden = cfg.embed_dim
        self.dtype = dtype
        self.clip = CLIP(cfg, dtype=dtype, remat=remat)
        self.fc = nn.Linear(cfg.vision_width, hidden)
        self.text_fc = nn.Linear(cfg.transformer_width, hidden)
        self.tokenlearn = TokenLearner(hidden, local_tokens)
        self.tokenlearn_text = TokenLearner(hidden, local_tokens)
        self.masks = GlobalMasks(global_tokens, hidden)
        self.masks_text = GlobalMasks(global_tokens, hidden)
        self.s_remain = GateMLP(hidden, dtype)

    def extract_img_fea(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> the (B, G+S, D) token set of the image."""
        pooled, tokens = self.clip.encode_image(images, return_tokens=True)
        local = self.tokenlearn(linear(tokens, self.fc))
        return torch.cat([self.masks(pooled), local], dim=1)

    def extract_text_fea(self, text_ids: torch.Tensor) -> torch.Tensor:
        """(B, L) ids -> the (B, G+S, D) token set of the caption."""
        pooled, tokens = self.clip.encode_text(text_ids, return_tokens=True)
        local = self.tokenlearn_text(linear(tokens, self.text_fc))
        return torch.cat([self.masks_text(pooled), local], dim=1)

    def img_txt_fusion(self, ref_tokens: torch.Tensor, text_ids: torch.Tensor
                       ) -> torch.Tensor:
        """Gate-blend the reference and caption token sets, average the
        tokens in float32, normalize -> (B, D) float32 queries."""
        mod_tokens = self.extract_text_fea(text_ids)
        remain = self.s_remain(ref_tokens, mod_tokens)        # (B, T, 1)
        fused = remain * ref_tokens + (1.0 - remain) * mod_tokens
        return l2_normalize(fused.float().mean(dim=1))

    def forward(self, images: torch.Tensor, text_ids: torch.Tensor
                ) -> torch.Tensor:
        return self.img_txt_fusion(self.extract_img_fea(images), text_ids)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """CLIP's random weights (`CLIP.init_weights`), fan-in normal
        weights and zero biases for the heads, the striped masks."""
        self.clip.init_weights(generator)
        for lin in (self.fc, self.text_fc, self.tokenlearn.attn,
                    self.tokenlearn_text.attn, self.s_remain.fc1,
                    self.s_remain.fc2):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=generator)
                             * lin.in_features ** -0.5)
            lin.bias.zero_()
        for masks in (self.masks, self.masks_text):
            masks.weight.copy_(torch.from_numpy(
                GlobalMasks.striped(*masks.weight.shape)))


@register_backbone("tgcir")
class TgcirCIR(CIRBackbone):
    name = "tgcir"
    # the published FIQ eval ranks the FULL gallery for this backbone
    fiq_exclude_reference = False
    extend_suffix = "tgcir"
    default_transform = "targetpad"
    has_stage1 = False
    # gallery features are (12, 512) token sets; the target bank holds the
    # pooled (512,) rows
    gallery_extends_target_bank = False

    def __init__(self, clip_model_name: str = "ViT-B/16", tau: float = 0.02,
                 dtype: torch.dtype = torch.float32, device="cpu",
                 tokenizer: ClipTokenizer | None = None,
                 remat: bool = False):
        super().__init__()
        self.clip_model_name = clip_model_name
        self.tau = tau
        self.dtype = dtype
        self.tokenizer = tokenizer
        self.cfg = CLIP_CONFIGS[clip_model_name]
        with torch.device(device):
            self.model = TGCIRModule(self.cfg, dtype=dtype, remat=remat)
        self.input_dim = self.cfg.image_resolution
        self.hidden = self.cfg.embed_dim
        self.num_tokens = LOCAL_TOKENS + GLOBAL_TOKENS

    # ---- construction ----
    def init_params(self, generator: torch.Generator) -> None:
        self.model.init_weights(generator)

    def bank_spec(self) -> BankSpec:
        return BankSpec((self.num_tokens, self.hidden), (self.hidden,))

    # ---- encoders ----
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.model.extract_img_fea(images)

    def gallery_features(self, images: torch.Tensor) -> torch.Tensor:
        """The raw (B, 12, D) token sets: eval fuses from these and scores
        against their pooled form (`index_features`)."""
        return self.encode_image(images)

    def bank_features(self, images: torch.Tensor):
        tokens = self.encode_image(images)
        return tokens, l2_normalize(tokens.float().mean(dim=1))

    def index_features(self, images: torch.Tensor):
        """Raw token sets for the fusion, pooled and normalized for
        scoring."""
        tokens, pooled = self.bank_features(images)
        return {"target": pooled, "refer": tokens}

    def encode_text(self, text_ids: torch.Tensor) -> torch.Tensor:
        return self.model.extract_text_fea(text_ids)

    # ---- fusion ----
    def fuse(self, refer_feats: torch.Tensor, text_ids: torch.Tensor
             ) -> torch.Tensor:
        return self.model.img_txt_fusion(refer_feats, text_ids)

    # ---- losses ----
    def stage1_loss(self, images_refer, images_target, text_ids):
        raise NotImplementedError(
            "tgcir has no stage-1 loss (nor has the JAX package's backbone)")

    def stage2_loss(self, refer_feats: torch.Tensor, text_ids: torch.Tensor,
                    target_bank, labels: torch.Tensor, *,
                    neg_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        query = self.fuse(refer_feats, text_ids)
        if neg_idx is not None:
            return infonce.sampled_neg_infonce(query, target_bank, labels,
                                               neg_idx, self.tau)
        return bank_infonce(query, target_bank, labels, self.tau)

    # ---- host helpers ----
    def tokenize(self, texts):
        return tokenize(texts, context_length=self.cfg.context_length,
                        truncate=True, tokenizer=self.tokenizer)

    # ---- trainability ----
    def trainable_filter(self, name: str) -> bool:
        """Stage 2 freezes the image branch: `clip.visual`, `fc`,
        `tokenlearn` and `masks`. Only the top-level name is matched, so
        `tokenlearn_text` and `masks_text` train."""
        parts = name.split(".")
        if parts[0] == "model":
            parts = parts[1:]
        if not parts:
            return True
        if parts[0] in FROZEN_ROOTS:
            return False
        return parts[:2] != ["clip", "visual"]

    @staticmethod
    def init_stage2(model: TGCIRModule) -> TGCIRModule:
        """Stage-2 surgery: the (trained) image branch's token learner and
        masks copied into the text branch's parameters, in place (the
        text branch keeps its own tensors). No entry point calls it, as in
        the JAX package's CLI."""
        model.tokenlearn_text.load_state_dict(model.tokenlearn.state_dict())
        model.masks_text.load_state_dict(model.masks.state_dict())
        return model
