"""blip4cir backbone: BLIP ViT + MED BERT cross-attention fusion.

Counterpart of `spn4cir_tpu/models/blip4cir.py` (parity targets:
`BLIP_Retrieval` with the enc-token swap and the 768 -> 256 projections,
and `CIRPlus` with its learnable tau and token-shaped banks: refer
(577, 768) raw ViT tokens, target (256,) pooled). `BlipCirModule` keeps the
checkpoint's names (`visual_encoder.*`, `text_encoder.*`, `vision_proj`,
`text_proj`, `tau`).

The ViT's attention runs through `long_attention` (S=577); MED's attention
is plain tensor code (padding masks); the stage-2 loss runs through
`bank_infonce` with the learnable `tau` as a 0-d tensor that takes a
gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from spn4cir_tpu_torch.models.api import BankSpec, CIRBackbone, register_backbone
from spn4cir_tpu_torch.models.blip_vit import BlipViT, BlipViTConfig
from spn4cir_tpu_torch.models.layers import linear
from spn4cir_tpu_torch.models.med import MedBert, MedConfig
from spn4cir_tpu_torch.ops import infonce
from spn4cir_tpu_torch.ops.bank_kernels import bank_infonce
from spn4cir_tpu_torch.ops.infonce import l2_normalize
from spn4cir_tpu_torch.tokenizer.wordpiece import BertTokenizer, tiny_test_vocab
from spn4cir_tpu_torch.utils.logging import span

EMBED_DIM = 256
TEXT_MAX_LEN = 35  # BLIP4CIR tokenizes with padding='longest'; 35 covers CIR


class BlipCirModule(nn.Module):
    def __init__(self, vit_cfg: BlipViTConfig, med_cfg: MedConfig,
                 embed_dim: int = EMBED_DIM, tau_init: float = 0.03,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.tau_init = tau_init
        self.visual_encoder = BlipViT(vit_cfg, dtype, remat)
        self.text_encoder = MedBert(med_cfg, dtype)
        self.vision_proj = nn.Linear(vit_cfg.width, embed_dim)
        self.text_proj = nn.Linear(med_cfg.hidden_size, embed_dim)
        # the learnable temperature
        self.tau = nn.Parameter(torch.empty(()))

    def img_embed(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> raw ViT tokens (B, 577, 768)."""
        return self.visual_encoder(images)

    def img_pooled(self, tokens: torch.Tensor) -> torch.Tensor:
        """CLS token -> vision_proj -> normalize."""
        return l2_normalize(
            linear(tokens[:, 0, :].to(self.dtype), self.vision_proj).float())

    def text_only(self, input_ids, attention_mask) -> torch.Tensor:
        """Self-attention-only text feature (no cross-attention), CLS ->
        text_proj."""
        hidden = self.text_encoder(input_ids, attention_mask=attention_mask)
        return l2_normalize(linear(hidden[:, 0, :], self.text_proj).float())

    def img_txt_fusion(self, ref_tokens, input_ids, attention_mask,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """The text encoder cross-attends to the reference image tokens; CLS
        -> text_proj -> normalized query. `input_ids` must already carry
        the enc-token swap at position 0. Every image token is attended to
        (an all-ones image mask adds exact zeros to the logits, so none is
        built). In `train()` mode MED's dropout draws from `generator`."""
        hidden = self.text_encoder(
            input_ids, attention_mask=attention_mask,
            encoder_hidden_states=ref_tokens.to(self.dtype),
            generator=generator)
        return l2_normalize(linear(hidden[:, 0, :], self.text_proj).float())

    def forward(self, images, input_ids, attention_mask) -> torch.Tensor:
        return self.img_txt_fusion(self.img_embed(images), input_ids,
                                   attention_mask)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.visual_encoder.init_weights(generator)
        self.text_encoder.init_weights(generator)
        for proj in (self.vision_proj, self.text_proj):
            proj.weight.copy_(torch.randn(proj.weight.shape,
                                          generator=generator)
                              * proj.in_features ** -0.5)
            proj.bias.zero_()
        self.tau.fill_(self.tau_init)


@register_backbone("blip")
class BlipCIR(CIRBackbone):
    name = "blip"
    # the published FIQ eval ranks the FULL gallery for this backbone (no
    # reference-image filter)
    fiq_exclude_reference = False
    extend_suffix = "blip"

    def __init__(self, blip_size: str = "base", tau: float = 0.03,
                 dtype: torch.dtype = torch.float32, device="cpu",
                 remat: bool = False, bert_vocab_path: Optional[str] = None,
                 med_cfg: Optional[MedConfig] = None,
                 vit_cfg: Optional[BlipViTConfig] = None,
                 dropout: float = 0.0, text_max_len: int = TEXT_MAX_LEN,
                 tokenizer: Optional[BertTokenizer] = None):
        super().__init__()
        if vit_cfg is None:
            vit_cfg = (BlipViTConfig.tiny() if blip_size == "test-tiny"
                       else BlipViTConfig.large() if blip_size == "large"
                       else BlipViTConfig.base())
        if tokenizer is not None:
            self.tokenizer = tokenizer
        elif blip_size == "test-tiny":
            self.tokenizer = BertTokenizer(vocab=tiny_test_vocab())
        else:
            self.tokenizer = BertTokenizer(vocab_path=bert_vocab_path)
        if med_cfg is None:
            med_cfg = (MedConfig.tiny(self.tokenizer.vocab_size)
                       if blip_size == "test-tiny"
                       else MedConfig(vocab_size=self.tokenizer.vocab_size,
                                      encoder_width=vit_cfg.width))
        if dropout:
            med_cfg = dataclasses.replace(med_cfg, dropout_rate=dropout)
        self.vit_cfg = vit_cfg
        self.med_cfg = med_cfg
        self.dtype = dtype
        with torch.device(device):
            self.model = BlipCirModule(vit_cfg, med_cfg, EMBED_DIM, tau,
                                       dtype=dtype, remat=remat)
        self.input_dim = vit_cfg.image_size
        self.embed_dim = EMBED_DIM
        # the reference pads to the longest caption; a fixed length keeps
        # the batches' shapes equal: raise it for caption sets with more
        # than text_max_len - 2 WordPiece tokens
        self.text_max_len = text_max_len

    # ---- construction ----
    def init_params(self, generator: torch.Generator) -> None:
        self.model.init_weights(generator)

    def bank_spec(self) -> BankSpec:
        return BankSpec((self.vit_cfg.num_tokens, self.vit_cfg.width),
                        (EMBED_DIM,))

    # ---- encoders ----
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.model.img_embed(images)

    def gallery_features(self, images: torch.Tensor) -> torch.Tensor:
        return self.model.img_pooled(self.encode_image(images))

    def bank_features(self, images: torch.Tensor):
        with span("bank.encode"):
            with span("bank.encode.vision"):
                tokens = self.encode_image(images)
            return tokens, self.model.img_pooled(tokens)

    def index_features(self, images: torch.Tensor):
        """Raw ViT tokens for the cross-attention fusion, pooled and
        normalized (256-d) for scoring."""
        tokens, pooled = self.bank_features(images)
        return {"target": pooled, "refer": tokens}

    def encode_text(self, text_ids: torch.Tensor) -> torch.Tensor:
        """MED self-attention only, CLS -> text_proj (not part of the
        reference's surface; provided for completeness)."""
        return self.model.text_only(text_ids[:, 0, :], text_ids[:, 1, :])

    # ---- fusion ----
    def fuse(self, refer_feats: torch.Tensor, text_ids: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """In `train()` mode with a dropout rate, MED's dropout is live and
        draws from `generator`."""
        return self.model.img_txt_fusion(refer_feats, text_ids[:, 0, :],
                                         text_ids[:, 1, :],
                                         generator=generator)

    # ---- losses ----
    def stage1_loss(self, images_refer: torch.Tensor,
                    images_target: torch.Tensor, text_ids: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    gather: infonce.Gather = None) -> torch.Tensor:
        """End-to-end in-batch InfoNCE (`--wo_bank`): clip4cir's stage-1
        objective applied to the BLIP fusion. query = img_txt_fusion(live
        ViT tokens, text), target = pooled-normalized target features.
        `gather`: see `infonce.in_batch_infonce`."""
        refer_tokens = self.encode_image(images_refer)
        target = self.gallery_features(images_target)
        query = self.fuse(refer_tokens, text_ids, generator=generator)
        return infonce.in_batch_infonce(query, target, self.model.tau,
                                        gather)

    def stage2_loss(self, refer_feats: torch.Tensor, text_ids: torch.Tensor,
                    target_bank, labels: torch.Tensor, *,
                    neg_idx: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        query = self.fuse(refer_feats, text_ids, generator=generator)
        if neg_idx is not None:
            return infonce.sampled_neg_infonce(query, target_bank, labels,
                                               neg_idx, self.model.tau)
        return bank_infonce(query, target_bank, labels, self.model.tau)

    def loss_tau(self):
        return self.model.tau

    # ---- host helpers ----
    def tokenize(self, texts) -> np.ndarray:
        """A stacked (B, 2, L) int32 array: [input_ids; attention_mask] with
        the enc-token swap applied; one array keeps the backbone's
        tokenize -> device contract."""
        with span("text.tokenize"):
            ids, mask = self.tokenizer(texts, max_length=self.text_max_len,
                                       replace_cls_with_enc=True)
            return np.stack([ids, mask], axis=1)

    # ---- trainability ----
    def trainable_filter(self, name: str) -> bool:
        """Stage 2 freezes the ViT and vision_proj."""
        return not ({"visual_encoder", "vision_proj"} & set(name.split(".")))
