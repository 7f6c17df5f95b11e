"""blip24cir backbone: frozen EVA ViT-g + Q-Former with aligned prompts.

Counterpart of `spn4cir_tpu/models/blip24cir.py` (parity target: LAVIS
`Blip2QformerCirAlignPrompt`): the frozen EVA tower and its external
`ln_vision`, 32 learned query tokens, `vision_proj` / `text_proj` 768 -> 256,
and the stage-2 copies `Qformer_query` / `text_proj_q` that `init_stage2`
deep-copies from `Qformer` / `text_proj`; only those copies and the
temperature `temp` train. `Blip2CirModule` keeps the checkpoint's names.

The bank forms: the refer bank holds the 32 fused query states (32, 768) of
a (reference image, caption) pair, the target bank the per-image 32-query
features (32, 256). The stage-2 loss re-reads the text with `Qformer_query`
over the cached fused states, takes the CLS (position 32) through
`text_proj_q`, and scores every bank image by its best query
(`ops/maxquery_kernels.max_query_infonce`, kernels #9 and #10 on the card).

The EVA tower's attention runs through `long_attention` (S=257, head_dim
88); the Q-Former's is plain tensor code (padding masks).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch
from torch import nn

from spn4cir_tpu_torch.models.api import BankSpec, CIRBackbone, register_backbone
from spn4cir_tpu_torch.models.eva_vit import EvaViT, EvaViTConfig
from spn4cir_tpu_torch.models.layers import LayerNorm, linear
from spn4cir_tpu_torch.models.qformer import QFormer, QFormerConfig
from spn4cir_tpu_torch.ops import infonce
from spn4cir_tpu_torch.ops.infonce import l2_normalize
from spn4cir_tpu_torch.ops.maxquery_kernels import max_query_infonce
from spn4cir_tpu_torch.tokenizer.wordpiece import BertTokenizer, tiny_test_vocab
from spn4cir_tpu_torch.utils.logging import span

EMBED_DIM = 256
MAX_TXT_LEN = 32
#: the parameters that train in stage 2 (`init_stage2`), by their first name
STAGE2_TRAINABLE = ("Qformer_query", "text_proj_q", "temp")


class Blip2CirModule(nn.Module):
    def __init__(self, vit_cfg: EvaViTConfig, q_cfg: QFormerConfig,
                 embed_dim: int = EMBED_DIM, tau_init: float = 0.05,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.tau_init = tau_init
        self.visual_encoder = EvaViT(vit_cfg, dtype, remat)
        # the JAX package's epsilon (models/blip24cir.py:107)
        self.ln_vision = LayerNorm(vit_cfg.width, eps=1e-12)
        self.Qformer = QFormer(q_cfg, dtype)          # frozen in stage 2
        self.Qformer_query = QFormer(q_cfg, dtype)    # the trainable copy
        self.vision_proj = nn.Linear(q_cfg.hidden_size, embed_dim)
        self.text_proj = nn.Linear(q_cfg.hidden_size, embed_dim)
        self.text_proj_q = nn.Linear(q_cfg.hidden_size, embed_dim)
        shape = (1, q_cfg.num_query_tokens, q_cfg.hidden_size)
        self.query_tokens = nn.Parameter(torch.empty(shape))
        # learned in the reference's pretraining; no CIR path reads them
        self.prompt_tokens = nn.Parameter(torch.empty(shape))
        self.temp = nn.Parameter(torch.empty(()))

    def _queries(self, b: int) -> torch.Tensor:
        return self.query_tokens.expand(b, -1, -1)

    def image_embeds(self, images: torch.Tensor) -> torch.Tensor:
        """ln_vision(EVA(images)) -> (B, 257, 1408) frozen features."""
        return self.ln_vision(self.visual_encoder(images))

    def target_query_feats(self, image_embeds: torch.Tensor) -> torch.Tensor:
        """The query-only Q-Former read of an image -> normalized (B, 32,
        256). Every image token is attended to: an all-ones image mask adds
        exact zeros to the logits, so none is built."""
        hidden = self.Qformer(query_embeds=self._queries(image_embeds.shape[0]),
                              encoder_hidden_states=image_embeds)
        return l2_normalize(linear(hidden, self.vision_proj).float())

    def fusion_hidden(self, image_embeds, input_ids, attention_mask
                      ) -> torch.Tensor:
        """The fusion pass, text and queries cross-attending to the reference
        image: the 32 fused query states (B, 32, 768)."""
        b = image_embeds.shape[0]
        queries = self._queries(b)
        full_mask = torch.cat([torch.ones(b, queries.shape[1],
                                          dtype=attention_mask.dtype,
                                          device=attention_mask.device),
                               attention_mask], dim=1)
        hidden = self.Qformer(input_ids=input_ids, query_embeds=queries,
                              attention_mask=full_mask,
                              encoder_hidden_states=image_embeds)
        return hidden[:, : queries.shape[1], :]

    def fusion_feats_q(self, fusion_hidden_states, input_ids, attention_mask,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """The stage-2 text re-read with the trainable copy: the token at
        index 32 (the first text position, the CLS) -> text_proj_q ->
        normalize. In `train()` mode with a dropout rate its dropout draws
        from `generator`."""
        b, nq = fusion_hidden_states.shape[:2]
        full_mask = torch.cat([torch.ones(b, nq, dtype=attention_mask.dtype,
                                          device=attention_mask.device),
                               attention_mask], dim=1)
        hidden = self.Qformer_query(input_ids=input_ids,
                                    query_embeds=fusion_hidden_states,
                                    attention_mask=full_mask,
                                    generator=generator)
        return l2_normalize(linear(hidden[:, nq, :], self.text_proj_q).float())

    def inference_feats(self, image_embeds, input_ids, attention_mask,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """The eval path: the frozen fusion pass, then the re-read."""
        fused = self.fusion_hidden(image_embeds, input_ids, attention_mask)
        return self.fusion_feats_q(fused, input_ids, attention_mask, generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator`, a generator of the parameters'
        device (the 1.2 B parameters are drawn where they live): 0.02 for
        the tokens, the positions and the embedding tables, fan-in normal
        for the matrices, zero biases, unit LayerNorms, `temp` = tau."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("cls_token", "pos_embed", "query_tokens",
                        "prompt_tokens") or ("embeddings" in name
                                             and "LayerNorm" not in name):
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device) * 0.02)
            elif p.dim() >= 2:
                std = p[0].numel() ** -0.5
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device) * std)
            elif re.search(r"(norm\d?|LayerNorm|ln_vision)\.weight$", name):
                p.fill_(1.0)
            else:
                p.zero_()
        self.temp.fill_(self.tau_init)


@register_backbone("blip2")
class Blip2CIR(CIRBackbone):
    name = "blip2"
    # the published FIQ eval ranks the FULL gallery for this backbone
    fiq_exclude_reference = False
    extend_suffix = "blip2"
    default_transform = "targetpad"
    caption_aware_bank = True
    has_stage1 = False

    def __init__(self, blip2_size: str = "pretrain", tau: float = 0.05,
                 dtype: torch.dtype = torch.float32, device="cpu",
                 remat: bool = False, bert_vocab_path: Optional[str] = None,
                 vit_cfg: Optional[EvaViTConfig] = None,
                 q_cfg: Optional[QFormerConfig] = None,
                 dropout: float = 0.0,
                 tokenizer: Optional[BertTokenizer] = None):
        super().__init__()
        if blip2_size not in ("pretrain", "test-tiny"):
            raise ValueError(f"blip2 comes in the sizes 'pretrain' (EVA ViT-g "
                             f"+ Q-Former) and 'test-tiny'; got {blip2_size!r}")
        tiny = blip2_size == "test-tiny"
        if tokenizer is not None:
            self.tokenizer = tokenizer
        elif tiny:
            self.tokenizer = BertTokenizer(vocab=tiny_test_vocab())
        else:
            self.tokenizer = BertTokenizer(vocab_path=bert_vocab_path)
        vit_cfg = vit_cfg or (EvaViTConfig.tiny() if tiny else EvaViTConfig())
        if q_cfg is None:
            q_cfg = (QFormerConfig.tiny(self.tokenizer.vocab_size) if tiny
                     else QFormerConfig(vocab_size=self.tokenizer.vocab_size,
                                        encoder_width=vit_cfg.width))
        if dropout:
            q_cfg = dataclasses.replace(q_cfg, dropout_rate=dropout)
        self.vit_cfg = vit_cfg
        self.q_cfg = q_cfg
        self.dtype = dtype
        with torch.device(device):
            self.model = Blip2CirModule(vit_cfg, q_cfg, EMBED_DIM, tau,
                                        dtype=dtype, remat=remat)
        self.input_dim = vit_cfg.image_size
        self.embed_dim = EMBED_DIM

    # ---- construction ----
    def init_params(self, generator: torch.Generator) -> None:
        """Random weights: a generator of the parameters' device, seeded
        from `generator` (a CPU generator), draws them in place."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        self.model.init_weights(
            torch.Generator(device=self.device).manual_seed(seed))

    def bank_spec(self) -> BankSpec:
        nq = self.q_cfg.num_query_tokens
        return BankSpec((nq, self.q_cfg.hidden_size), (nq, EMBED_DIM))

    # ---- encoders ----
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """Frozen ViT embeds (B, 257, 1408): the eval-side refer form."""
        return self.model.image_embeds(images)

    def gallery_features(self, images: torch.Tensor) -> torch.Tensor:
        return self.model.target_query_feats(self.encode_image(images))

    def index_features(self, images: torch.Tensor):
        """target = the (32, 256) query features scored by their best query;
        refer = the frozen ViT embeds the fusion reads."""
        embeds = self.encode_image(images)
        return {"target": self.model.target_query_feats(embeds),
                "refer": embeds}

    def encode_text(self, text_ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("blip2 has no fusion-free text path")

    # ---- fusion (eval path: refer = frozen ViT embeds) ----
    def fuse(self, refer_feats: torch.Tensor, text_ids: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.model.inference_feats(refer_feats, text_ids[:, 0, :],
                                          text_ids[:, 1, :], generator)

    def score_queries(self, query_feats: torch.Tensor, gallery: torch.Tensor
                      ) -> torch.Tensor:
        """Max over the 32 query features of each gallery image."""
        return infonce.max_query_scores(query_feats, gallery)

    # ---- bank extraction ----
    def bank_features(self, images: torch.Tensor):
        raise NotImplementedError(
            "blip2 refer-bank entries depend on (image, caption); use "
            "fusion_bank_features through the caption-aware extraction "
            "(bank.extract_fusion_banks)")

    def fusion_bank_features(self, images: torch.Tensor,
                             text_ids: torch.Tensor):
        """(fusion hidden states (B, 32, 768), target query features (B, 32,
        256)): the blip2 bank forms of one batch of (image, caption)."""
        with span("bank.encode"):
            with span("bank.encode.vision"):
                embeds = self.encode_image(images)
            with span("bank.encode.fusion"):
                fused = self.model.fusion_hidden(embeds, text_ids[:, 0, :],
                                                 text_ids[:, 1, :])
            with span("bank.encode.query"):
                return fused, self.model.target_query_feats(embeds)

    # ---- losses ----
    def stage1_loss(self, images_refer, images_target, text_ids):
        raise NotImplementedError(
            "blip2 has no stage-1 (--wo_bank) loss: the JAX package's "
            "backbone defines none")

    def stage2_query_feats(self, refer_feats: torch.Tensor,
                           text_ids: torch.Tensor,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        """The TRAINING fusion path: the Qformer_query re-read over cached
        fusion states (distinct from `fuse`, the inference path)."""
        return self.model.fusion_feats_q(refer_feats, text_ids[:, 0, :],
                                         text_ids[:, 1, :], generator)

    def stage2_loss(self, refer_feats: torch.Tensor, text_ids: torch.Tensor,
                    target_bank, labels: torch.Tensor, *,
                    neg_idx: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """refer_feats: cached fusion states (B, 32, 768); target_bank: (M,
        32, 256), dense or an int8 QuantBank. Max-over-query InfoNCE with
        the learnable `temp`; with `neg_idx` over the positive and the
        sampled negatives only (plain tensor code)."""
        feats = self.stage2_query_feats(refer_feats, text_ids, generator)
        tau = self.model.temp
        if neg_idx is not None:
            negs = target_bank[neg_idx.long().reshape(-1)].reshape(
                *neg_idx.shape, *target_bank.shape[1:])
            pos = target_bank[labels.long()]
            cands = torch.cat([pos[:, None], negs], dim=1)  # (B, 1+N, Q, D)
            sims = torch.einsum("bd,bnqd->bnq", feats.float(), cands.float())
            return infonce.cross_entropy(
                sims.amax(dim=-1) / tau,
                torch.zeros(feats.shape[0], dtype=torch.long,
                            device=feats.device))
        return max_query_infonce(feats, target_bank, labels, tau)

    def loss_tau(self):
        return self.model.temp

    # ---- host helpers ----
    @staticmethod
    def pre_caption(caption: str, max_words: int = 50) -> str:
        """LAVIS's blip_caption eval processor: captions pass through it
        before tokenizing."""
        caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
        caption = re.sub(r"\s{2,}", " ", caption).rstrip("\n").strip(" ")
        words = caption.split(" ")
        if len(words) > max_words:
            caption = " ".join(words[:max_words])
        return caption

    def tokenize(self, texts) -> np.ndarray:
        """A stacked (B, 2, 32) int32 array: [input_ids; attention_mask]."""
        with span("text.tokenize"):
            ids, mask = self.tokenizer([self.pre_caption(t) for t in texts],
                                       max_length=MAX_TXT_LEN)
            return np.stack([ids, mask], axis=1)

    # ---- optimization ----
    def optimizer_kwargs(self):
        """blip24cir trains with betas (0.9, 0.98), eps 1e-7, wd 0.05."""
        return {"b1": 0.9, "b2": 0.98, "eps": 1e-7, "weight_decay": 0.05}

    # ---- trainability ----
    def trainable_filter(self, name: str) -> bool:
        """init_stage2: only Qformer_query, text_proj_q and temp train. Of
        Qformer_query, the cross-attention and the query feed-forward never
        take part in the text re-read: their gradient stays None and AdamW
        leaves them where they are, as the reference does."""
        parts = name.split(".")
        if parts[0] == "model":
            parts = parts[1:]
        return bool(parts) and parts[0] in STAGE2_TRAINABLE
