"""clip4cir backbone: CLIP dual encoder + element-wise-sum combiner.

Counterpart of `spn4cir_tpu/models/clip4cir.py`: encoders, the
element-wise-sum fusion, tokenization, the stage-2 loss (full-bank InfoNCE
through `ops/bank_kernels.py`, or sampled negatives) and the stage-1 loss
(in-batch InfoNCE through the live towers, and the negative-type
ablation's four flavors).
"""

from __future__ import annotations

from typing import Optional

import torch

from spn4cir_tpu_torch.models.api import BankSpec, CIRBackbone, register_backbone
from spn4cir_tpu_torch.models.clip import build_clip
from spn4cir_tpu_torch.ops import infonce
from spn4cir_tpu_torch.ops.bank_kernels import bank_infonce
from spn4cir_tpu_torch.ops.infonce import l2_normalize
from spn4cir_tpu_torch.tokenizer.bpe import ClipTokenizer, tokenize
from spn4cir_tpu_torch.utils.logging import span


@register_backbone("clip")
class ClipCIR(CIRBackbone):
    name = "clip"
    extend_suffix = "clip"

    def __init__(self, clip_model_name: str = "RN50x4", tau: float = 0.02,
                 dtype: torch.dtype = torch.float32, device="cpu",
                 tokenizer: ClipTokenizer | None = None,
                 remat: bool = False):
        super().__init__()
        self.clip_model_name = clip_model_name
        self.tau = tau
        self.dtype = dtype
        self.tokenizer = tokenizer
        with torch.device(device):
            self.model = build_clip(clip_model_name, dtype=dtype, remat=remat)
        self.cfg = self.model.cfg
        self.input_dim = self.cfg.image_resolution
        self.embed_dim = self.cfg.embed_dim

    # ---- construction ----
    def init_params(self, generator: torch.Generator) -> None:
        self.model.init_weights(generator)

    def bank_spec(self) -> BankSpec:
        return BankSpec((self.embed_dim,), (self.embed_dim,))

    # ---- encoders ----
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.model.encode_image(images)

    def gallery_features(self, images: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.encode_image(images).float())

    def bank_features(self, images: torch.Tensor):
        """Single encode serving both bank forms: refer = raw feats, target
        = normalized."""
        with span("bank.encode"):
            with span("bank.encode.vision"):
                feats = self.encode_image(images)
            return feats, l2_normalize(feats.float())

    def index_features(self, images: torch.Tensor):
        """The scoring gallery is normalized; the fusion-side refer lookup
        keeps the raw encode_image output."""
        feats = self.encode_image(images)
        return {"target": l2_normalize(feats.float()), "refer": feats}

    def encode_text(self, text_ids: torch.Tensor) -> torch.Tensor:
        return self.model.encode_text(text_ids)

    # ---- fusion ----
    def combine(self, refer_feats: torch.Tensor, text_feats: torch.Tensor
                ) -> torch.Tensor:
        """element_wise_sum combiner."""
        return l2_normalize(refer_feats.float() + text_feats.float())

    def fuse(self, refer_feats: torch.Tensor, text_ids: torch.Tensor
             ) -> torch.Tensor:
        return self.combine(refer_feats, self.encode_text(text_ids))

    # ---- losses ----
    def stage2_loss(self, refer_feats: torch.Tensor, text_ids: torch.Tensor,
                    target_bank, labels: torch.Tensor, *,
                    neg_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        query = self.fuse(refer_feats, text_ids)
        if neg_idx is not None:
            return infonce.sampled_neg_infonce(query, target_bank, labels,
                                               neg_idx, self.tau)
        return bank_infonce(query, target_bank, labels, self.tau)

    def stage1_loss(self, images_refer: torch.Tensor,
                    images_target: torch.Tensor, text_ids: torch.Tensor,
                    gather: infonce.Gather = None) -> torch.Tensor:
        """In-batch InfoNCE training the full model end to end (`--wo_bank`).
        Refer and target ride one 2B-batch tower call, as in the JAX
        package: per-sample math is identical to two B-batch calls.
        `gather`: see `infonce.in_batch_infonce`."""
        b = images_refer.shape[0]
        both = self.encode_image(torch.cat([images_refer, images_target]))
        target = l2_normalize(both[b:].float())
        query = self.combine(both[:b], self.encode_text(text_ids))
        return infonce.in_batch_infonce(query, target, self.tau, gather)

    def stage1_negtype_loss(self, images_refer: torch.Tensor,
                            images_target: torch.Tensor,
                            text_ids: torch.Tensor, neg_type: int = 15,
                            gather: infonce.Gather = None) -> torch.Tensor:
        """The negative-type ablation (`--neg_type`): the mean of the
        flavors of `infonce.negtype_losses` that the bitmask selects (bit0
        refer, bit1 text, bit2 target, bit3 query). Refer and target go
        through the tower in two calls, as in the JAX package; the features
        go to float32 before the losses."""
        refer = self.encode_image(images_refer).float()
        target = l2_normalize(self.encode_image(images_target).float())
        text = self.encode_text(text_ids).float()
        losses = infonce.negtype_losses(refer, text, target, self.tau,
                                        gather)
        return infonce.combine_negtype(losses, neg_type)

    # ---- host helpers ----
    def tokenize(self, texts):
        with span("text.tokenize"):
            return tokenize(texts, context_length=self.cfg.context_length,
                            truncate=True, tokenizer=self.tokenizer)


@register_backbone("zs")
class ZsCIR(ClipCIR):
    """zscir: the same CLIP architecture with ViT-L/14 defaults; generated
    triplets replace the human train set."""
    name = "zs"
    extend_suffix = "zs"
    replace_extended = True

    def __init__(self, clip_model_name: str = "ViT-L/14", tau: float = 0.01,
                 **kw):
        super().__init__(clip_model_name=clip_model_name, tau=tau, **kw)
