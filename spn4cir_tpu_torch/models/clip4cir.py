"""clip4cir backbone: CLIP dual encoder + element-wise-sum combiner.

Counterpart of `spn4cir_tpu/models/clip4cir.py` for the serving path:
encoders, the element-wise-sum fusion and tokenization. The stage-1/2
losses belong to the training path and are not ported yet.
"""

from __future__ import annotations

import torch

from spn4cir_tpu.tokenizer.bpe import ClipTokenizer, tokenize
from spn4cir_tpu_torch.models.api import BankSpec, CIRBackbone, register_backbone
from spn4cir_tpu_torch.models.clip import build_clip
from spn4cir_tpu_torch.ops.infonce import l2_normalize


class ClipCIR(CIRBackbone):
    name = "clip"
    extend_suffix = "clip"

    def __init__(self, clip_model_name: str = "RN50x4", tau: float = 0.02,
                 dtype: torch.dtype = torch.float32, device="cpu",
                 tokenizer: ClipTokenizer | None = None):
        super().__init__()
        self.clip_model_name = clip_model_name
        self.tau = tau
        self.dtype = dtype
        self.tokenizer = tokenizer
        with torch.device(device):
            self.model = build_clip(clip_model_name, dtype=dtype)
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

    # ---- losses (training path, not ported yet) ----
    def stage1_loss(self, *args, **kw):
        raise NotImplementedError("clip4cir stage-1 training is not ported "
                                  "to PyTorch yet")

    def stage2_loss(self, *args, **kw):
        raise NotImplementedError("clip4cir stage-2 training is not ported "
                                  "to PyTorch yet")

    # ---- host helpers ----
    def tokenize(self, texts):
        return tokenize(texts, context_length=self.cfg.context_length,
                        truncate=True, tokenizer=self.tokenizer)


@register_backbone("clip")
def _build_clip_cir(**kw) -> ClipCIR:
    return ClipCIR(**kw)


@register_backbone("zs")
def _build_zs_cir(clip_model_name: str = "ViT-L/14", tau: float = 0.01,
                  **kw) -> ClipCIR:
    """zscir: the same CLIP architecture with ViT-L/14 defaults; generated
    triplets replace the human train set."""
    b = ClipCIR(clip_model_name=clip_model_name, tau=tau, **kw)
    b.name = "zs"
    b.extend_suffix = "zs"
    b.replace_extended = True
    return b
