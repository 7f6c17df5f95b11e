"""The backbone protocol of the PyTorch port.

Counterpart of `spn4cir_tpu/models/api.py`. A backbone is an `nn.Module`
that owns its weights, so the encoders take tensors only (the JAX protocol
passes an explicit `params` pytree to each method). Serving, eval and the
stage-2 trainer are written once against this interface.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class BankSpec:
    """Shape metadata of the feature banks; refer_shape / target_shape
    exclude the leading bank axis (clip: (D,) / (D,))."""

    refer_shape: Tuple[int, ...]
    target_shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32


class CIRBackbone(nn.Module, metaclass=abc.ABCMeta):
    """A CIR backbone: encoders + fusion, as methods of one module."""

    #: registry key and extended-caption filename infix
    name: str = ""
    extend_suffix: str = ""
    #: zscir semantics: generated triplets replace the human train set
    replace_extended: bool = False
    #: input resolution for the image tower
    input_dim: int = 224

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @abc.abstractmethod
    def init_params(self, generator: torch.Generator) -> None:
        """Fill the weights with random values from `generator`."""

    @abc.abstractmethod
    def bank_spec(self) -> BankSpec:
        ...

    # ---- encoders ----
    @abc.abstractmethod
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """Images (B, H, W, 3) -> refer-side features."""

    @abc.abstractmethod
    def gallery_features(self, images: torch.Tensor) -> torch.Tensor:
        """Images -> L2-normalized gallery/target features."""

    def bank_features(self, images: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One-image-batch (refer_form, target_form) features for bank
        extraction (one pass over the unique train images)."""
        return self.encode_image(images), self.gallery_features(images)

    def index_features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-gallery-image tensors: 'target' is score-ready, 'refer' is the
        fusion-side lookup (eval reuses gallery features for references)."""
        feats = self.gallery_features(images)
        return {"target": feats, "refer": feats}

    @abc.abstractmethod
    def encode_text(self, text_ids: torch.Tensor) -> torch.Tensor:
        """Tokenized text -> text features."""

    @abc.abstractmethod
    def fuse(self, refer_feats: torch.Tensor, text_ids: torch.Tensor
             ) -> torch.Tensor:
        """(refer-side feats, text ids) -> L2-normalized query features."""

    # ---- losses ----
    @abc.abstractmethod
    def stage2_loss(self, refer_feats: torch.Tensor, text_ids: torch.Tensor,
                    target_bank, labels: torch.Tensor, *,
                    neg_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-bank (or sampled-negative) InfoNCE on cached refer feats."""

    # ---- host-side helpers ----
    @abc.abstractmethod
    def tokenize(self, texts):
        """Host tokenization to fixed-length int32 ids (numpy)."""

    # The published FIQ eval filters the reference image from rankings only
    # for clip4cir/zscir; other backbones rank the full gallery and override
    # this to False.
    fiq_exclude_reference = True

    def score_queries(self, query_feats: torch.Tensor, gallery: torch.Tensor
                      ) -> torch.Tensor:
        """Similarity matrix used for retrieval: the cosine dot, float32."""
        return query_feats.float() @ gallery.float().T

    # ---- optimization ----
    def optimizer_kwargs(self) -> Dict[str, Any]:
        """Per-backbone AdamW hyperparameters (ref clip4cir/train.py:79-85)."""
        return {"b1": 0.9, "b2": 0.999, "eps": 1e-7, "weight_decay": 1e-2}

    # ---- trainability ----
    def trainable_filter(self, name: str) -> bool:
        """True if the parameter called `name` (dotted, relative to the
        backbone) trains in stage 2: the image tower is frozen."""
        return "visual" not in name.split(".")


_REGISTRY: Dict[str, Callable[..., CIRBackbone]] = {}


def register_backbone(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def build_backbone(name: str, **kw) -> CIRBackbone:
    if name not in _REGISTRY:
        import spn4cir_tpu_torch.models.clip4cir  # noqa: F401  (registers)
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"backbone {name!r} is not ported to PyTorch yet; have "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)

