"""Feature normalization shared by the retrieval path.

Counterpart of `spn4cir_tpu/ops/infonce.py`; only `l2_normalize` is ported
so far (the InfoNCE losses belong to the training path)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12
                 ) -> torch.Tensor:
    """x / max(||x||, eps), the norm taken in float32, result in x's dtype."""
    norm = x.float().square().sum(dim=dim, keepdim=True).sqrt()
    return (x / norm.clamp_min(eps).to(x.dtype)).to(x.dtype)
