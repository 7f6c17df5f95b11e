"""Small tensor helpers shared by the bank, the gallery index, the service,
the device preprocess and the SRM scores."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def ieee_fp32():
    """float32 products in full float32 (no TF32) inside the block."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def to_host(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy on the host; bfloat16 widens (exactly) to float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def as_tensor(images) -> torch.Tensor:
    """A tensor as it is; a numpy array, or a list of equal-shape arrays
    stacked, as a tensor on the host."""
    if isinstance(images, torch.Tensor):
        return images
    return torch.as_tensor(np.asarray(images))
