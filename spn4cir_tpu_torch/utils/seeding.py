"""Deterministic seeding: python, numpy and torch, plus the generator that
makes the random weights (counterpart of `spn4cir_tpu/utils/seeding.py`,
which returns a jax PRNGKey)."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed the host RNGs and torch; return a CPU generator seeded with
    `seed` for explicit use."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
