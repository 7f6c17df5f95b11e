"""Sampling filters of autoregressive generation.

Counterpart of the part of `spn4cir_tpu/models/generation.py` that the LLaMA
rewriter uses (`NEG_INF`, `top_k_filter`, `top_p_filter`); the MED decoder
of the BLIP captioner is not ported yet."""

from __future__ import annotations

import torch

NEG_INF = -1e9


def top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """HF TopKLogitsWarper: keep only the top_k highest logits, NEG_INF the
    rest. The threshold is the k-th highest VALUE, so ties at the boundary
    all survive (HF's `logits < topk(...).values[..., -1:]`)."""
    if top_k <= 0 or top_k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering (HF TopPLogitsWarper, min_tokens_to_keep=1): keep
    the smallest set of tokens whose cumulative probability exceeds top_p.

    Positional, like HF: the logits are sorted ascending with ties in index
    order (a stable sort) and cut by sorted position, so the top token
    always stays; a value threshold would cut tied copies at the boundary."""
    idx = torch.argsort(logits, dim=-1, stable=True)
    sorted_logits = logits.gather(-1, idx)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove_sorted = cum <= (1.0 - top_p)
    remove_sorted[..., -1] = False
    remove = torch.zeros_like(remove_sorted).scatter(-1, idx, remove_sorted)
    return logits.masked_fill(remove, NEG_INF)
