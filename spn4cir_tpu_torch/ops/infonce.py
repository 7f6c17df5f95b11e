"""Contrastive (InfoNCE) losses and feature normalization in plain PyTorch.

Counterpart of `spn4cir_tpu/ops/infonce.py` (`cross_entropy`,
`in_batch_infonce`, `bank_infonce`, `sampled_neg_infonce`, `l2_normalize`,
`max_query_infonce`, `max_query_scores`). These materialise the logits; they
are the semantic ground truth that the blocked bank-InfoNCE kernels
(`ops/bank_kernels.py`, `ops/maxquery_kernels.py`) are tested against, the
sampled-negatives loss of `--neg_num` and the BLIP-2 retrieval scores.

All losses take logits in float32 whatever the input dtype: the operands
are widened before the product (bfloat16 widens exactly), which is what the
JAX package's `preferred_element_type=float32` dots compute.
"""

from __future__ import annotations

from typing import Union

import torch

Tau = Union[float, torch.Tensor]


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12
                 ) -> torch.Tensor:
    """x / max(||x||, eps), the norm taken in float32, result in x's dtype."""
    norm = x.float().square().sum(dim=dim, keepdim=True).sqrt()
    return (x / norm.clamp_min(eps).to(x.dtype)).to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over integer labels; logits widened to float32 for a stable
    logsumexp."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    pos = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (lse - pos).mean()


def in_batch_infonce(query: torch.Tensor, target: torch.Tensor, tau: Tau
                     ) -> torch.Tensor:
    """In-batch InfoNCE: positives on the diagonal (the stage-1 loss)."""
    logits = query.float() @ target.float().T / tau
    return cross_entropy(logits, torch.arange(query.shape[0],
                                              device=query.device))


def bank_infonce(query: torch.Tensor, target_bank: torch.Tensor,
                 labels: torch.Tensor, tau: Tau) -> torch.Tensor:
    """Full-bank InfoNCE: every bank row is a negative except `labels[i]`.

    query: (B, D) normalized; target_bank: (M, D) normalized; labels: (B,)
    integer image ids into the bank. This is the stage-2 loss."""
    logits = query.float() @ target_bank.float().T / tau
    return cross_entropy(logits, labels)


def sampled_neg_infonce(query: torch.Tensor, target_bank: torch.Tensor,
                        labels: torch.Tensor, neg_idx: torch.Tensor, tau: Tau
                        ) -> torch.Tensor:
    """InfoNCE over `neg_num` pre-sampled bank negatives + the positive.

    neg_idx: (B, neg_num) integer indices into the bank, sampled on the
    host without replacement and excluding the positive (see
    `train.stage2.sample_negatives`). The positive sits in column 0."""
    pos = target_bank[labels.long()]                        # (B, D)
    negs = target_bank[neg_idx.long().reshape(-1)].reshape(
        *neg_idx.shape, target_bank.shape[-1])              # (B, N, D)
    cands = torch.cat([pos[:, None, :], negs], dim=1)       # (B, 1+N, D)
    logits = torch.einsum("bd,bnd->bn", query.float(), cands.float()) / tau
    return cross_entropy(logits, torch.zeros(query.shape[0], dtype=torch.long,
                                             device=query.device))


def max_query_infonce(fusion_feats: torch.Tensor, target_bank: torch.Tensor,
                      labels: torch.Tensor, tau: Tau) -> torch.Tensor:
    """BLIP-2 stage-2 loss: per-target max over the query tokens.

    fusion_feats: (B, D); target_bank: (M, Q, D); labels: (B,). The
    semantic ground truth of `ops/maxquery_kernels.py` (one einsum; the
    reference loops over the samples)."""
    logits = max_query_scores(fusion_feats, target_bank) / tau
    return cross_entropy(logits, labels)


def max_query_scores(fusion_feats: torch.Tensor, target_bank: torch.Tensor
                     ) -> torch.Tensor:
    """Retrieval scores of the BLIP-2 backbone: (B, M) float32, the max over
    the Q query features of each gallery image."""
    sims = torch.einsum("bd,mqd->bmq", fusion_feats.float(),
                        target_bank.float())
    return sims.amax(dim=-1)
