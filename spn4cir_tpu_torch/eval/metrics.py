"""Retrieval metrics (FashionIQ / CIRR Recall@K, CIRR subset Recall@K).

Counterpart of `spn4cir_tpu/eval/metrics.py` (parity target:
`clip4cir/validate.py:19-51` for FIQ and `:111-156` for CIRR), in the same
rank-count formulation, on integer ids:

    rank(target) = #{ j : score[j] > score[target], j != reference }

The ranks use no sort and no `topk`: ties are broken in the target's
favour exactly as in the JAX package, so ranks and recalls agree on tied
scores too. Recall@K = mean(rank < K).

`topk_names` / `subset_topk_names` (the CIRR test submission) do order the
gallery: among equal scores the lowest index comes first, as
`jax.lax.top_k` returns them. `torch.topk` promises no order among ties, so
they take the head of a stable descending sort.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


def target_ranks(scores: torch.Tensor, target_ids: torch.Tensor,
                 refer_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-query rank of the target in the gallery, reference excluded when
    `refer_ids` is given.

    scores: (Q, N) similarity (higher = better); target_ids/refer_ids: (Q,).
    refer_ids=None skips the exclusion (the published FIQ eval filters the
    reference only for clip4cir/zscir)."""
    rows = torch.arange(scores.shape[0], device=scores.device)
    tgt = scores[rows, target_ids.long()]
    greater = scores > tgt[:, None]
    if refer_ids is not None:
        greater[rows, refer_ids.long()] = False
    return greater.sum(dim=1)


def subset_ranks(scores: torch.Tensor, target_ids: torch.Tensor,
                 refer_ids: torch.Tensor, member_ids: torch.Tensor
                 ) -> torch.Tensor:
    """Rank of the target among its CIRR subset members (reference
    excluded). member_ids: (Q, G) gallery ids of the img_set members (may
    include the reference and the target)."""
    rows = torch.arange(scores.shape[0], device=scores.device)
    target_ids, refer_ids = target_ids.long(), refer_ids.long()
    member_ids = member_ids.long()
    tgt = scores[rows, target_ids]
    member_scores = scores.gather(1, member_ids)
    valid = ((member_ids != refer_ids[:, None])
             & (member_ids != target_ids[:, None]))
    return ((member_scores > tgt[:, None]) & valid).sum(dim=1)


def recall_at(ranks: torch.Tensor, k: int) -> torch.Tensor:
    return (ranks < k).float().mean() * 100.0


def fiq_metrics(scores: torch.Tensor, target_ids: torch.Tensor,
                refer_ids: Optional[torch.Tensor],
                ks: Sequence[int] = (10, 50)) -> Dict[str, float]:
    """FashionIQ Recall@10/50 per dress type."""
    ranks = target_ranks(scores, target_ids, refer_ids)
    return {f"recall_at{k}": float(recall_at(ranks, k)) for k in ks}


def cirr_metrics(scores: torch.Tensor, target_ids: torch.Tensor,
                 refer_ids: torch.Tensor, member_ids: torch.Tensor,
                 ks: Sequence[int] = (1, 5, 10, 50),
                 group_ks: Sequence[int] = (1, 2, 3)) -> Dict[str, float]:
    """CIRR global + subset recalls: recall_at{k}, group_recall_at{k}, and
    the composite arithmetic_mean = (R@5 + Rsub@1)/2 tracked by training."""
    ranks = target_ranks(scores, target_ids, refer_ids)
    granks = subset_ranks(scores, target_ids, refer_ids, member_ids)
    out = {f"recall_at{k}": float(recall_at(ranks, k)) for k in ks}
    out.update({f"group_recall_at{k}": float(recall_at(granks, k))
                for k in group_ks})
    out["arithmetic_mean"] = (out["recall_at5"] + out["group_recall_at1"]) / 2
    return out


def fiq_average(per_type: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Average across dress types + Rmean = (avg R@10 + avg R@50)/2."""
    avg10 = sum(m["recall_at10"] for m in per_type) / len(per_type)
    avg50 = sum(m["recall_at50"] for m in per_type) / len(per_type)
    return {
        "avg_recall_at10": avg10,
        "avg_recall_at50": avg50,
        "mean_recall": (avg10 + avg50) / 2,
    }


def _topk_lowest_index_first(scores: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :k]


def topk_names(scores: torch.Tensor, refer_ids: torch.Tensor, k: int
               ) -> torch.Tensor:
    """Top-k gallery ids per query with the reference excluded (its score
    set to -inf); used by the CIRR test-submission path."""
    cols = torch.arange(scores.shape[1], device=scores.device)
    masked = scores.masked_fill(cols[None, :] == refer_ids.long()[:, None],
                                float("-inf"))
    return _topk_lowest_index_first(masked, min(k, scores.shape[1]))


def subset_topk_names(scores: torch.Tensor, refer_ids: torch.Tensor,
                      member_ids: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k among the subset members (reference excluded), returned as
    gallery ids. member_ids: (Q, G)."""
    member_ids = member_ids.long()
    member_scores = scores.gather(1, member_ids).masked_fill(
        member_ids == refer_ids.long()[:, None], float("-inf"))
    return member_ids.gather(1, _topk_lowest_index_first(member_scores, k))
