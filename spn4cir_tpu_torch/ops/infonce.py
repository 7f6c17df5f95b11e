"""Contrastive (InfoNCE) losses and feature normalization in plain PyTorch.

Counterpart of `spn4cir_tpu/ops/infonce.py` (`cross_entropy`,
`in_batch_infonce`, `bank_infonce`, `sampled_neg_infonce`, `l2_normalize`,
`max_query_infonce`, `max_query_scores`, `negtype_losses`,
`combine_negtype`). These materialise the logits; they are the semantic
ground truth that the blocked bank-InfoNCE kernels (`ops/bank_kernels.py`,
`ops/maxquery_kernels.py`) are tested against, the sampled-negatives loss
of `--neg_num`, the BLIP-2 retrieval scores and the stage-1
negative-type ablation (which the JAX package, too, computes as einsums
outside any kernel).

All losses take logits in float32 whatever the input dtype: the operands
are widened before the product (bfloat16 widens exactly), which is what the
JAX package's `preferred_element_type=float32` dots compute.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

Tau = Union[float, torch.Tensor]

#: a data-parallel step's gather: this rank's rows -> every rank's rows in
#: rank order, with their gradient (`parallel.mesh.gather_rows_with_grad`)
Gather = Optional[Callable[[torch.Tensor], torch.Tensor]]


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


def in_batch_infonce(query: torch.Tensor, target: torch.Tensor, tau: Tau,
                     gather: Gather = None) -> torch.Tensor:
    """In-batch InfoNCE: positives on the diagonal (the stage-1 loss). With
    `gather`, over the global batch of a data-parallel step: both sides are
    gathered first, and every rank computes the same global loss."""
    if gather is not None:
        query, target = gather(query), gather(target)
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


#: the negative flavors of `negtype_losses` in the order of the mask's bits
NEGTYPE_ORDER = ("refer", "text", "target", "query")


def negtype_losses(refer: torch.Tensor, text: torch.Tensor,
                   target: torch.Tensor, tau: Tau, gather: Gather = None
                   ) -> Dict[str, torch.Tensor]:
    """The four negative flavors of the negative-type ablation. refer /
    text: (B, D) raw features; target: (B, D) normalized.

    - 'target': in-batch InfoNCE of normalize(refer_i + text_i) over the
      targets;
    - 'query': the reverse direction, target_i over the queries;
    - 'text': logits[i, j] = <normalize(refer_i + text_j), target_i>;
    - 'refer': logits[i, j] = <normalize(refer_j + text_i), target_i>;
    the positive at j == i in each; with `gather`, over the global batch
    (as `in_batch_infonce`)."""
    if gather is not None:
        refer, text, target = gather(refer), gather(text), gather(target)
    labels = torch.arange(refer.shape[0], device=refer.device)
    query = l2_normalize(refer + text)
    out = {"target": in_batch_infonce(query, target, tau),
           "query": in_batch_infonce(target, query, tau)}
    # (B, B, D) cross combinations: [i, j] = refer_i + text_j
    cross = l2_normalize(refer[:, None, :] + text[None, :, :]).float()
    tgt = target.float()
    out["text"] = cross_entropy(
        torch.einsum("ijd,id->ij", cross, tgt) / tau, labels)
    out["refer"] = cross_entropy(
        torch.einsum("jid,id->ij", cross, tgt) / tau, labels)
    return out


def combine_negtype(losses: Dict[str, torch.Tensor], neg_type: int
                    ) -> torch.Tensor:
    """The mean of the losses the 4-bit mask `neg_type` selects (bit0
    refer, bit1 text, bit2 target, bit3 query)."""
    picks = [losses[name] for i, name in enumerate(NEGTYPE_ORDER)
             if neg_type & (1 << i)]
    if not picks:
        raise ValueError("neg_type selects no losses")
    return sum(picks) / len(picks)
