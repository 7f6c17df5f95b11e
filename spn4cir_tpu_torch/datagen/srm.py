"""SRM (similarity-rank matcher): pair-quality scores and hard-negative
pools, on torch tensors on the device that holds the similarities.

Counterpart of `spn4cir_tpu/datagen/srm.py` (parity target:
`zscir/srm_utils.py`, which encodes every train image with Unicom ViT-L/14
and every caption with BGE (`:35-69`) and with CLIP ViT-L/14 (`:72-116`),
forms four similarity matrices (`:119-131`), then per triplet rank scores
and the top-1000 hard negatives in a Python loop (`:142-183`)).

`compute_sims`: the four matrices as plain float32 products. They lie
outside any Pallas kernel in the JAX package, so `torch.matmul` is the
port's too; TF32 is switched off for them inside the function
(`utils.tensors.ieee_fp32`) whatever the caller set, since a rank is a
strict `>` count and moves with the last bit of a similarity.

`srm_scores`: the per-triplet work in row chunks (`score_rows`), so that at
CIRR's size (16.9k images x 28.2k triplets: i2t 1.9 GB, i2i 1.1 GB, t2t
3.2 GB of float32) a chunk's gathered rows fit beside the matrices:
  - ranks: `(row > picked).sum` per matrix, a rank-sum per pair
    (rt: refer/target in i2i; rm: refer/text in t2i and i2t; mt:
    text/target);
  - hard negatives: the top K = min(k, N) of each row with the row's own
    entry set to -1e4 first, so at N <= K the self index comes last. Among
    exactly equal values the lower index comes first
    (`eval.metrics.topk_lowest_index_first`); the JAX version's order
    there is not stable (`argpartition`, then a quicksort reversed), and
    duplicate images, which dedup exists to find, make such ties in i2i.

Outputs: the six arrays `rt, rm, mt` (N,) and `r_fn, m_fn, t_fn` (N, K),
int64 as in the JAX package, written to `srm.npz` by `save_srm` (the same
tensor roles as the reference's srm.pth).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

from spn4cir_tpu_torch.eval.metrics import topk_lowest_index_first
from spn4cir_tpu_torch.utils.tensors import ieee_fp32

#: the value a row's own entry takes before its top-K (the reference's
#: diagonal fill)
SELF_FILL = -1e4
#: triplets a chunk of `srm_scores` holds: at CIRR's size a chunk's
#: gathered t2t rows are 1,024 x 28,225 float32 (116 MB) and their sort
#: twice that again
ROW_CHUNK = 1024


def compute_sims(clip_image_feats: torch.Tensor,
                 clip_text_feats: torch.Tensor,
                 srm_image_feats: torch.Tensor,
                 srm_text_feats: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The four matrices of srm_utils.calcu_sims (`:119-131`): cross-modal
    from CLIP (i2t, and t2i as its transposed view) and intra-modal from
    the SRM model (i2i, t2t), float32 without TF32."""
    with ieee_fp32():
        i2t = clip_image_feats.float() @ clip_text_feats.float().T
        i2i = srm_image_feats.float() @ srm_image_feats.float().T
        t2t = srm_text_feats.float() @ srm_text_feats.float().T
    return {"i2t": i2t, "t2i": i2t.T, "i2i": i2i, "t2t": t2t}


def _rank_of(sims: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor
             ) -> torch.Tensor:
    """The rank of sims[rows[i], cols[i]] within row rows[i], descending:
    how many entries of the row are strictly greater."""
    picked = sims[rows]
    at = picked.gather(1, cols[:, None])
    return (picked > at).sum(dim=1)


def _topk_excl_self(sims: torch.Tensor, rows: torch.Tensor, selves:
                    torch.Tensor, k: int) -> torch.Tensor:
    """Column ids of the top min(k, N) of each row sims[rows[i]] with
    column selves[i] set to SELF_FILL, descending, lower index first among
    equal values."""
    sub = sims[rows]
    sub[torch.arange(len(rows), device=sub.device), selves] = SELF_FILL
    # a copy of the K columns: the slice would keep the whole sorted row
    # order of the chunk alive (at CIRR's size 0.5 GB a chunk)
    top = topk_lowest_index_first(sub, min(k, sub.shape[1]))[1]
    return top.contiguous()


def score_rows(sims: Mapping[str, torch.Tensor], refer_ids: torch.Tensor,
               target_ids: torch.Tensor, rows: torch.Tensor,
               k_negatives: int = 1000) -> Dict[str, torch.Tensor]:
    """`srm_scores`' six outputs for the triplets `rows` only (indices into
    refer_ids / target_ids, and the text rows of the cross matrices)."""
    ref, tgt = refer_ids[rows], target_ids[rows]
    i2i, t2i, i2t = sims["i2i"], sims["t2i"], sims["i2t"]
    return {
        "rt": _rank_of(i2i, ref, tgt) + _rank_of(i2i, tgt, ref),
        "rm": _rank_of(t2i, rows, ref) + _rank_of(i2t, ref, rows),
        "mt": _rank_of(t2i, rows, tgt) + _rank_of(i2t, tgt, rows),
        "t_fn": _topk_excl_self(i2i, tgt, tgt, k_negatives),
        "r_fn": _topk_excl_self(i2i, ref, ref, k_negatives),
        "m_fn": _topk_excl_self(sims["t2t"], rows, rows, k_negatives),
    }


def srm_scores(sims: Mapping[str, torch.Tensor], refer_ids, target_ids,
               k_negatives: int = 1000, chunk: int = ROW_CHUNK
               ) -> Dict[str, torch.Tensor]:
    """Per-triplet rank scores and top-K intra-modal hard negatives
    (srm_utils.get_srm_out `:142-183`), `chunk` triplets at a time on the
    similarities' device. Triplet i's text is row i of the cross matrices.
    Returns int64 tensors on that device."""
    device = sims["i2i"].device
    refer_ids = torch.as_tensor(refer_ids, dtype=torch.int64, device=device)
    target_ids = torch.as_tensor(target_ids, dtype=torch.int64,
                                 device=device)
    n = len(refer_ids)
    parts = [score_rows(sims, refer_ids, target_ids,
                        torch.arange(s, min(s + chunk, n), device=device),
                        k_negatives)
             for s in range(0, n, chunk)]
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def save_srm(path: str, scores: Mapping[str, torch.Tensor]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: v.cpu().numpy()
                                 for k, v in scores.items()})


def load_srm(path: str) -> Dict[str, np.ndarray]:
    return dict(np.load(path))


def extract_all_features(encode_fn: Callable[[torch.Tensor], torch.Tensor],
                         batches: Iterable[Tuple[np.ndarray, np.ndarray]],
                         device) -> torch.Tensor:
    """Run `encode_fn` over padded (ids, images) batches (ids -1 on the
    padding) and return the L2-normalised float32 rows, row i holding the
    image of id i, on `device`. Rows no batch wrote stay zero, however far
    the ids grow."""
    feats = None
    for ids, images in batches:
        with torch.no_grad():
            out = encode_fn(torch.from_numpy(images).to(device)).float()
        out = out / torch.linalg.norm(out, dim=-1, keepdim=True)
        grow = int(ids.max()) + 1
        if feats is None or grow > feats.shape[0]:
            bigger = torch.zeros(grow, out.shape[1], device=device)
            if feats is not None:
                bigger[: feats.shape[0]] = feats
            feats = bigger
        valid = ids >= 0
        feats[torch.from_numpy(ids[valid]).to(device)] = out[
            torch.from_numpy(valid).to(device)]
    return feats
