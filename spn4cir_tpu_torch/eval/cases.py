"""Case-study tooling: per-query rank dumps and model-against-model
comparisons.

Counterpart of `spn4cir_tpu/eval/cases.py` (reference
`clip4cir/validate_case.py`, which dumps each validation query's target
rank and top-10 retrieved names to `cases/*.json`, and
`clip4cir/analysis_case.py`, which collects the queries where model A fails
and model B ranks the target first and copies their images), over the
port's `eval/retrieval.py`: ranks and top-k come from `eval/metrics.py`,
whose tie order is the JAX package's.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from spn4cir_tpu_torch.eval import metrics as M
from spn4cir_tpu_torch.eval.retrieval import (GalleryIndex,
                                              generate_val_predictions,
                                              query_scores)


@torch.inference_mode()
def dump_cases(backbone, dataset, index: GalleryIndex, out_path: str,
               top_k: int = 10, batch_size: int = 32) -> List[dict]:
    """One record per query: caption, reference and target names, the
    target's rank (reference excluded) and the top-k retrieved names
    (ref validate_case.py:53-60); written to `out_path` as JSON."""
    preds = generate_val_predictions(backbone, dataset, index, batch_size)
    scores = query_scores(backbone, preds, index)
    dev = scores.device
    refer = torch.from_numpy(preds["refer_gid"]).to(dev)
    target = torch.from_numpy(preds["target_gid"]).to(dev)
    ranks = M.target_ranks(scores, target, refer).cpu().numpy()
    topk = M.topk_names(scores, refer, top_k).cpu().numpy()
    names = np.asarray(index.names)
    records = []
    for i in range(len(ranks)):
        records.append({
            "caption": dataset.caption_for(i, train=False),
            "reference_name": names[preds["refer_gid"][i]],
            "target_name": names[preds["target_gid"][i]],
            "rank": int(ranks[i]),
            "topk": names[topk[i]].tolist(),
        })
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(records, f, indent=1)
    return records


def compare_cases(cases_a: List[dict], cases_b: List[dict],
                  fail_rank: int = 10, win_rank: int = 0) -> List[dict]:
    """Queries where model A misses (rank >= fail_rank) and model B nails
    it (rank <= win_rank); ref analysis_case.py:30-47."""
    return [{"query": a, "better": b} for a, b in zip(cases_a, cases_b)
            if a["rank"] >= fail_rank and b["rank"] <= win_rank]


def export_case_images(cases: List[dict], name_to_path: Dict[str, str],
                       out_dir: str, limit: Optional[int] = None) -> int:
    """Copy the reference and target images of the selected cases, one
    folder each with the caption beside them; returns the images copied."""
    os.makedirs(out_dir, exist_ok=True)
    copied = 0
    for i, case in enumerate(cases[:limit] if limit else cases):
        q = case["query"] if "query" in case else case
        folder = os.path.join(out_dir, f"case_{i:04d}")
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "caption.txt"), "w") as f:
            f.write(q["caption"])
        for role in ("reference_name", "target_name"):
            src = name_to_path.get(q[role])
            if src and os.path.exists(src):
                shutil.copy(src, os.path.join(
                    folder, f"{role}{os.path.splitext(src)[1]}"))
                copied += 1
    return copied
