"""CIRR test-server submission generation.

Counterpart of `spn4cir_tpu/eval/submission.py` (parity target:
`clip4cir/cirr_test_submission.py:19-164`), with a byte-compatible JSON
schema: `{"version": "rc2", "metric": "recall"}` plus pairid -> top-50
gallery names, and the `recall_subset` file with pairid -> top-3 subset
names, written to
`submission/<backbone>4cir/recall[_subset]_submission_<name>.json` with
sort_keys=True.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.eval import metrics as M
from spn4cir_tpu_torch.eval.retrieval import (
    GalleryIndex,
    extract_index_features,
    generate_val_predictions,
    query_scores,
)
from spn4cir_tpu_torch.models.api import CIRBackbone
from spn4cir_tpu_torch.utils.tensors import to_host


@torch.inference_mode()
def generate_cirr_test_dicts(
    backbone: CIRBackbone,
    dataset: CIRDataset,
    index: GalleryIndex,
    batch_size: int = 32,
) -> Tuple[Dict[str, List[str]], Dict[str, List[str]]]:
    preds = generate_val_predictions(backbone, dataset, index, batch_size)
    scores = query_scores(backbone, preds, index)
    refer = torch.from_numpy(preds["refer_gid"]).to(scores.device)
    members = torch.from_numpy(preds["member_gids"]).to(scores.device)
    top50 = to_host(M.topk_names(scores, refer, 50))
    top3 = to_host(M.subset_topk_names(scores, refer, members, 3))
    names = np.asarray(index.names)
    pairids = preds["pairid"]
    refer_np = np.asarray(preds["refer_gid"])
    # the reference REMOVES the masked reference row entirely; with k >=
    # gallery size the -inf-masked id would otherwise surface at the tail
    # of the list: invisible at CIRR scale (top-50 of ~2.3k), a schema
    # difference on small galleries
    pairid_to_pred = {
        str(int(pid)): names[row[row != rg]].tolist()
        for pid, rg, row in zip(pairids, refer_np, top50)
    }
    pairid_to_group = {
        str(int(pid)): names[row[row != rg]].tolist()
        for pid, rg, row in zip(pairids, refer_np, top3)
    }
    return pairid_to_pred, pairid_to_group


def generate_cirr_test_submissions(
    backbone: CIRBackbone,
    file_name: str,
    preprocess,
    data_path: str,
    output_root: str = "submission",
    subdir: Optional[str] = None,
    batch_size: int = 32,
) -> Tuple[str, str]:
    """Writes both submission JSONs; returns their paths."""
    classic = CIRDataset("cirr", "test1", "classic", preprocess, data_path)
    index = extract_index_features(backbone, classic, batch_size)
    relative = CIRDataset("cirr", "test1", "relative", preprocess, data_path)
    pred, group = generate_cirr_test_dicts(backbone, relative, index,
                                           batch_size)

    submission = {"version": "rc2", "metric": "recall"}
    group_submission = {"version": "rc2", "metric": "recall_subset"}
    submission.update(pred)
    group_submission.update(group)

    folder = os.path.join(output_root, subdir or f"{backbone.name}4cir")
    os.makedirs(folder, exist_ok=True)
    p1 = os.path.join(folder, f"recall_submission_{file_name}.json")
    p2 = os.path.join(folder, f"recall_subset_submission_{file_name}.json")
    with open(p1, "w") as f:
        json.dump(submission, f, sort_keys=True)
    with open(p2, "w") as f:
        json.dump(group_submission, f, sort_keys=True)
    return p1, p2
