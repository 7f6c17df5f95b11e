"""Generic image and text retrieval over a folder of images.

Counterpart of `spn4cir_tpu/eval/generic_retrieval.py` (reference
`zscir/retrieval.py`): encode a directory, JSON list or comma-separated
list of images with a CLIP backbone, rank image-to-image (i2i) or
text-to-image (t2i), and export one folder of ranked images per query.
The ranking is numpy `argpartition` then a sort of the k, as in the JAX
package, so tied scores come in the same order.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.ops.infonce import l2_normalize
from spn4cir_tpu_torch.utils.tensors import to_host


def list_images(source: str) -> List[str]:
    """A directory, a JSON list file, or a comma-separated list (ref
    zscir/retrieval.py:30-76 ImageDataset inputs)."""
    if os.path.isdir(source):
        exts = (".png", ".jpg", ".jpeg", ".webp")
        return sorted(
            os.path.join(source, f) for f in os.listdir(source)
            if f.lower().endswith(exts))
    if source.endswith(".json"):
        with open(source) as f:
            return json.load(f)
    return [s for s in source.split(",") if s]


@torch.inference_mode()
def encode_paths(backbone, paths: Sequence[str],
                 transform: Optional[ImageTransform] = None,
                 batch_size: int = 32) -> np.ndarray:
    """(N, D) float32 normalised gallery features of the images at `paths`,
    encoded on the backbone's device in batches of `batch_size`."""
    tf = transform or ImageTransform("clip", backbone.input_dim)
    feats = []
    for start in range(0, len(paths), batch_size):
        batch = np.stack([tf(Image.open(p))
                          for p in paths[start: start + batch_size]])
        feats.append(to_host(backbone.gallery_features(
            torch.from_numpy(batch).to(backbone.device))))
    return np.concatenate(feats)


def i2i_topk(query_feats: np.ndarray, gallery_feats: np.ndarray, k: int = 10,
             exclude_self: Optional[bool] = None) -> np.ndarray:
    """(Q, k) gallery indices, best first. exclude_self=None detects
    self-retrieval by array identity; a square score matrix alone is not
    evidence of it (a disjoint gallery of the query count keeps its
    diagonal)."""
    if exclude_self is None:
        exclude_self = query_feats is gallery_feats
    scores = query_feats @ gallery_feats.T
    if exclude_self:
        if scores.shape[0] != scores.shape[1]:
            raise ValueError(
                "exclude_self=True requires the query set to BE the gallery")
        np.fill_diagonal(scores, -np.inf)
    k = min(k, scores.shape[1])
    idx = np.argpartition(-scores, kth=k - 1, axis=1)[:, :k]
    order = np.take_along_axis(scores, idx, axis=1).argsort(axis=1)[:, ::-1]
    return np.take_along_axis(idx, order, axis=1)


@torch.inference_mode()
def t2i_topk(backbone, texts: Sequence[str], gallery_feats: np.ndarray,
             k: int = 10) -> np.ndarray:
    """(len(texts), k) gallery indices of the normalised text features."""
    ids = torch.from_numpy(np.asarray(backbone.tokenize(list(texts))))
    feats = l2_normalize(backbone.encode_text(
        ids.to(backbone.device)).float())
    return i2i_topk(to_host(feats), gallery_feats, k, exclude_self=False)


def export_results(query_paths: Sequence[str], gallery_paths: Sequence[str],
                   topk_idx: np.ndarray, out_dir: str) -> None:
    """One folder per query holding the query image and its ranked
    retrievals (ref zscir/retrieval.py:90-114)."""
    os.makedirs(out_dir, exist_ok=True)
    for qi, row in enumerate(topk_idx):
        folder = os.path.join(out_dir, f"query_{qi:04d}")
        os.makedirs(folder, exist_ok=True)
        if qi < len(query_paths) and os.path.exists(query_paths[qi]):
            shutil.copy(query_paths[qi], os.path.join(
                folder, "query" + os.path.splitext(query_paths[qi])[1]))
        for rank, gi in enumerate(row):
            src = gallery_paths[int(gi)]
            if os.path.exists(src):
                shutil.copy(src, os.path.join(
                    folder, f"rank{rank:02d}" + os.path.splitext(src)[1]))
