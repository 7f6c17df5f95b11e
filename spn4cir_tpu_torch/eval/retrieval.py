"""Gallery indexing, query prediction and the validation loops.

Counterpart of `spn4cir_tpu/eval/retrieval.py` (`GalleryIndex`,
`extract_index_features`, `generate_val_predictions`, `query_scores`,
`fiq_val_retrieval`, `cirr_val_retrieval`): the gallery is encoded in fixed-size
batches on one device; 'target' (score-ready) stays on the device and
'refer' (the fusion-side lookup) is kept in host memory as numpy. A
bfloat16 refer is kept as float32 on the host (numpy has no bfloat16); the
widening is exact, and the fusion upcasts it to float32 anyway. Query
reference features are gathered from the index by integer id (eval reuses
gallery features for references, never a fresh encode); ranking runs on the
device through `eval/metrics.py`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from spn4cir_tpu_torch.data.datasets import (CIRDataset, iter_gallery,
                                             iter_relative_eval)
from spn4cir_tpu_torch.data.prefetch import prefetch
from spn4cir_tpu_torch.eval import metrics as M
from spn4cir_tpu_torch.models.api import CIRBackbone
from spn4cir_tpu_torch.ops.bank_kernels import QuantBank
from spn4cir_tpu_torch.utils.tensors import to_host


def cache_file(path: str) -> str:
    """np.savez appends '.npz' to an extensionless path; the
    exists-check and the load must use the same resolved name."""
    return path if path.endswith(".npz") else path + ".npz"


@dataclasses.dataclass
class GalleryIndex:
    """Extracted gallery features: 'target' (device, score-ready, a tensor
    or a QuantBank) + 'refer' (host, fusion lookup) + names."""

    target: Union[torch.Tensor, QuantBank]
    refer: np.ndarray
    names: List[str]

    @property
    def device(self) -> torch.device:
        return self.target.device

    def refer_rows(self, gids: np.ndarray) -> torch.Tensor:
        rows = torch.from_numpy(self.refer[np.asarray(gids)])
        return rows.to(self.device)

    def save(self, path: str) -> None:
        path = cache_file(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if isinstance(self.target, QuantBank):
            extra = {"target": to_host(self.target.values),
                     "target_scales": to_host(self.target.scales)}
        else:
            extra = {"target": to_host(self.target)}
            if self.target.dtype == torch.bfloat16:
                extra["target_bf16"] = np.asarray(True)
        # uncompressed, as the bank cache (bank/bank.py): a blip4cir index
        # holds 577 x 768 float32 tokens per image
        np.savez(path, refer=self.refer, names=np.asarray(self.names),
                 **extra)

    @classmethod
    def load(cls, path: str, device="cpu") -> "GalleryIndex":
        data = np.load(cache_file(path))
        target = torch.from_numpy(data["target"]).to(device)
        if "target_scales" in data:
            target = QuantBank(target,
                               torch.from_numpy(data["target_scales"]).to(device))
        elif "target_bf16" in data:
            target = target.to(torch.bfloat16)
        return cls(target=target, refer=data["refer"],
                   names=[str(n) for n in data["names"]])


@torch.inference_mode()
def extract_index_features(backbone: CIRBackbone, dataset: CIRDataset,
                           batch_size: int = 32, num_workers: int = 4
                           ) -> GalleryIndex:
    """Encode the gallery of `dataset` on the backbone's device: host
    decode runs ahead in a prefetch thread; each batch is encoded, its
    valid rows copied into the host buffers; 'target' is moved back to the
    device once at the end."""
    device = backbone.device
    names = dataset.gallery_names
    bufs: Dict[str, np.ndarray] = {}
    for ids, images in prefetch(iter_gallery(dataset, batch_size, num_workers),
                                depth=2):
        out = backbone.index_features(torch.from_numpy(images).to(device))
        out = {k: to_host(v) for k, v in out.items()}
        if not bufs:
            bufs = {k: np.zeros((len(names), *v.shape[1:]), v.dtype)
                    for k, v in out.items()}
        valid = ids >= 0
        for k, v in out.items():
            bufs[k][ids[valid]] = v[valid]
    if not bufs:
        raise ValueError("empty gallery")
    return GalleryIndex(target=torch.from_numpy(bufs["target"]).to(device),
                        refer=bufs["refer"], names=list(names))


@torch.inference_mode()
def generate_val_predictions(backbone: CIRBackbone, dataset: CIRDataset,
                             index: GalleryIndex, batch_size: int = 32
                             ) -> Dict[str, np.ndarray]:
    """Queries -> fused features + id arrays. Reference features come from
    the gallery index. Returns query_feats, refer_gid, target_gid
    (+ member_gids, pairid for CIRR)."""
    device = index.device
    chunks, refer, target, members, pairids = [], [], [], [], []
    for batch in iter_relative_eval(dataset, batch_size,
                                    gallery_names=index.names):
        text_ids = torch.from_numpy(
            backbone.tokenize(batch["captions"])).to(device)
        out = backbone.fuse(index.refer_rows(batch["refer_gid"]), text_ids)
        chunks.append(to_host(out))
        refer.append(batch["refer_gid"])
        target.append(batch["target_gid"])
        if "member_gids" in batch:
            members.append(batch["member_gids"])
            pairids.append(batch["pairid"])
    out = {
        "query_feats": np.concatenate(chunks),
        "refer_gid": np.concatenate(refer),
        "target_gid": np.concatenate(target),
    }
    if members:
        out["member_gids"] = np.concatenate(members)
        out["pairid"] = np.concatenate(pairids)
    return out


def quantized_score_queries(queries: torch.Tensor, qbank: QuantBank
                            ) -> torch.Tensor:
    """Score against an int8 `QuantBank` gallery, dequantizing after the
    product (per-row scales factor out of the feature contraction): a flat
    (M, D) gallery by the cosine dot; a blip2 (M, Q, D) one by the max over
    q of the per-(m, q) scaled sims."""
    q = queries.float()
    if qbank.values.dim() == 3:
        sims = torch.einsum("bd,mqd->bmq", q, qbank.values.float())
        return (sims * qbank.scales[None]).amax(dim=-1)
    return (q @ qbank.values.float().T) * qbank.scales[None, :]


def query_scores(backbone: CIRBackbone, preds: Dict[str, np.ndarray],
                 index: GalleryIndex) -> torch.Tensor:
    feats = torch.from_numpy(preds["query_feats"]).to(index.device)
    if isinstance(index.target, QuantBank):
        return quantized_score_queries(feats, index.target)
    return backbone.score_queries(feats, index.target)


def _ids(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr)).to(device)


@torch.inference_mode()
def fiq_val_retrieval(backbone: CIRBackbone, data_path: str, dress_type: str,
                      preprocess, batch_size: int = 32,
                      index: Optional[GalleryIndex] = None,
                      fiq_val_type: int = 0) -> Dict[str, float]:
    # fiq_val_type selects the gallery image list (0=image_splits, 1=VAL-set
    # only); the relative query set is unaffected.
    classic = CIRDataset("fiq", "val", "classic", preprocess, data_path,
                         [dress_type], fiq_val_type=fiq_val_type)
    relative = CIRDataset("fiq", "val", "relative", preprocess, data_path,
                          [dress_type])
    if index is None:
        index = extract_index_features(backbone, classic, batch_size)
    preds = generate_val_predictions(backbone, relative, index, batch_size)
    scores = query_scores(backbone, preds, index)
    refer = (_ids(preds["refer_gid"], scores.device)
             if backbone.fiq_exclude_reference else None)
    return M.fiq_metrics(scores, _ids(preds["target_gid"], scores.device),
                         refer)


@torch.inference_mode()
def cirr_val_retrieval(backbone: CIRBackbone, data_path: str, preprocess,
                       batch_size: int = 32,
                       index: Optional[GalleryIndex] = None
                       ) -> Dict[str, float]:
    classic = CIRDataset("cirr", "val", "classic", preprocess, data_path)
    relative = CIRDataset("cirr", "val", "relative", preprocess, data_path)
    if index is None:
        index = extract_index_features(backbone, classic, batch_size)
    preds = generate_val_predictions(backbone, relative, index, batch_size)
    scores = query_scores(backbone, preds, index)
    dev = scores.device
    return M.cirr_metrics(scores, _ids(preds["target_gid"], dev),
                          _ids(preds["refer_gid"], dev),
                          _ids(preds["member_gids"], dev))
