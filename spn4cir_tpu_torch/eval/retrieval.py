"""Gallery indexing for the PyTorch port.

Counterpart of `GalleryIndex` and `extract_index_features` in
`spn4cir_tpu/eval/retrieval.py`: the gallery is encoded in fixed-size
batches on one device; 'target' (score-ready) stays on the device and
'refer' (the fusion-side lookup) is kept in host memory as numpy. A
bfloat16 refer is kept as float32 on the host (numpy has no bfloat16); the
widening is exact, and the fusion upcasts it to float32 anyway.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Union

import numpy as np
import torch

from spn4cir_tpu.data.datasets import CIRDataset, iter_gallery
from spn4cir_tpu.data.prefetch import prefetch
from spn4cir_tpu_torch.models.api import CIRBackbone
from spn4cir_tpu_torch.ops.bank_kernels import QuantBank


def cache_file(path: str) -> str:
    """np.savez_compressed appends '.npz' to an extensionless path; the
    exists-check and the load must use the same resolved name."""
    return path if path.endswith(".npz") else path + ".npz"


def to_host(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy on the host; bfloat16 widens (exactly) to float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


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
        np.savez_compressed(path, refer=self.refer,
                            names=np.asarray(self.names), **extra)

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
