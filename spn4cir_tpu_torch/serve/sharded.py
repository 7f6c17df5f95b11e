"""Multi-GPU serving: the gallery split into row shards over a list of
devices, with an exact two-stage top-k.

Counterpart of `spn4cir_tpu/serve/sharded.py`. The single-device
`RetrievalService` holds the whole score-ready gallery on one card, which
caps its size. Here one process (a single controller, as the JAX service
is) holds the gallery as n row shards, shard i on `devices[i]` (a list
that may repeat a device), and answers a query batch in two stages:

  1. every shard scores the queries on its own device
     (`backbone.score_queries`, or `quantized_score_queries` over int8),
     masks its padding rows and each query's own gallery id, and takes a
     local top-kk with its row ids made global by the shard's offset: only
     (B, kk) candidates leave a shard, never the (B, M) scores;
  2. the candidates move to the first device, where a final top-k merges
     them.

Exactness: each true global top-kk row ranks within kk in its own shard,
so it survives stage 1; ties come lowest global index first, as
`eval.metrics.topk_lowest_index_first` orders them (lowest shard, then
lowest local row), the order of `jax.lax.top_k` and of the single-device
service. Flat (M, D) galleries and blip2's (M, 32, 256) max-over-query
galleries shard alike: `score_queries` is row-wise. The backbone (fusion)
lives on the first device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from spn4cir_tpu_torch.eval.metrics import topk_lowest_index_first
from spn4cir_tpu_torch.eval.retrieval import quantized_score_queries
from spn4cir_tpu_torch.ops.bank_kernels import QuantBank, quantize_bank
from spn4cir_tpu_torch.parallel.mesh import pad_bank_rows
from spn4cir_tpu_torch.serve.service import (BatchingRetrievalService,
                                             RetrievalService)
from spn4cir_tpu_torch.utils.tensors import to_host


def _host(target):
    """A CPU copy of a gallery target (a tensor or a QuantBank)."""
    if isinstance(target, QuantBank):
        return QuantBank(target.values.cpu(), target.scales.cpu())
    return target.cpu()


@dataclasses.dataclass
class ShardedGalleryIndex:
    """The gallery as row shards: `shards[i]` (rows [i·M_loc, (i+1)·M_loc)
    of the target padded to a multiple of the shard count) on
    `devices[i]`; `host_target` keeps the unpadded rows on the host, so a
    mutation (add_images, refresh) rebuilds the shards without a device
    round trip; `refer` (the fusion lookup) and `names` as in
    `GalleryIndex`."""

    shards: List[object]
    devices: List[torch.device]
    refer: np.ndarray
    names: List[str]
    host_target: object

    @property
    def target(self):
        """The unpadded gallery rows (host): what `metrics()` reads."""
        return self.host_target

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def refer_rows(self, gids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(self.refer[np.asarray(gids)]).to(
            self.devices[0])

    @classmethod
    def from_arrays(cls, host_target, refer: np.ndarray,
                    names: Sequence[str], devices: Sequence
                    ) -> "ShardedGalleryIndex":
        """host_target: (M, ...) CPU tensor, or a QuantBank of CPU tensors
        (values and per-row scales shard together)."""
        devices = [torch.device(d) for d in devices]
        n = len(devices)
        m = host_target.shape[0]
        if m != len(names):
            raise ValueError(f"{m} gallery rows, {len(names)} names")
        padded = pad_bank_rows(host_target, n)
        m_local = padded.shape[0] // n

        def rows(t, i):
            return t[i * m_local:(i + 1) * m_local].to(devices[i]).contiguous()

        if isinstance(padded, QuantBank):
            shards = [QuantBank(rows(padded.values, i), rows(padded.scales, i))
                      for i in range(n)]
        else:
            shards = [rows(padded, i) for i in range(n)]
        return cls(shards, devices, refer, list(names), host_target)

    @classmethod
    def from_index(cls, index, devices: Sequence) -> "ShardedGalleryIndex":
        return cls.from_arrays(_host(index.target), index.refer, index.names,
                               devices)


class ShardedRetrievalService(RetrievalService):
    """`RetrievalService` over a gallery sharded on `devices`. Takes a
    `GalleryIndex` (sharded on entry) or a prebuilt `ShardedGalleryIndex`;
    the backbone lives on `devices[0]`."""

    def __init__(self, backbone, index, devices: Sequence, preprocess=None,
                 default_k: int = 10):
        self.devices = [torch.device(d) for d in devices]
        if not isinstance(index, ShardedGalleryIndex):
            index = ShardedGalleryIndex.from_index(index, self.devices)
        super().__init__(backbone, index, preprocess=preprocess,
                         default_k=default_k)

    # -- gallery management --------------------------------------------------
    def refresh_index(self, index) -> None:
        if not isinstance(index, ShardedGalleryIndex):
            index = ShardedGalleryIndex.from_index(index, self.devices)
        super().refresh_index(index)

    def _extend_index(self, index, feats, names: Sequence[str]):
        host = index.host_target
        if isinstance(host, QuantBank):
            new = _host(quantize_bank(feats["target"]))
            grown = QuantBank(torch.cat([host.values, new.values]),
                              torch.cat([host.scales, new.scales]))
        else:
            grown = torch.cat([host, feats["target"].cpu().to(host.dtype)])
        return ShardedGalleryIndex.from_arrays(
            grown, np.concatenate([index.refer, to_host(feats["refer"])]),
            list(index.names) + list(names), self.devices)

    # -- two-stage top-k -----------------------------------------------------
    def _score_topk(self, index, queries: torch.Tensor, gids: np.ndarray,
                    kk: int):
        m_actual = len(index.names)
        first = index.devices[0]
        gid_t = torch.from_numpy(np.asarray(gids, np.int64))
        vals, ids = [], []
        offset = 0
        for shard, dev in zip(index.shards, index.devices):
            m_local = shard.shape[0]
            q = queries.to(dev)
            scores = (quantized_score_queries(q, shard)
                      if isinstance(shard, QuantBank)
                      else self.backbone.score_queries(q, shard))
            rows = offset + torch.arange(m_local, device=dev)
            drop = (rows[None, :] >= m_actual) | (
                rows[None, :] == gid_t.to(dev)[:, None])
            scores = scores.masked_fill(drop, float("-inf"))
            v, i = topk_lowest_index_first(scores, min(kk, m_local))
            vals.append(v.to(first))
            ids.append((i + offset).to(first))
            offset += m_local
        vals, ids = torch.cat(vals, dim=1), torch.cat(ids, dim=1)
        merged, pos = topk_lowest_index_first(vals, kk)
        return merged, ids.gather(1, pos)


class ShardedBatchingRetrievalService(BatchingRetrievalService,
                                      ShardedRetrievalService):
    """Micro-batching over the sharded gallery: concurrent queries coalesce
    into one fuse + two-stage top-k dispatch. Construct with (backbone,
    index, devices, preprocess=, default_k=, max_batch=, max_delay_s=)."""
