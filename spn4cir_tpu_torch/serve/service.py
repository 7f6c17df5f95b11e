"""CIR retrieval serving for the PyTorch port: an in-process service and
its HTTP front-end.

Counterpart of `spn4cir_tpu/serve/service.py`, with the same HTTP surface
(`/retrieve`, `/gallery/add`, `/healthz`, `/metrics`). The gallery's scoring
features stay on the device; a query is tokenized on the host, fused and
scored on the device, and only the (B, k) top-k values and ids come back.

Every device dispatch runs under `self._lock`, from request threads and
from the batching worker alike; all of them use the backbone's device and
the thread's current (default) stream.
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

import numpy as np
import torch

from spn4cir_tpu_torch.eval.retrieval import (GalleryIndex,
                                              quantized_score_queries)
from spn4cir_tpu_torch.models.api import CIRBackbone
from spn4cir_tpu_torch.ops.bank_kernels import QuantBank, quantize_bank
from spn4cir_tpu_torch.utils.tensors import to_host


def _mask_rows(scores: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """Set scores[i, gids[i]] = -inf; gid -1 masks nothing for that row."""
    rows = torch.nonzero(gids >= 0).flatten()
    scores = scores.clone()
    scores[rows, gids[rows]] = float("-inf")
    return scores


def _round_up_k(k: int) -> int:
    """Bucket k (the JAX service does so to bound its top-k compilations;
    kept so both services return the same candidate lists)."""
    n = 16
    while n < k:
        n *= 2
    return n


class RetrievalService:
    """Composed-image-retrieval queries against a fixed gallery index."""

    def __init__(self, backbone: CIRBackbone, index: GalleryIndex,
                 preprocess=None, default_k: int = 10):
        self.backbone = backbone
        self.index = index
        self.preprocess = preprocess
        self.default_k = default_k
        self.device = backbone.device
        self._name2gid = {n: i for i, n in enumerate(index.names)}
        self._lock = threading.Lock()  # one device dispatch at a time
        # serializes gallery mutations (read->build->swap); queries only
        # snapshot self.index/self._name2gid and never take it
        self._mutate_lock = threading.Lock()
        # observability counters (GET /metrics); guarded by _lock
        self._stats = {"queries": 0, "dispatches": 0, "latency_ms_sum": 0.0}

    def metrics(self) -> dict:
        """Snapshot of serving counters + gallery facts."""
        with self._lock:
            stats = dict(self._stats)
        q = stats["queries"]
        total = stats.pop("latency_ms_sum")
        stats["latency_ms_avg"] = round(total / q, 3) if q else 0.0
        stats["gallery_size"] = len(self.index.names)
        stats["gallery_dtype"] = str(self.index.target.dtype).replace(
            "torch.", "")
        return stats

    def _record(self, n_queries: int, seconds: float) -> None:
        self._stats["queries"] += n_queries
        self._stats["dispatches"] += 1
        self._stats["latency_ms_sum"] += seconds * 1e3

    # -- gallery management --------------------------------------------------
    def refresh_index(self, index: GalleryIndex) -> None:
        """Atomically swap the gallery index (full reindex). In-flight
        queries finish against the old index; new ones see the new one."""
        name2gid = {n: i for i, n in enumerate(index.names)}
        with self._lock:
            self.index = index
            self._name2gid = name2gid

    def _index_features(self, images: np.ndarray):
        with self._lock, torch.inference_mode():
            return self.backbone.index_features(
                torch.from_numpy(images).to(self.device))

    def add_images(self, names: Sequence[str], images) -> int:
        """Append new gallery images: encode on the device, extend the index
        (names must be new). Returns the new gallery size."""
        if not isinstance(images, np.ndarray):
            if self.preprocess is None:
                raise RuntimeError("service built without a preprocess "
                                   "pipeline")
            images = np.stack([self.preprocess(im) for im in images])
        feats = self._index_features(images)
        # one mutation at a time: concurrent add_images must not build from
        # the same base snapshot (lost update)
        with self._mutate_lock:
            index = self.index
            dup = [n for n in names if n in self._name2gid]
            if dup:
                raise KeyError(f"gallery already contains {dup[:3]}...")
            new_index = self._extend_index(index, feats, names)
            self.refresh_index(new_index)
        return len(new_index.names)

    def _extend_index(self, index: GalleryIndex, feats, names: Sequence[str]
                      ) -> GalleryIndex:
        if isinstance(index.target, QuantBank):
            # per-row scales: quantizing the new rows alone is identical to
            # re-quantizing the whole grown gallery
            new = quantize_bank(feats["target"])
            target = QuantBank(
                torch.cat([index.target.values, new.values]),
                torch.cat([index.target.scales, new.scales]))
        else:
            target = torch.cat(
                [index.target, feats["target"].to(index.target.dtype)])
        return GalleryIndex(
            target=target,
            refer=np.concatenate([index.refer, to_host(feats["refer"])]),
            names=list(index.names) + list(names))

    # -- query paths --------------------------------------------------------
    def query_by_name(self, reference_name: str, caption: str,
                      k: Optional[int] = None) -> List[dict]:
        # snapshot: a concurrent refresh_index must not mix old gids with a
        # new gallery
        index, name2gid = self.index, self._name2gid
        gid = name2gid.get(reference_name)
        if gid is None:
            raise KeyError(f"unknown gallery image {reference_name!r}")
        return self._run(index, index.refer_rows(np.asarray([gid])), caption,
                         k, exclude_gid=gid)

    def query_by_image(self, image, caption: str,
                       k: Optional[int] = None) -> List[dict]:
        """image: PIL.Image or (H, W, 3) array; preprocessed + encoded live."""
        if self.preprocess is None:
            raise RuntimeError("service built without a preprocess pipeline")
        arr = image if isinstance(image, np.ndarray) else self.preprocess(image)
        refer = self._index_features(arr[None])["refer"]
        return self._run(self.index, refer, caption, k, exclude_gid=None)

    def _score_topk(self, index: GalleryIndex, queries: torch.Tensor,
                    gids: np.ndarray, kk: int):
        """Score `queries` against the gallery; return device (B, kk)
        (values, gids). Rows with gid < 0 exclude nothing."""
        if isinstance(index.target, QuantBank):
            scores = quantized_score_queries(queries, index.target)
        else:
            scores = self.backbone.score_queries(queries, index.target)
        gids = torch.from_numpy(np.asarray(gids, np.int64)).to(scores.device)
        return torch.topk(_mask_rows(scores, gids), kk, dim=-1)

    def _dispatch(self, index: GalleryIndex, refer: torch.Tensor,
                  captions: List[str], gids: np.ndarray, kk: int):
        """Tokenize, fuse, score and top-k one group of queries on the
        device, under the dispatch lock; returns host (values, ids)."""
        t0 = time.monotonic()
        with self._lock, torch.inference_mode():
            text = torch.from_numpy(self.backbone.tokenize(captions))
            queries = self.backbone.fuse(refer, text.to(self.device))
            vals, idx = self._score_topk(index, queries, gids, kk)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
            self._record(len(captions), time.monotonic() - t0)
        return vals, idx

    def _run(self, index: GalleryIndex, refer: torch.Tensor, caption: str,
             k: Optional[int], exclude_gid: Optional[int]) -> List[dict]:
        k = min(k or self.default_k, len(index.names))
        kk = min(_round_up_k(k), len(index.names))
        gid = -1 if exclude_gid is None else exclude_gid
        vals, idx = self._dispatch(index, refer, [caption], np.asarray([gid]),
                                   kk)
        return [{"name": index.names[int(i)], "score": float(v)}
                for i, v in zip(idx[0, :k], vals[0, :k])]


# ---------------------------------------------------------------------------
# HTTP front-end (stdlib; one process per card, scale behind any LB)
# ---------------------------------------------------------------------------

def make_handler(service: RetrievalService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok",
                                 "gallery_size": len(service.index.names)})
            elif self.path == "/metrics":
                self._send(200, service.metrics())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                if self.path == "/retrieve":
                    caption = req["caption"]
                    k = req.get("k")
                    if "reference_name" in req:
                        results = service.query_by_name(req["reference_name"],
                                                        caption, k)
                    elif "image_b64" in req:
                        from PIL import Image

                        raw = base64.b64decode(req["image_b64"])
                        results = service.query_by_image(
                            Image.open(io.BytesIO(raw)), caption, k)
                    else:
                        raise KeyError("need reference_name or image_b64")
                    self._send(200, {"results": results})
                elif self.path == "/gallery/add":
                    from PIL import Image

                    items = req["images"]  # {name: image_b64}
                    names = list(items)
                    images = [Image.open(io.BytesIO(base64.b64decode(b)))
                              for b in items.values()]
                    size = service.add_images(names, images)
                    self._send(200, {"status": "ok", "gallery_size": size})
                else:
                    self._send(404, {"error": "unknown path"})
            except KeyError as exc:
                self._send(400, {"error": str(exc)})
            except Exception as exc:  # the server must keep answering
                self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


class _Server(ThreadingHTTPServer):
    # the stdlib's listen backlog of 5 drops connections from a burst of
    # concurrent clients, which then retry after a TCP timeout (~1 s)
    request_queue_size = 128
    daemon_threads = True


def serve(service: RetrievalService, host: str = "0.0.0.0", port: int = 8080
          ) -> ThreadingHTTPServer:
    """Start the HTTP server on a background thread; returns the server
    (call .shutdown() and .server_close() to stop)."""
    server = _Server((host, port), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


class BatchingRetrievalService(RetrievalService):
    """Coalesces concurrent name-referenced queries into one fused+scored
    device dispatch (micro-batching; requests wait at most `max_delay_s`).
    Query-by-image requests take the base single-query path."""

    def __init__(self, *args, max_batch: int = 32, max_delay_s: float = 0.005,
                 **kw):
        super().__init__(*args, **kw)
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self._queue: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def query_by_name(self, reference_name: str, caption: str,
                      k: Optional[int] = None) -> List[dict]:
        index, name2gid = self.index, self._name2gid
        gid = name2gid.get(reference_name)
        if gid is None:
            raise KeyError(f"unknown gallery image {reference_name!r}")
        event = threading.Event()
        slot: dict = {}
        self._queue.put((index, gid, caption, k, event, slot))
        event.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["results"]

    def _loop(self):
        while True:
            first = self._queue.get()
            batch = [first]
            deadline = time.monotonic() + self.max_delay_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._run_batch(batch)
            except Exception as exc:  # propagate to still-waiting waiters
                for _, _, _, _, event, slot in batch:
                    if not event.is_set():
                        slot["error"] = exc
                        event.set()

    def _run_batch(self, batch):
        # a refresh between enqueue and dispatch splits the batch per index
        # snapshot so gids always match the gallery they came from
        by_index = {}
        for item in batch:
            by_index.setdefault(id(item[0]), []).append(item)
        for group in by_index.values():
            index = group[0][0]
            gids = np.asarray([item[1] for item in group])
            kmax = min(_round_up_k(max(
                min(item[3] or self.default_k, len(index.names))
                for item in group)), len(index.names))
            vals, idx = self._dispatch(index, index.refer_rows(gids),
                                       [item[2] for item in group], gids, kmax)
            for row, (_, _, _, k, event, slot) in enumerate(group):
                kk = min(k or self.default_k, len(index.names))
                slot["results"] = [
                    {"name": index.names[int(i)], "score": float(v)}
                    for i, v in zip(idx[row, :kk], vals[row, :kk])]
                event.set()
