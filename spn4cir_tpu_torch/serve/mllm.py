"""The MLLM captioning service: captions over HTTP.

Counterpart of `spn4cir_tpu/serve/mllm.py`, the replacement for the
reference's vendored LLaVA serving stack (a controller, streaming model
workers and a gradio front, `zscir/llava/serve/`), whose CIR role is
"caption images over HTTP": one process per card, a worker that coalesces
concurrent requests into batched captioner calls (a batch of LLaVA
captions reads the 7B's weights once per decode step), and plain JSON over
HTTP.

Endpoints:
    GET  /healthz           -> {"status": "ok", "model": ...}
    GET  /metrics           -> request / image / batch counters
    POST /caption           -> {"image_b64": ..., "prompt"?: ...}
                               => {"caption": ...}
                               or {"images_b64": [...]} => {"captions": [...]}
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Sequence

import numpy as np


class CaptionService:
    """Micro-batching front for a `batched_fn(images, prompt=...)` captioner
    (datagen/captioner.py: make_llava_captioner / make_blip_captioner).

    Concurrent requests coalesce into one captioner call per prompt (the
    prompt is spliced into every row of a batch, so a batch holds one).
    Per-request prompts are taken only when `supports_prompt` (BLIP's
    decoder prompt is fixed). A failing prompt group fails only its own
    requests. `transform` maps a PIL image to the model's preprocessed
    array."""

    def __init__(self, batched_fn: Callable, transform,
                 model_name: str = "llava", *, max_batch: int = 8,
                 max_delay_s: float = 0.02,
                 default_prompt: Optional[str] = None,
                 supports_prompt: bool = True):
        import queue

        self.batched_fn = batched_fn
        self.transform = transform
        self.model_name = model_name
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.default_prompt = default_prompt
        self.supports_prompt = supports_prompt
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()  # counters; handler threads race
        self._requests = 0
        self._images = 0
        self._batches = 0
        self._seconds = 0.0
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- public ----------------------------------------------------------

    def caption(self, images: Sequence, prompt: Optional[str] = None
                ) -> List[str]:
        """PIL images (or preprocessed arrays) -> caption strings. Blocks
        until the coalescing worker dispatches the batch."""
        if prompt is not None and not self.supports_prompt:
            # BLIP's batched_fn has no prompt parameter (fixed decoder
            # prompt); reject HERE so one bad request can't poison a batch
            raise ValueError(
                f"model {self.model_name!r} does not take per-request "
                "prompts")
        arrays = [im if isinstance(im, np.ndarray)
                  else np.asarray(self.transform(im)) for im in images]
        event = threading.Event()
        slot: dict = {}
        self._queue.put((arrays, prompt, event, slot))
        with self._lock:
            self._requests += 1
        event.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["captions"]

    def metrics(self) -> dict:
        return {
            "model": self.model_name,
            "requests": self._requests,
            "images": self._images,
            "batches_dispatched": self._batches,
            "avg_images_per_batch": round(
                self._images / max(self._batches, 1), 2),
            "avg_batch_seconds": round(
                self._seconds / max(self._batches, 1), 4),
        }

    # -- worker ----------------------------------------------------------

    def _loop(self):
        import queue

        while True:
            first = self._queue.get()
            batch = [first]
            deadline = time.monotonic() + self.max_delay_s
            while sum(len(b[0]) for b in batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._run_batch(batch)
            except Exception as exc:  # backstop: never strand a waiter —
                # but never clobber requests a finished group delivered
                for _, _, event, slot in batch:
                    if not event.is_set():
                        slot["error"] = exc
                        event.set()

    def _run_batch(self, batch):
        # one captioner call per distinct prompt; requests sharing a
        # prompt ride the same call. A
        # group's failure reaches only ITS waiters (other prompts' requests
        # in the same coalesced batch still succeed).
        by_prompt: dict = {}
        for item in batch:
            key = item[1] if item[1] is not None else self.default_prompt
            by_prompt.setdefault(key, []).append(item)
        for prompt, group in by_prompt.items():
            images = [im for item in group for im in item[0]]
            try:
                t0 = time.monotonic()
                caps = (self.batched_fn(images) if prompt is None
                        else self.batched_fn(images, prompt=prompt))
                dt = time.monotonic() - t0
            except Exception as exc:
                for _, _, event, slot in group:
                    slot["error"] = exc
                    event.set()
                continue
            with self._lock:
                self._seconds += dt
                self._batches += 1
                self._images += len(images)
            lo = 0
            for arrays, _, event, slot in group:
                slot["captions"] = list(caps[lo: lo + len(arrays)])
                lo += len(arrays)
                event.set()


def make_caption_handler(service: CaptionService):
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
                                 "model": service.model_name})
            elif self.path == "/metrics":
                self._send(200, service.metrics())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                if self.path != "/caption":
                    self._send(404, {"error": "unknown path"})
                    return
                # classify client errors EXPLICITLY up front — exceptions
                # escaping from model internals (KeyError, ValueError,
                # whatever) must surface as 500s, not 400s
                if "images_b64" not in req and "image_b64" not in req:
                    self._send(400, {"error": "need image_b64 or "
                                              "images_b64"})
                    return
                prompt = req.get("prompt")
                if prompt is not None and not service.supports_prompt:
                    self._send(400, {"error": f"model "
                                     f"{service.model_name!r} does not "
                                     "take per-request prompts"})
                    return
                from PIL import Image

                try:
                    blobs = (req["images_b64"] if "images_b64" in req
                             else [req["image_b64"]])
                    images = [Image.open(io.BytesIO(base64.b64decode(b)))
                              for b in blobs]
                    for im in images:
                        im.load()  # force decode errors out HERE (-> 400)
                except Exception as exc:
                    self._send(400, {"error": f"undecodable image: {exc}"})
                    return
                caps = service.caption(images, prompt)
                if "images_b64" in req:
                    self._send(200, {"captions": caps})
                else:
                    self._send(200, {"caption": caps[0]})
            except Exception as exc:  # pragma: no cover
                self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


def serve_captions(service: CaptionService, host: str = "0.0.0.0",
                   port: int = 8081) -> ThreadingHTTPServer:
    """Start the captioning HTTP server on a background thread; returns the
    server (call .shutdown() to stop)."""
    server = ThreadingHTTPServer((host, port), make_caption_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server
