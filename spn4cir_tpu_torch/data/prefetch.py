"""Async host-side batch prefetching.

The reference overlaps decode with GPU compute via DataLoader worker
processes (`clip4cir/train.py:77`); here a background thread keeps N batches
ahead of the device so image decode/tokenize never serializes with the
device step. A copy of `spn4cir_tpu/data/prefetch.py`."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

from spn4cir_tpu_torch.utils.logging import span

_SENTINEL = object()


def prefetch(iterator: Iterable, depth: int = 2) -> Iterator:
    """Run `iterator` in a daemon thread, buffering up to `depth` items.
    Exceptions propagate to the consumer at the failing position.

    Abandoning the generator (break / exception in the consumer) stops the
    worker: puts are bounded-timeout against a stop flag, and the wrapped
    iterator is closed so its own `finally` cleanup (e.g. thread-pool
    shutdown in iter_gallery) runs instead of leaking with the thread
    parked forever on a full queue.

    The consumer's wait for each item is the span `prefetch.wait`."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        it = iter(iterator)
        try:
            try:
                for item in it:
                    if not put(item):
                        return
            except BaseException as exc:  # propagate into the consumer
                put(exc)
                return
            put(_SENTINEL)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            with span("prefetch.wait"):
                item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
