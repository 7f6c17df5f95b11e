"""Multi-process input pipeline: N worker processes x native C++ decode
threads, shared-memory batch transport, in-order delivery.

Counterpart of `spn4cir_tpu/data/mploader.py`, in place of the reference's
torch DataLoader workers (clip4cir/train.py:77, num_workers=4) for the
host-bound scans: gallery indexing, bank extraction, stage-1 epochs. One
process tops out at the ~8 threads of `native.NativeLoader`; feeding a card
at its encode rate takes more cores, hence processes.

Design:
  * workers are spawn-context processes that import neither torch nor JAX:
    only numpy, PIL and the ctypes-bound native loader (the library the
    calling process built or found in `build/native/`); where it is
    unavailable or `SPN4CIR_NATIVE=0`, they decode with PIL on as many
    threads. They are started without re-running the
    parent's main module (spawn would import it again as `__mp_main__`,
    and with it torch): the worker's target lives here and needs nothing
    of it;
  * batches travel in `multiprocessing.shared_memory` blocks of (batch,
    dim, dim, 3) float32 (raw mode: (batch, canvas, canvas, 3) uint8),
    recycled through a free list: no allocation in the steady state;
  * requests carry sequence numbers and delivery keeps submission order, so
    the labels and captions held back in the calling process stay aligned;
  * a worker's exception comes back as the batch's result and raises in the
    caller; a worker that dies is detected instead of waited on forever.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import threading
import time
from multiprocessing import shared_memory, spawn
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np

from spn4cir_tpu_torch import native
from spn4cir_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD, RawBatch

_STOP = "__stop__"
_START_LOCK = threading.Lock()


def _start_without_main(procs) -> None:
    """Start spawn-context `procs` without the main-module entries of the
    preparation data, so a child does not import the parent's script."""
    with _START_LOCK:
        prepare = spawn.get_preparation_data

        def without_main(name):
            data = prepare(name)
            data.pop("init_main_from_name", None)
            data.pop("init_main_from_path", None)
            return data

        spawn.get_preparation_data = without_main
        try:
            for p in procs:
                p.start()
        finally:
            spawn.get_preparation_data = prepare


def _worker_main(task_q, result_q, shm_names, shape, kind, dim, ratio,
                 mean, std, threads, raw_canvas, use_native):
    """Worker body: decode batches of paths into shared-memory blocks, on
    `threads` threads (the native loader's where `use_native`, else a pool
    over PIL). With `raw_canvas` > 0 the blocks hold uint8 staging canvases
    and the (B, 2) extents ride the result queue."""
    from concurrent.futures import ThreadPoolExecutor

    if raw_canvas:
        fallback = _pil_raw_fallback(kind, raw_canvas, ratio)
        decoder = (native.NativeRawStager(kind, raw_canvas, ratio,
                                          num_threads=threads,
                                          fallback=fallback)
                   if use_native else None)
    else:
        fallback = _pil_fallback(kind, dim, ratio, mean, std)
        decoder = (native.NativeLoader(kind, dim, ratio, mean, std,
                                       num_threads=threads, fallback=fallback)
                   if use_native else None)
    pool = ThreadPoolExecutor(threads) if decoder is None else None
    shms = {name: shared_memory.SharedMemory(name=name) for name in shm_names}
    buf = None
    try:
        while True:
            item = task_q.get()
            if item == _STOP:
                break
            seq, shm_name, paths = item
            buf = np.ndarray(shape, np.uint8 if raw_canvas else np.float32,
                             buffer=shms[shm_name].buf)
            try:
                n = len(paths)
                extents = np.zeros((shape[0], 2), np.int32) if raw_canvas \
                    else None
                if decoder is None:
                    for i, out in enumerate(pool.map(fallback, paths)):
                        if raw_canvas:
                            buf[i], extents[i] = out
                        else:
                            buf[i] = out
                elif raw_canvas:
                    decoder.stage_batch(paths, buf[:n], extents[:n])
                else:
                    decoder.decode_batch(paths, buf[:n])
                result_q.put((seq, shm_name, n, extents, None))
            except Exception as exc:  # noqa: BLE001 - raised in the caller
                result_q.put((seq, shm_name, 0, None, repr(exc)))
    finally:
        buf = None  # a view of a block would keep it from closing
        for s in shms.values():
            s.close()
        if pool is not None:
            pool.shutdown()


def _pil_fallback(kind, dim, ratio, mean, std):
    from PIL import Image

    from spn4cir_tpu_torch.data.transforms import ImageTransform

    tf = ImageTransform(kind, dim, ratio, tuple(mean), tuple(std))
    return lambda path: tf(Image.open(path))


def _pil_raw_fallback(kind, canvas, ratio):
    from PIL import Image

    from spn4cir_tpu_torch.data.transforms import stage_raw_image

    def decode(path):
        arr = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        return stage_raw_image(arr, canvas, kind, ratio)

    return decode


class MPLoader:
    """Multi-process decode (+ preprocess) over one transform geometry.

    `map_batches(batches)` streams lists of image paths through the worker
    pool and yields (array, n_valid) in order: (B, dim, dim, 3) float32, or
    in raw mode a `RawBatch` of (B, C, C, 3) uint8 canvases and (B, 2)
    extents. The array is a view of a recycled shared-memory block, valid
    until the next step of the iteration: copy it (or move it to the
    device) before going on. A context manager; or call close().
    `threads_per_proc` 0 shares the host's cores among the workers."""

    def __init__(self, kind: str, dim: int, batch_size: int,
                 target_ratio: float = 1.25,
                 mean: Sequence[float] = CLIP_MEAN,
                 std: Sequence[float] = CLIP_STD,
                 num_procs: int = 4, threads_per_proc: int = 0,
                 prefetch: int = 2, raw_canvas: int = 0):
        self.raw_canvas = int(raw_canvas)
        side = self.raw_canvas or dim
        self.dtype = np.uint8 if self.raw_canvas else np.float32
        self.shape = (batch_size, side, side, 3)
        self.batch_size = batch_size
        nbytes = int(np.prod(self.shape)) * np.dtype(self.dtype).itemsize
        n_blocks = max(num_procs * prefetch + 2, 4)
        threads = threads_per_proc or max(1, (os.cpu_count() or 1)
                                          // num_procs)
        # decided (and built) here once: a worker that found no library
        # would try the compiler again, each in turn under the build lock
        use_native = native.native_enabled() and native.native_available()
        ctx = mp.get_context("spawn")
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        self._shms = {}
        self._procs = []
        self._closed = False
        for _ in range(n_blocks):
            shm = shared_memory.SharedMemory(create=True, size=nbytes)
            self._shms[shm.name] = shm
        self._free: "queue.SimpleQueue[str]" = queue.SimpleQueue()
        for name in self._shms:
            self._free.put(name)
        self._procs = [
            ctx.Process(
                target=_worker_main,
                args=(self._task_q, self._result_q, list(self._shms),
                      self.shape, kind, dim, target_ratio, tuple(mean),
                      tuple(std), threads, self.raw_canvas, use_native),
                daemon=True)
            for _ in range(num_procs)
        ]
        _start_without_main(self._procs)

    # -- streaming ---------------------------------------------------------

    def map_batches(self, batches: Iterable[Sequence[str]]
                    ) -> Iterator[Tuple[object, int]]:
        """Yield (array view or RawBatch, n_valid) per input batch, in
        order."""
        pending: dict = {}
        next_seq = 0
        submitted = 0
        it = iter(batches)
        exhausted = False
        held = None  # the block of the batch just yielded

        def submit_one() -> bool:
            nonlocal submitted, exhausted
            if exhausted:
                return False
            try:
                paths = list(next(it))
            except StopIteration:
                exhausted = True
                return False
            assert len(paths) <= self.batch_size, (len(paths), self.batch_size)
            block = self._free.get()  # in-flight batches are bounded by blocks
            self._task_q.put((submitted, block, paths))
            submitted += 1
            return True

        # prime up to the pool's depth, less the block the consumer holds
        for _ in range(len(self._shms) - 1):
            if not submit_one():
                break
        while next_seq < submitted:
            while next_seq not in pending:
                try:
                    seq, block, n, extents, err = self._result_q.get(
                        timeout=5.0)
                except queue.Empty:
                    # a killed or crashed worker raises nothing itself
                    dead = [p for p in self._procs if not p.is_alive()]
                    if dead:
                        raise RuntimeError(
                            f"{len(dead)} loader worker(s) died (exit codes "
                            f"{[p.exitcode for p in dead]}): a batch is lost")
                    continue
                pending[seq] = (block, n, extents, err)
            block, n, extents, err = pending.pop(next_seq)
            if err is not None:
                self._free.put(block)
                raise IOError(f"worker decode failed: {err}")
            arr = np.ndarray(self.shape, self.dtype,
                             buffer=self._shms[block].buf)
            if held is not None:
                self._free.put(held)  # the previous batch's block is free
            held = block
            next_seq += 1
            submit_one()
            yield (RawBatch(arr, extents) if self.raw_canvas else arr), n
        if held is not None:
            self._free.put(held)

    # -- lifecycle ---------------------------------------------------------

    def close(self):
        if self._closed:
            return
        self._closed = True
        for _ in self._procs:
            self._task_q.put(_STOP)
        # results of batches nobody asked for (an abandoned iteration) are
        # drained: a worker does not exit while its queue holds them
        deadline = time.monotonic() + 10
        for p in self._procs:
            while p.is_alive() and time.monotonic() < deadline:
                try:
                    while True:
                        self._result_q.get_nowait()
                except queue.Empty:
                    pass
                p.join(timeout=0.1)
            if p.is_alive():
                p.terminate()
                p.join()
        for s in self._shms.values():
            s.close()
            s.unlink()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


def batched_paths(paths: Sequence[str], batch_size: int) -> List[List[str]]:
    return [list(paths[i: i + batch_size])
            for i in range(0, len(paths), batch_size)]
