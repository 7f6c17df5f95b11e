"""Observability: a line-oriented metric printer, a profiler trace and the
program's spans.

`MetricLogger` and `profiler_trace` are the counterparts of those in
`spn4cir_tpu/utils/logging.py`. `span(name)` marks a stretch of host work
(`stage2.step`, `text.tokenize`, `bank.encode`, `serve.dispatch`, ...) as a
`torch.profiler.record_function` range, so it lands in the profiler's trace
on the same clock as the kernels and copies it issues. Spans are recorded
only while a profiler runs (`--profile_dir`, or a benchmark's traced
window); otherwise `span` hands back one shared no-op context.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler


class MetricLogger:
    """Line-oriented metric printer with step timing; emits one JSON object
    per log call so downstream tooling can parse training curves."""

    def __init__(self, stream=None, prefix: str = ""):
        self.stream = stream or sys.stdout
        self.prefix = prefix
        self._last = time.monotonic()

    def log(self, step: int, **metrics):
        now = time.monotonic()
        payload = {"step": step, "dt_s": round(now - self._last, 4), **metrics}
        if self.prefix:
            payload["tag"] = self.prefix
        self.stream.write(json.dumps(payload) + "\n")
        self.stream.flush()
        self._last = now


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """A `torch.profiler` trace of the block (host and, where there is a
    card, device activity), written under `logdir` as a Chrome trace
    (`<host>_<pid>.<time>.pt.trace.json`, TensorBoard's layout) when the
    block ends; nothing when `logdir` is empty. The host side covers every
    thread (loader threads, a service's request threads and batching
    worker), not only the caller's."""
    if not logdir:
        yield None
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
            experimental_config=torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)) as prof:
        yield prof


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` (layer-dotted, each name entered from
    one thread only) while the torch profiler records; the shared no-op
    context otherwise, which allocates nothing and dispatches no op. A
    profiler keeps the ranges of the thread that started it, or of every
    thread under `profiler_trace`."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN
