"""Training observability: a line-oriented metric printer, a profiler
trace and step timing.

Counterpart of `MetricLogger`, `profiler_trace` and `StepTimer` in
`spn4cir_tpu/utils/logging.py`.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Optional

import torch


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
    block ends; nothing when `logdir` is empty."""
    if not logdir:
        yield None
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof


class StepTimer:
    """Rolling items/sec + step-time statistics. The caller ends each timed
    step with work that waits for the device (e.g. a host read or
    `torch.cuda.synchronize()`); this class only reads the host clock."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._t0 = None
        self._count = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, items: int = 1) -> float:
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append((dt, items))
        return dt

    @property
    def mean_step_s(self) -> float:
        if not self.times:
            return float("nan")
        return sum(t for t, _ in self.times) / len(self.times)

    @property
    def items_per_s(self) -> float:
        if not self.times:
            return float("nan")
        total_items = sum(n for _, n in self.times)
        total_time = sum(t for t, _ in self.times)
        return total_items / total_time
