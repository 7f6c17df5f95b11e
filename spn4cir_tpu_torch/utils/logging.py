"""Training observability: a line-oriented metric printer and step timing.

Counterpart of `MetricLogger` / `StepTimer` in
`spn4cir_tpu/utils/logging.py`.
"""

from __future__ import annotations

import json
import sys
import time


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
