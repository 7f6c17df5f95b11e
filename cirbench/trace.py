"""The traced run's profiler window and what the per-layer readers take from
it: device intervals by name, the union of the busy ones, the longest idle
gaps with what the host was doing, and the top device operations.

Device busy is the union of the kernel, memcpy and memset intervals of a
`torch.profiler` chrome trace (the method of the port's `chip_smoke.py`
`device_busy`). The trace file is written under the run's TMPDIR and
deleted once read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: a name in the breakdown is cut to this many characters
NAME_CHARS = 160
HOST_CATS = ("cpu_op", "python_function", "user_annotation", "cuda_runtime",
             "cuda_driver")


@dataclasses.dataclass
class Trace:
    device: List[Tuple[str, str, float, float]]  # (name, cat, start us, dur us)
    host: List[Tuple[str, float, float]]         # (name, start us, dur us)
    window_s: float                              # host clock of the window

    @property
    def busy_s(self) -> float:
        spans = sorted((s, s + d) for _, _, s, d in self.device)
        busy, end = 0.0, float("-inf")
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy / 1e6

    def kernel_s(self, *needles: str) -> float:
        """Summed device time of the kernels whose name holds a needle."""
        return sum(d for name, cat, _, d in self.device
                   if cat == "kernel" and any(n in name for n in needles)) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, _, _, d in self.device:
            by[name] = by.get(name, 0.0) + d / 1e6
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])][:n]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest gaps between device intervals, each named by the
        innermost host event running at its middle."""
        spans = sorted((s, s + d) for _, _, s, d in self.device)
        gaps, end = [], None
        for a, b in spans:
            if end is not None and a > end:
                gaps.append((a - end, end, a))
            end = b if end is None else max(end, b)
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:n]:
            mid = (a + b) / 2
            inner = [(d, name) for name, s, d in self.host if s <= mid <= s + d]
            if inner:
                label = min(inner)[1]
            else:
                before = [(s + d, name) for name, s, d in self.host
                          if s + d <= mid]
                label = ("host Python after " + max(before)[1] if before
                         else "host Python")
            out.append([label[:NAME_CHARS], length / 1e6])
        return out


def _parse(path: str) -> Tuple[list, list]:
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((ev.get("name", ""), cat, float(ev["ts"]),
                           float(ev["dur"])))
        elif cat in HOST_CATS:
            host.append((ev.get("name", ""), float(ev["ts"]), float(ev["dur"])))
    return device, host


def profile_window(fn: Callable[[], object], scratch: str) -> Trace:
    """Run `fn` under the profiler, CPU and CUDA, and read the trace
    back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    path = os.path.join(scratch, "trace.json")
    prof.export_chrome_trace(path)
    device, host = _parse(path)
    os.remove(path)
    return Trace(device, host, window)


def cleanup(scratch: str) -> None:
    shutil.rmtree(scratch, ignore_errors=True)
