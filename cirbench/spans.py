"""Device-idle time put down to the program's spans.

The port marks its host work with `torch.profiler.record_function` ranges
(`spn4cir_tpu_torch/utils/logging.py:span`), which the traced window keeps
in `Trace.host` on the device intervals' clock. A reader takes the gaps
between the merged device intervals (kernels, copies, sets) of the window,
keeps the part of each gap that falls under the union of a set of spans,
and divides the sum by the number of spans of one unit name (`stage2.step`,
`bank.encode`) in the window. Idle before the first device interval and
after the last is not a gap.

The profiler slows the host, and by as much as the host's speed varies
between runs, so these readings rank the causes of the idle within one run;
between runs, compare each as a share of the window's idle (PERF.md gives
their run-to-run spread).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

Interval = Tuple[float, float]


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of `intervals` as sorted, disjoint (start, end) pairs."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def device_gaps(trace) -> List[Interval]:
    """The stretches between consecutive merged device intervals, in us."""
    busy = merged((s, s + d) for _, _, s, d in trace.device)
    return [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]


def overlap_us(gaps: List[Interval], cover: List[Interval]) -> float:
    """The length of the intersection of two sorted, disjoint lists."""
    total, j = 0.0, 0
    for a, b in gaps:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            total += min(b, cover[k][1]) - max(a, cover[k][0])
            k += 1
    return total


def idle_ms(trace, names: Iterable[str], unit: str) -> Optional[float]:
    """Device idle under the spans named `names`, in ms per `unit` span;
    None when the window has no device interval or no `unit` span."""
    units = sum(1 for name, _, _ in trace.host if name == unit)
    if not trace.device or units == 0:
        return None
    names = set(names)
    cover = merged((s, s + d) for name, s, d in trace.host if name in names)
    return overlap_us(device_gaps(trace), cover) / 1e3 / units
