"""The span readers (`cirbench/spans.py` and the `*_idle_ms` metrics) on
hand-placed traces, and a traced CPU run whose host events hold the spans
each reader reads."""

from __future__ import annotations

import json
import time
import types

import pytest

from conftest import TINY_CELLS, write_tiny_root

STAGE2 = {"stage2.input_idle_ms": ("prefetch.wait", "stage2.gather_refer",
                                   "text.tokenize", "stage2.to_device"),
          "stage2.launch_idle_ms": ("stage2.forward", "stage2.backward"),
          "stage2.optimizer_idle_ms": ("stage2.optimizer",)}
EXTRACT = {"extract.encode_idle_ms": ("bank.encode",)}


def trace(device, host):
    from cirbench.trace import Trace

    return Trace([(f"k{i}", "kernel", a, b - a)
                  for i, (a, b) in enumerate(device)],
                 [(name, a, b - a) for name, a, b in host], 1.0)


def reading(name, tr):
    from cirbench import harness

    return harness.metric_reader(name)(types.SimpleNamespace(trace=tr))


# device busy [0, 20] (two kernels that overlap), [30, 40], [60, 70],
# [100, 110] (us): the gaps are [20, 30], [40, 60] and [70, 100]
DEVICE = [(0, 10), (5, 20), (30, 40), (60, 70), (100, 110)]
HOST = [
    ("stage2.step", 0, 50), ("stage2.step", 50, 120),
    # before the first device interval: no gap
    ("prefetch.wait", -10, -2),
    # half of [20, 30], then a span of the same group over it: [20, 28]
    ("prefetch.wait", 20, 25), ("text.tokenize", 22, 28),
    # over busy time only
    ("stage2.gather_refer", 0, 10),
    ("stage2.to_device", 45, 55),                  # 10 of [40, 60]
    # two spans of one group that overlap: [70, 90]
    ("stage2.forward", 70, 80), ("stage2.backward", 78, 90),
    ("stage2.optimizer", 35, 42), ("stage2.optimizer", 90, 95),   # 2 + 5
    ("bank.encode", 15, 35), ("bank.encode", 65, 105),           # 10 + 30
    ("bank.encode.vision", 66, 80),
]


@pytest.mark.parametrize("name, want_us", [
    ("stage2.input_idle_ms", (8 + 10) / 2),
    ("stage2.launch_idle_ms", 20 / 2),
    ("stage2.optimizer_idle_ms", (2 + 5) / 2),
    ("extract.encode_idle_ms", (10 + 30) / 2),
])
def test_idle_under_spans_by_hand(name, want_us):
    assert reading(name, trace(DEVICE, HOST)) == pytest.approx(want_us / 1e3)


def test_the_stage2_groups_cover_the_idle_they_name():
    """The three stage-2 groups are disjoint here: together they read the
    idle under their union, short of the gaps' 60 us by what no span
    covers."""
    from cirbench.spans import device_gaps, idle_ms

    tr = trace(DEVICE, HOST)
    assert sum(g[1] - g[0] for g in device_gaps(tr)) == 60
    parts = sum(reading(n, tr) for n in STAGE2)
    union = idle_ms(tr, [s for spans in STAGE2.values() for s in spans],
                    "stage2.step")
    assert parts == pytest.approx(union) == pytest.approx(45 / 2 / 1e3)


@pytest.mark.parametrize("name", sorted({**STAGE2, **EXTRACT}))
def test_none_without_device_events_or_spans(name):
    assert reading(name, trace([], HOST)) is None
    # the parent program: device work, no spans
    assert reading(name, trace(DEVICE, [("aten::to", 20, 30)])) is None


@pytest.mark.parametrize("cell, unit, groups", [
    ("clip-tiny.stage2-tiny", "stage2.step", STAGE2),
    ("blip2-tiny.extract-tiny", "bank.encode", EXTRACT),
])
def test_a_traced_run_holds_the_spans_each_reader_reads(tmp_path, cell, unit,
                                                        groups):
    from cirbench import harness
    from cirbench.run import execute

    root = write_tiny_root(tmp_path, {cell: TINY_CELLS[cell]})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name in groups:
        bench["per_layer"].append({
            "name": name, "unit": "ms", "better": "lower",
            "source": "device_trace", "layer": "a CPU test",
            "moves": bench["per_layer"][0]["moves"], "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.load_cell(cell, root)
    line, _, ok, out = execute(c, 2 ** 31 + 977, 1.0, True, "cpu",
                               time.perf_counter())
    assert ok
    names = {name for name, _, _ in out["trace"].host}
    assert unit in names
    for spans in groups.values():
        assert set(spans) <= names, set(spans) - names
    # a CPU window has no device intervals: each reader is silent
    assert not set(groups) & set(json.loads(line)["metrics"])
