"""The plain references against the port at tiny widths on the CPU, one cell
per driver kind, and the faults the check has to catch: each run drives the
whole harness with the CUDA check skipped."""

from __future__ import annotations

import pytest

from conftest import TINY_CELLS, drive


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_reference_agrees_with_the_port(tiny_root, cell):
    ok, values, line = drive(tiny_root, cell)
    assert ok, values
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("cell,fault", [
    ("clip-tiny.stage2-tiny", "unchanged"),
    ("clip-tiny.stage2-tiny", "half_batch"),
    ("clip-tiny.stage2-tiny", "token"),
    ("blip2-tiny.stage2mq-tiny", "unchanged"),
    ("blip2-tiny.stage2mq-tiny", "half_batch"),
    ("blip2-tiny.stage2mq-tiny", "token"),
    ("blip2-tiny.extract-tiny", "answer"),
    ("blip2-tiny.extract-tiny", "half_batch"),
    ("clip-tiny.serve-tiny", "answer"),
    ("clip-tiny.serve-tiny", "half_batch"),
])
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault):
    ok, values, _ = drive(tiny_root, cell, faults=(fault,))
    assert not ok, values


def test_traced_run_reads_its_metrics(tiny_root):
    ok, _, line = drive(tiny_root, "clip-tiny.stage2-tiny", trace=True)
    assert ok
    assert line["metrics"]["stage2_mfu"]["value"] > 0
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checks"
