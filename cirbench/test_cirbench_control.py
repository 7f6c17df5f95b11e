"""The controls, at a size a test run holds: the plain reference in the
precision below the configuration's (float8 for bfloat16), put in the
program's place, reads above the real cell's limits. The cells' limits
were set from the same readings on the GPU at the cells' own sizes
(PERF.md)."""

from __future__ import annotations

import json

import pytest

from conftest import REPO, TINY_CELLS, write_tiny_root

REAL = {  # tiny cell -> the real cell whose limits the control must fail
    "clip-tiny.stage2-tiny": "clip4cir-rn50x4.stage2-fullbank",
    "blip2-tiny.extract-tiny": "blip24cir-evag.extract-bank",
    "clip-tiny.serve-tiny": "clip4cir-rn50x4.serve-poisson",
}


@pytest.mark.parametrize("tiny", sorted(REAL))
def test_control_fails_a_limit(tmp_path, tiny):
    import importlib

    from cirbench import harness

    path = REPO / "cirbench" / "limits" / f"{REAL[tiny]}.json"
    if not path.exists():
        pytest.skip(f"{REAL[tiny]} is not a cell of this benchmark")
    limits = json.loads(path.read_text())
    root = write_tiny_root(tmp_path, {tiny: TINY_CELLS[tiny]})
    cell = harness.load_cell(tiny, root)
    driver = importlib.import_module(f"cirbench.drivers.{cell.kind}")
    control = driver.calibrate(cell, 31337, "cpu", ["control"])["control"]
    assert any(v > limits[k] for k, v in control.items()), (control, limits)
