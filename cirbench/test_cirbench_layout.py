"""BENCHMARK.json against the contract's shape, every cell's files found by
name, and a throwaway cell added with new files and a new entry alone."""

from __future__ import annotations

import json
import re
import shutil

from conftest import REPO, TINY_CELLS, drive, write_tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def bench():
    with open(REPO / "BENCHMARK.json") as fh:
        return json.load(fh)


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == TOP_KEYS
    assert b["paths"] == ["cirbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert all(isinstance(w, str) and not w.startswith("/") and ".." not in w
               for w in b["command"])


def test_names_and_units_use_allowed_characters():
    b = bench()
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in b[section]:
            assert NAME.match(entry["name"]), entry["name"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_cell_finds_its_files_by_name():
    from cirbench import harness

    b = bench()
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.limits, f"{w['name']} has no limits file"
        assert (REPO / "cirbench" / "drivers" / f"{cell.kind}.py").exists()
        for m in cell.per_layer:
            assert callable(harness.metric_reader(m["name"]))
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in moved or cell in moved["workloads"]


def test_a_new_cell_is_new_files_and_an_entry(tmp_path):
    """A throwaway configuration, mix, metric and limits file, and a
    `workloads` entry naming them: the harness runs it with no edit."""
    root = write_tiny_root(tmp_path, {
        "clip-tiny.stage2-tiny": TINY_CELLS["clip-tiny.stage2-tiny"]})
    shutil.copy(root / "cirbench" / "configs" / "clip-tiny.json",
                root / "cirbench" / "configs" / "clip-other.json")
    traffic = json.loads((root / "cirbench" / "traffic" /
                          "stage2-tiny.json").read_text())
    traffic["batch"] = 4
    (root / "cirbench" / "traffic" / "stage2-small.json").write_text(
        json.dumps(traffic))
    (root / "cirbench" / "limits" / "clip-other.stage2-small.json").write_text(
        json.dumps({"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}))
    (root / "cirbench" / "metrics" / "steps_seen.py").write_text(
        "def read(r):\n    return float(r.attempted)\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "clip-other", "source": "https://example.org",
                         "file": "cirbench/configs/clip-other.json",
                         "reduced": [], "why": "a throwaway"})
    b["workloads"].append({"name": "clip-other.stage2-small",
                           "config": "clip-other", "traffic": "stage2-small",
                           "chips": 1, "why": "a throwaway"})
    for m in b["end_to_end"]:
        if m["name"] == "stage2_step_ms":
            m["workloads"].append("clip-other.stage2-small")
    b["per_layer"].append({"name": "steps_seen", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "a throwaway", "moves": "stage2_step_ms",
                           "workloads": ["clip-other.stage2-small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    ok, _, line = drive(root, "clip-other.stage2-small", trace=True)
    assert ok
    assert line["metrics"]["steps_seen"]["value"] > 0
