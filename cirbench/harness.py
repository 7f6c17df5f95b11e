"""What every cell shares: finding a cell's files by name, seeds, the
device line, the import check and the result line.

A cell is a `workloads` entry of `BENCHMARK.json`. Its configuration is the
file the entry's `configs` record names, its traffic mix is
`cirbench/traffic/<traffic>.json`, its correctness limits are
`cirbench/limits/<cell>.json`, and each per-layer metric is the reader
`cirbench/metrics/<metric>.py`. Nothing here names a cell, so a new cell is
new files and a new `workloads` entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

#: top-level module names that may not be loaded in a benchmark process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "spn4cir_tpu")

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    chips: int

    @property
    def kind(self) -> str:
        return self.traffic["driver"]


def _read_json(path: Path) -> Any:
    with open(path) as fh:
        return json.load(fh)


def reports(metric: Dict[str, Any], cell: str) -> bool:
    """Whether `cell` reports `metric`: every cell, or those it lists."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` with its files."""
    bench = _read_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in {root / 'BENCHMARK.json'}; "
                         f"have {sorted(work)}")
    entry = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[entry["config"]]["file"])
    traffic = _read_json(root / "cirbench" / "traffic"
                         / f"{entry['traffic']}.json")
    limits_file = root / "cirbench" / "limits" / f"{name}.json"
    limits = _read_json(limits_file) if limits_file.exists() else {}
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if reports(m, name)]
    return Cell(name, root, config, traffic, limits, e2e, per_layer,
                int(entry["chips"]))


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """`read(readings)` of `cirbench/metrics/<name>.py`, loaded by path."""
    path = root / "cirbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "cirbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of the run (weights, bank, traffic...),
    from the run's `--seed` (any whole number) and the stream's tags."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, *tags]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def forbidden_modules() -> List[str]:
    """Top-level names in `sys.modules` that equal a forbidden name,
    compared whole: `spn4cir_tpu_torch` is not `spn4cir_tpu`."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def device_line(torch, count: int, peak_bytes: int) -> Dict[str, Any]:
    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:  # the CPU tests' runs
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": count,
            "memory_peak_bytes": int(peak_bytes)}


@dataclasses.dataclass
class Check:
    """One number compared with its limit: correct while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def judge(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """Each number the cell's limits file names, beside its limit; the
    driver's other numbers are not compared. A named number the run did not
    produce, or a cell without limits, fails."""
    if not limits:
        return [Check("limits_file", float("inf"), 0.0)]
    return [Check(k, float(values.get(k, float("inf"))), float(v))
            for k, v in limits.items()]


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict[str, Any]], device: Dict[str, Any],
                checks: List[Check], breakdown: Optional[dict] = None
                ) -> str:
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics,
                           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return json.dumps(out)


def print_checks(checks: List[Check]) -> None:
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()


def scratch_dir() -> str:
    """A directory for this run's traces, under the run's TMPDIR."""
    import tempfile

    return tempfile.mkdtemp(prefix="cirbench-")


def setenv_caches(root: Path = ROOT) -> None:
    """Keep every compile cache a library might write inside the checkout,
    at fixed paths, and keep `transformers` from loading JAX."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


#: the launch counters of the port's kernel wrappers, by wrapper
COUNTED = {"short_attention": "attention_kernels",
           "short_attention_bwd": "attention_kernels",
           "long_attention": "attention_kernels",
           "long_attention_bwd": "attention_kernels",
           "bank_infonce_fwd": "bank_kernels",
           "bank_infonce_bwd": "bank_kernels",
           "max_query_infonce_fwd": "maxquery_kernels",
           "max_query_infonce_bwd": "maxquery_kernels"}


def read_counters(reset: bool = False) -> Dict[str, int]:
    """The program's launch counters (`fn.launches` of each `ops/` wrapper);
    with `reset`, their values before they are set to 0."""
    out = {}
    for name, module in COUNTED.items():
        mod = importlib.import_module(f"spn4cir_tpu_torch.ops.{module}")
        fn = getattr(mod, name)
        out[name] = int(getattr(fn, "launches", 0))
        if reset:
            fn.launches = 0
    return out
