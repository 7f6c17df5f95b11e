"""Run one cell of the benchmark of `spn4cir_tpu_torch` on this machine's GPU.

    python3 -m cirbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. `--trace 0` prints the cell's end-to-end
metrics, `--trace 1` its per-layer metrics from a profiler window after the
measured one. Either way the run checks the timed path's output against the
plain reference and prints each compared number beside its limit, on
standard error and under `checks` at the end of the result, which is the
last line of standard output. `--sweep` (serve cells) offers rising rates
once and prints what each sustained, for choosing the cell's rate; it
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from typing import Any, Dict, Sequence, Tuple  # noqa: E402


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, faults: Sequence[str] = ()
            ) -> Tuple[str, list, bool, Dict[str, Any]]:
    """Drive `cell` once: (result line, checks, correct, driver output)."""
    import torch

    from cirbench import harness
    from cirbench.trace import cleanup

    scratch = harness.scratch_dir()
    try:
        driver = importlib.import_module(f"cirbench.drivers.{cell.kind}")
        out = driver.run(cell, seed, seconds, trace, device, t_start,
                         scratch, faults)
    finally:
        cleanup(scratch)
    checks = harness.judge(out["values"], cell.limits)
    correct = all(c.ok for c in checks) and out["failed"] == 0
    dev = harness.device_line(torch, cell.chips, out["memory_peak_bytes"])
    breakdown = None
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        for m in cell.end_to_end:
            value = (out["setup_s"] if m["name"] == "setup_s"
                     else out["end_to_end"][m["name"]])
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        tr = out["trace"]
        readings = types.SimpleNamespace(cell=cell, trace=tr, **{
            k: v for k, v in out.items() if k not in ("trace",)})
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"], cell.root)(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    line = harness.result_line(correct, out["attempted"], out["failed"],
                               metrics, dev, checks, breakdown)
    return line, checks, correct, out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--sweep", default="",
                   help="serve cells: comma-separated rates to offer once")
    args = p.parse_args(argv)

    from cirbench import harness

    harness.setenv_caches()
    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("cirbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"cirbench: the cell needs {cell.chips} GPUs, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    if args.sweep:
        from cirbench.drivers import serve

        if cell.kind != "serve":
            print("cirbench: --sweep is for serve cells", file=sys.stderr)
            return 2
        rates = [float(r) for r in args.sweep.split(",")]
        for row in serve.sweep(cell, args.seed, args.seconds, rates, device):
            print(json.dumps(row), flush=True)
        return 0
    line, checks, _, out = execute(cell, args.seed, args.seconds,
                                   bool(args.trace), device, T_START)
    if "counters" in out:
        print("launches " + json.dumps(out["counters"]), flush=True)
    for note in out.get("notes", ()):
        print(note, flush=True)
    if "detail" in out:
        print("detail " + json.dumps(out["detail"]), flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"cirbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    harness.print_checks(checks)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
