"""Readings that the correctness limits are set from, on the GPU at the
cell's own size:

    python3 -m cirbench.calibrate --workload <cell> --program-seeds 1,2,... \
        --control-seeds 7,8,9 [--what control,half_batch,token]

For each program seed, one short run of the cell (its compared numbers);
for each control seed, the driver's `calibrate`: the control (the plain
reference in the precision below the configuration's) and the planted
faults, each put in the program's place. One JSON line per reading.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--what", default="control,half_batch,token")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)

    from cirbench import harness
    from cirbench.run import execute

    harness.setenv_caches()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda:0")
    seeds = [int(s) for s in args.program_seeds.split(",") if s]
    for seed in seeds:
        t0 = time.perf_counter()
        _, checks, ok, out = execute(cell, seed, args.seconds, False, device,
                                     t0)
        print(json.dumps({"reading": "program", "seed": seed,
                          "values": out["values"], "correct": ok,
                          "setup_s": out["setup_s"],
                          "detail": out.get("detail"),
                          "s": time.perf_counter() - t0}), flush=True)
    driver = importlib.import_module(f"cirbench.drivers.{cell.kind}")
    what = args.what.split(",")
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        for name, values in driver.calibrate(cell, seed, device, what).items():
            print(json.dumps({"reading": name, "seed": seed, "values": values,
                              "s": time.perf_counter() - t0}), flush=True)
    found = harness.forbidden_modules()
    print(json.dumps({"forbidden_modules": found}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
