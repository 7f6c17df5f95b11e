"""Model-against-model case comparison from the command line: the port's
counterpart of `clip4cir/analysis_case.py`. It reads two case dumps of
`cli.validate_case`, lists the queries where model A fails (rank >=
`--fail_rank`) and model B wins (rank <= `--win_rank`), and with
`--name_to_path` copies their images into `--out_dir`:

    python -m spn4cir_tpu_torch.cli.analysis_case --cases_a cases/a.json \\
        --cases_b cases/b.json --name_to_path names.json
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

from spn4cir_tpu_torch.eval.cases import compare_cases, export_case_images


def main(argv: Optional[list] = None) -> List[dict]:
    """Returns the cases where A fails and B wins."""
    p = argparse.ArgumentParser()
    p.add_argument("--cases_a", required=True, help="model A case dump (fails)")
    p.add_argument("--cases_b", required=True, help="model B case dump (wins)")
    p.add_argument("--fail_rank", type=int, default=10)
    p.add_argument("--win_rank", type=int, default=0)
    p.add_argument("--out_dir", default="cases/compare")
    p.add_argument("--name_to_path", default="", help="JSON {name: image path}")
    p.add_argument("--limit", type=int, default=50)
    args = p.parse_args(argv)
    with open(args.cases_a) as f:
        a = json.load(f)
    with open(args.cases_b) as f:
        b = json.load(f)
    wins = compare_cases(a, b, args.fail_rank, args.win_rank)
    print(f"{len(wins)} queries where A fails and B wins")
    if args.name_to_path:
        with open(args.name_to_path) as f:
            n2p = json.load(f)
        n = export_case_images(wins, n2p, args.out_dir, args.limit)
        print(f"exported {n} images to {args.out_dir}")
    return wins


if __name__ == "__main__":
    main()
