"""Per-query case dumps from the command line: the port's counterpart of
`clip4cir/validate_case.py`. For each validation query it writes the
caption, the reference and target names, the target's rank and the top-10
retrieved names to `--cases_out` (one file per dress type for FashionIQ)
and prints one JSON line a file:

    python -m spn4cir_tpu_torch.cli.validate_case --dataset cirr \\
        --data_path <root> --clip-model-name RN50x4 --bf16 \\
        --model_path models/run/best.pt --cases_out cases/model.json

The flags are `cli.validate`'s plus `--cases_out`; an optional first word
picks the backbone (clip, the default, as in the JAX script). Runs on
cuda:0 unless --device says otherwise.
"""

from __future__ import annotations

import json
from typing import List, Optional

from spn4cir_tpu_torch.cli.common import (backbone_from_argv, base_parser,
                                          finalize_args, load_or_init_params,
                                          make_backbone, make_transform,
                                          recipe_defaults)
from spn4cir_tpu_torch.cli.validate import refuse_mesh
from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.eval.cases import dump_cases
from spn4cir_tpu_torch.eval.retrieval import extract_index_features
from spn4cir_tpu_torch.utils.seeding import seed_everything


def validate_case_main(backbone_name: str = "clip",
                       argv: Optional[list] = None, tokenizer=None
                       ) -> List[dict]:
    """Dump the cases; returns one summary per written file (dress type,
    queries, Recall@10 of the dump, path)."""
    parser = base_parser(**recipe_defaults(backbone_name))
    parser.add_argument("--cases_out", default="cases/model.json")
    args = parser.parse_args(argv)
    finalize_args(args)
    refuse_mesh(args)
    generator = seed_everything(args.seed)
    backbone = make_backbone(backbone_name, args, tokenizer=tokenizer)
    tf = make_transform(backbone, args)
    load_or_init_params(backbone, args, generator)
    backbone.eval()
    summaries = []
    for dt in (args.dress_types if args.dataset == "fiq" else [None]):
        kinds = [dt] if dt else None
        classic = CIRDataset(args.dataset, "val", "classic", tf,
                             args.data_path, kinds)
        relative = CIRDataset(args.dataset, "val", "relative", tf,
                              args.data_path, kinds)
        index = extract_index_features(backbone, classic, 32)
        out = (args.cases_out if not dt
               else args.cases_out.replace(".json", f".{dt}.json"))
        cases = dump_cases(backbone, relative, index, out)
        hits = sum(c["rank"] < 10 for c in cases)
        summary = {"dress_type": dt, "queries": len(cases),
                   "recall_at10": (100.0 * hits / len(cases)
                                   if cases else 0.0), "out": out}
        print(json.dumps(summary))
        summaries.append(summary)
    return summaries


if __name__ == "__main__":
    import sys

    validate_case_main(*backbone_from_argv(sys.argv[1:]))
