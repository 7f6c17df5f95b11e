"""Validation CLI of the PyTorch port: Recall on the validation split of
FashionIQ or CIRR, on one device.

Counterpart of `spn4cir_tpu/cli/validate.py`:

    python -m spn4cir_tpu_torch.cli.validate --dataset cirr \\
        --data_path cirr_dataset --clip-model-name RN50x4 --bf16 \\
        --model_path models/run/best.pt

An optional first word, `clip` (the default), `blip` or `blip2`, picks the
backbone and its recipe defaults. Runs on cuda:0 unless --device says
otherwise (`--device cpu` for the CPU).
`--mesh_data` / `--mesh_model` > 1 (a sharded indexing mesh) raise "not yet
ported".
"""

from __future__ import annotations

import json
from typing import Optional

from spn4cir_tpu_torch.cli.common import (
    backbone_from_argv,
    base_parser,
    finalize_args,
    load_or_init_params,
    make_backbone,
    make_transform,
    recipe_defaults,
    refuse_unported,
)
from spn4cir_tpu_torch.eval.metrics import fiq_average
from spn4cir_tpu_torch.eval.retrieval import (cirr_val_retrieval,
                                              fiq_val_retrieval)
from spn4cir_tpu_torch.utils.seeding import seed_everything


def validate_main(backbone_name: str = "clip", argv: Optional[list] = None,
                  tokenizer=None, **parser_kw):
    """Parse `argv`, build the backbone (weights from --model_path, else
    random from --seed) and return the validation metrics as a dict.
    `tokenizer` overrides the CLIP tokenizer the backbone would load."""
    args = base_parser(**(parser_kw or recipe_defaults(backbone_name))
                       ).parse_args(argv)
    finalize_args(args)
    refuse_mesh(args)
    generator = seed_everything(args.seed)

    backbone = make_backbone(backbone_name, args, tokenizer=tokenizer)
    preprocess = make_transform(backbone, args)
    load_or_init_params(backbone, args, generator)
    backbone.eval()

    if args.dataset == "cirr":
        results = cirr_val_retrieval(backbone, args.data_path, preprocess,
                                     batch_size=32)
    else:
        per_type = {}
        for dt in args.dress_types:
            per_type[dt] = fiq_val_retrieval(backbone, args.data_path, dt,
                                             preprocess, batch_size=32,
                                             fiq_val_type=args.fiq_val_type)
        results = {f"{dt}_{k}": v for dt, m in per_type.items()
                   for k, v in m.items()}
        results.update(fiq_average(list(per_type.values())))
    print(json.dumps(results, indent=2, sort_keys=True))
    return results


def refuse_mesh(args) -> None:
    refuse_unported(args, [
        ("--mesh_data/--mesh_bank/--mesh_model > 1",
         args.mesh_data > 1 or args.mesh_bank > 1 or args.mesh_model > 1),
        ("--distributed", args.distributed),
        ("--loader_procs (multi-process image loader)", args.loader_procs),
    ])


if __name__ == "__main__":
    import sys

    validate_main(*backbone_from_argv(sys.argv[1:]))
