"""Validation CLI of the PyTorch port: Recall on the validation split of
FashionIQ or CIRR, on one device.

Counterpart of `spn4cir_tpu/cli/validate.py`:

    python -m spn4cir_tpu_torch.cli.validate --dataset cirr \\
        --data_path cirr_dataset --clip-model-name RN50x4 --bf16 \\
        --model_path models/run/best.pt

An optional first word, `clip` (the default), `blip` or `blip2`, picks the
backbone and its recipe defaults. Runs on cuda:0 unless --device says
otherwise (`--device cpu` for the CPU). `--mesh_data` / `--mesh_model` > 1
(or `--distributed`) index the gallery over several ranks, one process per
GPU launched by torchrun or the `SPN4CIR_DIST_*` variables: its images
split over the data axis and the towers tensor-parallel over the model
axis (`eval.retrieval.extract_index_features(mesh=)`); rank 0 prints.
"""

from __future__ import annotations

import json
from typing import Optional

from spn4cir_tpu_torch.cli.common import (
    backbone_from_argv,
    base_parser,
    finalize_args,
    encode_mesh,
    load_or_init_params,
    make_backbone,
    make_transform,
    recipe_defaults,
    setup_distributed,
)
from spn4cir_tpu_torch.parallel.mesh import broadcast_module, process_is_main
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
    backbone, preprocess, mesh = build_for_eval(backbone_name, args,
                                                tokenizer)

    if args.dataset == "cirr":
        results = cirr_val_retrieval(backbone, args.data_path, preprocess,
                                     batch_size=32, mesh=mesh)
    else:
        per_type = {}
        for dt in args.dress_types:
            per_type[dt] = fiq_val_retrieval(backbone, args.data_path, dt,
                                             preprocess, batch_size=32,
                                             fiq_val_type=args.fiq_val_type,
                                             mesh=mesh)
        results = {f"{dt}_{k}": v for dt, m in per_type.items()
                   for k, v in m.items()}
        results.update(fiq_average(list(per_type.values())))
    if process_is_main():
        print(json.dumps(results, indent=2, sort_keys=True))
    return results


def build_for_eval(backbone_name: str, args, tokenizer=None):
    """(backbone in eval mode, preprocess, indexing mesh or None) of the
    evaluation CLIs: the process group joined first where the flags ask
    for one, the weights from --model_path (else random from --seed, then
    rank 0's on every rank)."""
    setup_distributed(args)
    generator = seed_everything(args.seed)
    backbone = make_backbone(backbone_name, args, tokenizer=tokenizer)
    preprocess = make_transform(backbone, args)
    load_or_init_params(backbone, args, generator)
    backbone.eval()
    mesh = encode_mesh(args, backbone.device)
    if mesh is not None:
        broadcast_module(backbone)
    return backbone, preprocess, mesh


if __name__ == "__main__":
    import sys

    validate_main(*backbone_from_argv(sys.argv[1:]))
