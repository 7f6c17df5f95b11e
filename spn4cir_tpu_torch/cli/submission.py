"""CIRR test-submission CLI of the PyTorch port: writes the two JSON files
the CIRR test server takes, on one device.

Counterpart of `spn4cir_tpu/cli/submission.py`:

    python -m spn4cir_tpu_torch.cli.submission --dataset cirr \\
        --data_path cirr_dataset --clip-model-name RN50x4 --bf16 \\
        --model_path models/run/best.pt --submission-name run

They land in `submission/<backbone>4cir/` under the working directory.
Runs on cuda:0 unless --device says otherwise (`--device cpu` for the CPU).
`--mesh_*` > 1 raise "not yet ported".
"""

from __future__ import annotations

from typing import Optional

from spn4cir_tpu_torch.cli.common import (
    base_parser,
    finalize_args,
    load_or_init_params,
    make_backbone,
    make_transform,
)
from spn4cir_tpu_torch.cli.train import CLIP4CIR_DEFAULTS
from spn4cir_tpu_torch.cli.validate import refuse_mesh
from spn4cir_tpu_torch.eval.submission import generate_cirr_test_submissions
from spn4cir_tpu_torch.utils.seeding import seed_everything


def submission_main(backbone_name: str = "clip", argv: Optional[list] = None,
                    tokenizer=None, **parser_kw):
    """Parse `argv`, build the backbone and write both submission files;
    returns their paths."""
    parser = base_parser(**(parser_kw or CLIP4CIR_DEFAULTS))
    parser.add_argument("--submission-name", default="tpu", type=str,
                        help="file_name suffix of the submission JSONs")
    args = parser.parse_args(argv)
    if args.dataset != "cirr":
        raise SystemExit("CIRR test submissions require --dataset cirr")
    finalize_args(args)
    refuse_mesh(args)
    generator = seed_everything(args.seed)

    backbone = make_backbone(backbone_name, args, tokenizer=tokenizer)
    preprocess = make_transform(backbone, args)
    load_or_init_params(backbone, args, generator)
    backbone.eval()

    p1, p2 = generate_cirr_test_submissions(
        backbone, args.submission_name, preprocess, args.data_path)
    print(f"wrote {p1}\nwrote {p2}")
    return p1, p2


if __name__ == "__main__":
    submission_main("clip", None, **CLIP4CIR_DEFAULTS)
