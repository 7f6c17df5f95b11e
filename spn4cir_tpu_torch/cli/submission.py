"""CIRR test-submission CLI of the PyTorch port: writes the two JSON files
the CIRR test server takes, on one device.

Counterpart of `spn4cir_tpu/cli/submission.py`:

    python -m spn4cir_tpu_torch.cli.submission --dataset cirr \\
        --data_path cirr_dataset --clip-model-name RN50x4 --bf16 \\
        --model_path models/run/best.pt --submission-name run

They land in `submission/<backbone>4cir/` under the working directory
(`blip24cir/` for blip2). An optional first word, `clip` (the default),
`blip` or `blip2`, picks the backbone. Runs on cuda:0 unless --device says
otherwise (`--device cpu` for the CPU). `--mesh_data` / `--mesh_model`
index the test gallery over several ranks as in `cli.validate`; rank 0
writes the files.
"""

from __future__ import annotations

from typing import Optional

from spn4cir_tpu_torch.cli.common import (
    backbone_from_argv,
    base_parser,
    finalize_args,
    recipe_defaults,
)
from spn4cir_tpu_torch.cli.validate import build_for_eval
from spn4cir_tpu_torch.eval.submission import generate_cirr_test_submissions
from spn4cir_tpu_torch.parallel.mesh import process_is_main


def submission_main(backbone_name: str = "clip", argv: Optional[list] = None,
                    tokenizer=None, **parser_kw):
    """Parse `argv`, build the backbone and write both submission files;
    returns their paths."""
    parser = base_parser(**(parser_kw or recipe_defaults(backbone_name)))
    parser.add_argument("--submission-name", default="tpu", type=str,
                        help="file_name suffix of the submission JSONs")
    args = parser.parse_args(argv)
    if args.dataset != "cirr":
        raise SystemExit("CIRR test submissions require --dataset cirr")
    finalize_args(args)
    backbone, preprocess, mesh = build_for_eval(backbone_name, args,
                                                tokenizer)

    p1, p2 = generate_cirr_test_submissions(
        backbone, args.submission_name, preprocess, args.data_path,
        mesh=mesh)
    if process_is_main():
        print(f"wrote {p1}\nwrote {p2}")
    return p1, p2


if __name__ == "__main__":
    import sys

    submission_main(*backbone_from_argv(sys.argv[1:]))
