"""The negative-type ablation's trainer: clip4cir stage 1 (`--wo_bank`)
with the four-flavor loss, `--neg_type 15` (every flavor) unless given.

Counterpart of clip4cir/train_negtype.py (clip4cir's recipe: RN50x4, tau
0.02, learning rate 2e-5, batch 256, 3 epochs):

    python -m spn4cir_tpu_torch.cli.train_negtype --dataset cirr \\
        --data_path cirr_dataset --bf16 [--neg_type 5]
"""

from __future__ import annotations

import sys
from typing import Optional

from spn4cir_tpu_torch.cli.train import train_main


def recipe_argv(argv: list) -> list:
    argv = list(argv)
    if "--wo_bank" not in argv:
        argv.append("--wo_bank")
    if "--neg_type" not in argv:
        argv += ["--neg_type", "15"]
    return argv


def main(argv: Optional[list] = None, **kw):
    return train_main("clip", recipe_argv(sys.argv[1:] if argv is None
                                          else argv), **kw)


if __name__ == "__main__":
    main()
