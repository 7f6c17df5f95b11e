"""zscir stage 1: CLIP trained end to end (`--wo_bank`) with the in-batch
InfoNCE on the generated triplets, which replace the human train set
(`cap.rc2.train.extend_zs.json`, `cap.extend_zs.train.json`; the CC
triplets with `--use_cc`).

Counterpart of zscir/train.py (zscir's recipe: ViT-L/14, tau 0.01,
learning rate 2e-6, batch 48, 10 epochs):

    python -m spn4cir_tpu_torch.cli.train_zs --dataset cirr \\
        --data_path cirr_dataset --bf16
"""

from __future__ import annotations

import sys
from typing import Optional

from spn4cir_tpu_torch.cli.train import train_main


def recipe_argv(argv: list) -> list:
    argv = list(argv)
    if "--wo_bank" not in argv:
        argv.append("--wo_bank")
    return argv


def main(argv: Optional[list] = None, **kw):
    return train_main("zs", recipe_argv(sys.argv[1:] if argv is None
                                        else argv), **kw)


if __name__ == "__main__":
    main()
