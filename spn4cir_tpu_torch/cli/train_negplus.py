"""The unlabeled-negatives ablation's trainer: clip4cir stage 2 with the
unlabeled image pool appended to the target bank (`--unlabeled`).

Counterpart of clip4cir/train_negplus.py (clip4cir's recipe: RN50x4, tau
0.02, learning rate 2e-5, batch 256, 3 epochs):

    python -m spn4cir_tpu_torch.cli.train_negplus --dataset cirr \\
        --data_path cirr_dataset --bf16 [--neg_num 1000]
"""

from __future__ import annotations

import sys
from typing import Optional

from spn4cir_tpu_torch.cli.train import train_main


def recipe_argv(argv: list) -> list:
    argv = list(argv)
    if "--unlabeled" not in argv:
        argv.append("--unlabeled")
    return argv


def main(argv: Optional[list] = None, **kw):
    return train_main("clip", recipe_argv(sys.argv[1:] if argv is None
                                          else argv), **kw)


if __name__ == "__main__":
    main()
