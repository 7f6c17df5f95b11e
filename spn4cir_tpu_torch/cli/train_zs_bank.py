"""zscir stage 2: the bank fine-tune of the zero-shot model on the
generated triplets.

Counterpart of zscir/train_bank.py, whose recipe differs from zscir's
stage 1 (ViT-L/14, tau 0.02, learning rate 2e-6, batch 128, 5 epochs):

    python -m spn4cir_tpu_torch.cli.train_zs_bank --dataset cirr \\
        --data_path cirr_dataset --bf16 --model_path <stage-1 best.pt>
"""

from __future__ import annotations

import sys
from typing import Optional

from spn4cir_tpu_torch.cli.common import ZSCIR_BANK_DEFAULTS
from spn4cir_tpu_torch.cli.train import train_main


def main(argv: Optional[list] = None, **kw):
    return train_main("zs", sys.argv[1:] if argv is None else argv,
                      **{**ZSCIR_BANK_DEFAULTS, **kw})


if __name__ == "__main__":
    main()
