#!/usr/bin/env python3
"""Phase 17 of `chip_smoke.py` alone, on one NVIDIA GPU: the scaling-
positives datagen (dedup, the SRM matcher at full width, CIRR-size
scoring, `--plus` training on its triplets) and the killed-and-resumed
stage-2 run, after the kernels' build and #3's check at Unicom's slice.

    python3 chip_probes/srm_phase.py

Prints the smoke's own phase lines; a failure is an uncaught exception.
"""

import os
import shutil
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("srm_phase: CUDA is not available")
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="srm_phase_")
    try:
        fixtures = cs.load_test_module("torch_fixtures")
        os.environ["SPN4CIR_BPE_VOCAB"] = fixtures.write_merges_file(
            os.path.join(tmp, "bpe_synthetic.txt.gz"))
        os.environ["SPN4CIR_BERT_VOCAB"] = fixtures.write_bert_vocab(
            os.path.join(tmp, "bert_vocab_synthetic.txt"))
        from spn4cir_tpu_torch.ops import attention_kernels as ak
        from spn4cir_tpu_torch.ops import bank_kernels as bk
        from spn4cir_tpu_torch.ops import cuda_build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = cs.card_line()
        cs.build_kernels(cuda_build)
        cs.LONG_SHAPES = (cs.UNICOM_ENCODE,)
        cs.check_long_attention(ak, torch.device("cuda:0"), card)
        root = cs.drive_dedup(tmp, card)
        _, sims_path = cs.drive_srm(ak, bk, root, tmp, card)
        cs.drive_srm_scale(card)
        _, argv = cs.drive_srm_train(ak, bk, root, sims_path, tmp, card)
        torch.cuda.empty_cache()
        cs.drive_resume(argv, tmp, card)
        cs.phase(f"srm_phase passed in {time.perf_counter() - t0:.1f} s "
                 f"[{card}]")
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
