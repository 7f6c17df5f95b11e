#!/usr/bin/env python3
"""Phase 18 of `chip_smoke.py` alone, on one NVIDIA GPU: the host input
path (the native loader's build, the four index routes over a tree of
JPEGs, the training run with `--device_preprocess --loader_procs N`, the
two tokenizers), after the kernels' build.

    python3 chip_probes/host_input_phase.py

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
        raise SystemExit("host_input_phase: CUDA is not available")
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="host_input_phase_")
    try:
        fixtures = cs.load_test_module("torch_fixtures")
        os.environ["SPN4CIR_BPE_VOCAB"] = fixtures.write_merges_file(
            os.path.join(tmp, "bpe_synthetic.txt.gz"))
        from spn4cir_tpu_torch.ops import attention_kernels as ak
        from spn4cir_tpu_torch.ops import bank_kernels as bk
        from spn4cir_tpu_torch.ops import cuda_build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = cs.card_line()
        cs.build_kernels(cuda_build)
        cs.drive_host_input(ak, bk, tmp, card)
        cs.phase(f"host_input_phase passed in "
                 f"{time.perf_counter() - t0:.1f} s [{card}]")
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
