"""Phase 19 of `chip_smoke.py` (multi-GPU on one card) with what it needs:
the kernels' build (phase 2), the serving slice (phase 4, whose gallery
(c) and (d1) compare against) and the training slice (phase 5, whose
losses (b1) compares against). Run from the repository's root on the card:

    python3 chip_probes/multi_gpu_phase.py

About 3 minutes of command time with the build."""

import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402


def main() -> None:
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="multi_gpu_phase_")
    merges = os.path.join(tmp, "bpe_synthetic.txt.gz")
    os.environ["SPN4CIR_BPE_VOCAB"] = merges
    fixtures = cs.load_test_module("torch_fixtures")
    fixtures.write_merges_file(merges)
    os.environ["SPN4CIR_BERT_VOCAB"] = fixtures.write_bert_vocab(
        os.path.join(tmp, "bert_vocab_synthetic.txt"))
    from spn4cir_tpu_torch.models import layers
    from spn4cir_tpu_torch.ops import attention_kernels as ak
    from spn4cir_tpu_torch.ops import bank_kernels as bk
    from spn4cir_tpu_torch.ops import cuda_build

    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_kernels(cuda_build)
    root = cs.load_test_module("fixtures").make_cirr(
        os.path.join(tmp, "cirr"), n_images=cs.N_GALLERY,
        n_train=cs.N_TRAIN, n_val=cs.N_VAL, extended=False)
    cs.drive_serving(ak, bk, layers, root, card)
    cs.drive_training_cli(ak, bk, root, tmp, card)
    paths = cs.drive_multi_gpu(ak, bk, root, tmp, card)
    print(json.dumps(paths))
    print(f"probe seconds {time.time() - t0:.1f} [{card}]")


if __name__ == "__main__":
    main()
