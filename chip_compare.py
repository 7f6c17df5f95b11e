#!/usr/bin/env python3
"""Two checkouts of the port on one NVIDIA GPU, in turns: A, B, B, A.

    python3 chip_compare.py <checkout A> <checkout B>

Each turn is a process of its own, run from that checkout with its own
`chip_smoke.py`: the ViT-B/32 bf16 gallery encode (one resident batch of
256, median of per-call CUDA-event timings, as phase 4 of the smoke times
it), then phase 7 of the smoke, `train_epoch` at the recipe's 65,536-row
bank for ViT-B/32 over a bf16 bank and RN50x4 over a float32 and an int8
bank (ms/step without the profiler, then a profiler window: device busy,
idle share, device ms per step by kernel group; the int8 bank's backward
runs only in the last). Every line is tagged A1, B1, B2 or A2.
Exits non-zero, printing nothing measured, where no GPU is found.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile


def one_turn(root: str, tag: str) -> None:
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: CUDA is not available")
    from spn4cir_tpu_torch.models.clip4cir import ClipCIR
    from spn4cir_tpu_torch.ops import attention_kernels as ak
    from spn4cir_tpu_torch.ops import bank_kernels as bk

    cs.phase = lambda msg: print(f"[{tag}] {msg}", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_compare_")
    merges = os.path.join(tmp, "bpe_synthetic.txt.gz")
    os.environ["SPN4CIR_BPE_VOCAB"] = merges
    cs.load_test_module("torch_fixtures").write_merges_file(merges)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    device = torch.device("cuda:0")
    model = ClipCIR("ViT-B/32", tau=cs.TAU, dtype=torch.bfloat16,
                    device=device)
    model.init_params(torch.Generator().manual_seed(0))
    model.eval()
    batch = torch.randn(cs.ENCODE_BATCH, 224, 224, 3, device=device,
                        generator=torch.Generator(device).manual_seed(2))
    with torch.inference_mode():
        ms = cs.median_ms(lambda: model.index_features(batch), reps=10,
                          warmup=2)
    cs.phase(f"ViT-B/32 bf16 encode: {cs.ENCODE_BATCH / (ms / 1e3):.1f} "
             f"images/s on the device (batch {cs.ENCODE_BATCH}, {ms:.3f} "
             f"ms/batch) [{card}]")
    del model, batch
    torch.cuda.empty_cache()
    cs.drive_training_recipe(ak, bk, tmp, card, "ViT-B/32", ("bfloat16",))
    torch.cuda.empty_cache()
    cs.drive_training_recipe(ak, bk, tmp, card, cs.FLAGSHIP,
                             ("float32", "int8"))


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        one_turn(os.path.abspath(sys.argv[2]), sys.argv[3])
        return 0
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    a, b = (os.path.abspath(p) for p in sys.argv[1:])
    for root, tag in ((a, "A1"), (b, "B1"), (b, "B2"), (a, "A2")):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root, tag])
        if proc.returncode:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
