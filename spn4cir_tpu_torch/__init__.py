"""spn4cir_tpu_torch - the PyTorch / CUDA port of spn4cir_tpu.

Runs on one NVIDIA H100 (Hopper, sm_90a). The JAX package `spn4cir_tpu`
beside it is the reference each module is tested against. This package
imports `torch` and never JAX, and nothing of the JAX package: it keeps its
own copies of the host modules it needs (tokenizer, datasets, transforms,
prefetch).

Ported so far:
  - the clip4cir serving path (ViT CLIP towers, gallery index, retrieval
    service and its CLI) with the short-sequence attention kernel;
  - clip4cir stage-2 training (feature banks, full-bank InfoNCE, masked
    AdamW, per-epoch validation, best checkpoint, `cli/train.py`) with the
    bank-InfoNCE forward/backward kernels and the attention backward
    kernel.
Kernels: `ops/attention_kernels.py` + `csrc/short_attention.cu`,
`ops/bank_kernels.py` + `csrc/bank_infonce.cu`.
"""

__version__ = "0.1.0"
