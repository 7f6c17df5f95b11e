"""spn4cir_tpu_torch - the PyTorch / CUDA port of spn4cir_tpu.

Runs on one NVIDIA H100 (Hopper, sm_90a). The JAX package `spn4cir_tpu`
beside it is the reference each module is tested against. This package
imports `torch` and never JAX; the host code that imports no JAX
(tokenizer, datasets, transforms, prefetch) is shared from `spn4cir_tpu`.

Ported so far: the clip4cir serving path (ViT CLIP towers, gallery index,
retrieval service and its CLI) with the short-sequence attention kernel
(`ops/attention_kernels.py`, `csrc/short_attention.cu`).
"""

__version__ = "0.1.0"
