"""spn4cir_tpu_torch - the PyTorch / CUDA port of spn4cir_tpu.

Runs on one NVIDIA H100 (Hopper, sm_90a). The JAX package `spn4cir_tpu`
beside it is the reference each module is tested against. This package
imports `torch` and never JAX, and nothing of the JAX package: it keeps its
own copies of the host modules it needs (tokenizer, datasets, transforms,
prefetch, the native loader's and BPE's C++ sources).

Ported: the four supervised backbones (clip4cir with the ViT and RN50x4
towers, tgcir, blip4cir, blip24cir) and zscir, with serving, bank
extraction, stage-2 and stage-1 training, validation and the CIRR
submission; the datagen pipeline (the LLaVA / BLIP captioners, the LLaMA-2
rewriter, dedup, the SRM matcher) and training-state resume; the eval
tools; the host input path: the native C++ image loader and BPE
(`native/`, `tokenizer/native_bpe.py`), the multi-process loader
(`data/mploader.py`) and the device preprocess (`ops/preprocess.py`).
Kernels (hand-written CUDA C++ in `csrc/`, built by `ops/cuda_build.py`):
`ops/attention_kernels.py` (short and long attention, forward and
backward), `ops/bank_kernels.py` (bank InfoNCE over float32, bf16 and int8
banks), `ops/maxquery_kernels.py`, `ops/decode_attn.py`,
`ops/quant_matmul.py`. Multi-GPU (`parallel/`, `serve/sharded.py`): one
process per GPU over `torch.distributed` process groups (the bank-sharded
InfoNCE, data-parallel stage 1 and stage 2, Megatron tensor parallelism of
the towers and the LLaMA / LLaVA decoders), and the gallery in row shards
over a device list in one serving process.
"""

__version__ = "0.1.0"
