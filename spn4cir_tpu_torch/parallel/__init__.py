"""Multi-GPU training, indexing and decoding: process groups and rank
helpers (`mesh`), the bank-sharded InfoNCE (`loss`), the data-parallel
stage-1 / stage-2 steps (`train`) and Megatron tensor parallelism of the
towers and the LLaMA decoders (`tp`). Counterpart of
`spn4cir_tpu/parallel/`."""
