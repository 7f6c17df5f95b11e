"""Int8 feature banks: per-row absmax quantization.

Counterpart of `QuantBank` / `quantize_bank` in
`spn4cir_tpu/ops/bank_kernels.py`, in plain PyTorch. They serve
`--gallery_dtype int8` in the retrieval service; the bank-InfoNCE kernels
belong to the training path and are not ported yet."""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantBank(NamedTuple):
    """Per-row absmax-quantized feature bank: values int8 (M, D), scales
    float32 (M,)."""

    values: torch.Tensor
    scales: torch.Tensor

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device


def quantize_bank(bank: torch.Tensor) -> QuantBank:
    """Per-feature-row absmax int8 quantization (the last axis is the
    feature axis; every leading axis keeps its own scale)."""
    bank = bank.float()
    scales = bank.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    vals = torch.round(bank / scales[..., None]).clamp(-127, 127)
    return QuantBank(vals.to(torch.int8), scales)
