"""Best-model checkpoints of the PyTorch port.

Counterpart of `save_model` / `load_model` in
`spn4cir_tpu/utils/checkpoint.py` (parity target: `clip4cir/utils.py:53-67`,
schema `{epoch, state_dict}` -> `<output>/best.pt`). One `torch.save` of
the state dict (the port's parameter names are OpenAI CLIP's, the
reference's), the epoch and the extra metadata. Full training-state resume
(`CheckpointManager`, `--resume`) is not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
from torch import nn


def save_model(path: str, model: nn.Module, epoch: int = 0,
               extra: Optional[dict] = None) -> None:
    """Best-checkpoint save: {'epoch', 'state_dict', 'extra'} on the CPU."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"epoch": epoch, "state_dict": state, "extra": extra or {}},
               path)


def load_model(path: str, model: nn.Module) -> Tuple[nn.Module, dict]:
    """Load a `save_model` file into `model` (in place, onto its device);
    returns (model, {'epoch': ..., **extra})."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(obj["state_dict"])
    return model, {"epoch": obj["epoch"], **obj["extra"]}
