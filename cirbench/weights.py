"""Random weights made by the benchmark from the seed, on the device.

The program's modules give only the names and shapes of their parameters.
The values come from one draw of a seeded generator on the device, cut into
leaves and scaled by the benchmark's own rule, so the program and the plain
reference receive the same numbers and a later run can draw them again:

- 0-d leaves take the configuration's `scalars` value (a temperature);
- embedding tables, positions and learned tokens: 0.02 N(0, 1);
- other leaves of two or more axes: fan-in normal, N(0, 1) / sqrt(fan-in);
- 1-d leaves named `weight` (the norms' scales): 1 + 0.1 N(0, 1);
- other 1-d leaves (biases): 0.02 N(0, 1).
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import torch

_TABLES = ("embedding", "embeddings", "pos_embed", "cls_token",
           "query_tokens", "prompt_tokens")


def _scale(name: str, shape: Tuple[int, ...], scalars: Mapping[str, float]):
    """(multiplier, offset) of the leaf `name`, or the constant's value."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 0:
        if leaf not in scalars:
            raise KeyError(f"no value for the scalar {name!r} in the "
                           f"configuration's 'scalars'")
        return 0.0, float(scalars[leaf])
    parts = name.split(".")
    if (any(p in _TABLES or p.endswith("_embedding") for p in parts)
            and "LayerNorm" not in parts):
        return 0.02, 0.0
    if len(shape) >= 2:
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        return fan_in ** -0.5, 0.0
    if leaf == "weight":
        return 0.1, 1.0
    return 0.02, 0.0


def make_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device, scalars: Mapping[str, float] = {}
                 ) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on `device`, all cut from one seeded draw."""
    shapes = [(n, tuple(s)) for n, s in shapes]
    total = sum(int(torch.Size(s).numel()) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes:
        n = int(torch.Size(shape).numel())
        mul, add = _scale(name, shape, scalars)
        out[name] = flat[at:at + n].view(shape).mul_(mul).add_(add)
        at += n
    return out


def reference_names(weights: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The same tensors under the published checkpoints' names: the port's
    backbones hold their model under `model.`."""
    return {(k[len("model."):] if k.startswith("model.") else k): v
            for k, v in weights.items()}


def param_shapes(module: torch.nn.Module):
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


@torch.no_grad()
def load_weights(module: torch.nn.Module, weights: Mapping[str, torch.Tensor]
                 ) -> None:
    for name, p in module.named_parameters():
        p.copy_(weights[name])
