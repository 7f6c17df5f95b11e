"""Plain float32 arithmetic shared by the references, the precision switch of
the controls, and AdamW written out.

The references import nothing of the program. Each matrix product goes
through `Precision.mm`: in float32 with TF32 off (the reference), or with
both operands rounded to float8 e4m3 under a per-tensor scale (the control:
the precision below the bfloat16 that the configurations state).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def strict_float32() -> Iterator[None]:
    """TF32 off for matmuls and convolutions while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32;
    the gradient passes straight through."""
    scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x.detach())


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in float32; the gradient passes
    straight through."""
    return x + (x.detach().to(torch.bfloat16).float() - x.detach())


class Precision:
    """`mm(a, b)`: a @ b in float32, or with float8 operands (the control),
    or with bfloat16 operands (a witness of what rounding alone does)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8", "bf16"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return fp8_round(x)
        return bf16_round(x) if self.name == "bf16" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.round(a.float()), self.round(b.float()))

    def linear(self, x, weight, bias=None):
        y = self.mm(x, weight.t())
        return y if bias is None else y + bias


def layer_norm(x, weight, bias, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)


class AdamW:
    """torch.optim.AdamW's update written out: decoupled decay, then the
    bias-corrected moment step."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1: float,
                 b2: float, eps: float, weight_decay: float):
        self.params = params
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.wd = eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            if g is None:  # a leaf the loss never reads keeps its value
                continue
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
