"""Routed experts of a mixture-of-experts layer: the routing permutation,
the grouped SwiGLU experts (kernel #14) and the combine.

A layer routes each of T tokens to k of E experts. The permutation sorts
the T·k (token, slot) pairs by expert, stably, on the device:

    order   (T·k,)   sorted position -> token·k + slot
    src     (T·k,)   int32, the token each sorted row reads (order // k)
    offsets (E + 1,) int32, expert e's rows are [offsets[e], offsets[e+1])
    inv     (T·k,)   token·k + slot -> its sorted position

`moe_grouped` computes every sorted row's expert MLP,

    y[r] = bf16(bf16(silu(x[src[r]] · Wg[e]ᵀ) ⊙ (x[src[r]] · Wu[e]ᵀ)) · Wd[e]ᵀ)

with the experts' weights stacked (E, I, D), (E, I, D), (E, D, I). On a CUDA
tensor it launches `csrc/moe_grouped.cu` (built with nvcc at first use; two
kernels in one ctypes call), whose tiles come from the device offsets, so
nothing waits for the host; on a CPU tensor it runs
`moe_grouped_reference`, the same arithmetic as a loop over the experts.
The wrapper counts its launches in `moe_grouped.launches` and, on the
device, the rows and the experts hit of each launch by route (`moe_stats`,
read once after a window). `moe_combine` gathers each (token, slot) row back
and sums the slots in a fixed order, in float32: no `index_add_`, no
atomics, the same bits from launch to launch. A layer that holds a share of
the experts (`models/deepseek_v3.py`) sorts the routes to the others past
`offsets[-1]`, where #14 computes nothing, and `moe_combine`'s `held` mask
leaves them out of the sum.

There is no Pallas kernel behind it: the JAX package has no mixture of
experts.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from spn4cir_tpu_torch.ops.cuda_build import counted, launch, load_library

MAX_EXPERTS = 256
#: tile rows of the two routes (csrc/moe_grouped.cu): small groups take 32,
#: large ones 128; a layer's mean group size picks the route
ROUTE_ROWS = (32, 128)
SMALL_GROUP = 48


def moe_plan(rows: int, experts: int) -> int:
    """The route of a launch: 0 (32-row tiles) while the mean group holds at
    most SMALL_GROUP rows, 1 (128-row tiles) above. A pure function of its
    arguments."""
    return 0 if rows <= SMALL_GROUP * experts else 1


def route_permutation(topk_idx: torch.Tensor, experts: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(src int32, offsets int32 (E + 1,), inv int64) of a (T, k) choice of
    experts, stably sorted by expert: device tensor code, no host sync."""
    t, k = topk_idx.shape
    flat = topk_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    bounds = torch.arange(experts + 1, device=flat.device, dtype=flat.dtype)
    offsets = torch.searchsorted(flat[order], bounds).to(torch.int32)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    return torch.div(order, k, rounding_mode="floor").to(torch.int32), offsets, inv


def moe_combine(y: torch.Tensor, inv: torch.Tensor, weights: torch.Tensor,
                held: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_slot weights[t, slot] · y[inv[t·k + slot]] in float32: (T, D).
    `held` (T, k) marks the routes that count: the others add nothing
    (their rows of y were never written)."""
    t, k = weights.shape
    rows = y[inv].view(t, k, -1).float()
    rows.mul_(weights[..., None])
    if held is not None:
        rows.masked_fill_(~held[..., None], 0.0)
    return rows.sum(dim=1)


def moe_grouped_reference(x: torch.Tensor, src: torch.Tensor,
                          offsets: torch.Tensor, w_gate: torch.Tensor,
                          w_up: torch.Tensor, w_down: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version: each expert's rows through its MLP, float32 sums, h and
    y rounded once to x's type, as the kernel does."""
    bounds: List[int] = offsets.tolist()
    y = x.new_empty((src.numel(), w_down.shape[1]))
    for e in range(len(bounds) - 1):
        lo, hi = bounds[e], bounds[e + 1]
        if hi == lo:
            continue
        rows = x[src[lo:hi].long()].float()
        gate = rows @ w_gate[e].float().t()
        up = rows @ w_up[e].float().t()
        h = (F.silu(gate) * up).to(x.dtype)
        y[lo:hi] = (h.float() @ w_down[e].float().t()).to(x.dtype)
    return y


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# x, src, x's row stride, w_gate, w_up, w_down, offsets; E, R, D, I; h, y,
# route, the route's stats row; stream
ENTRY_POINTS = {
    "moe_grouped_swiglu": ([_PTR, _PTR, _I32, _PTR, _PTR, _PTR, _PTR]
                           + [_I32] * 4 + [_PTR, _PTR, _I32, _PTR, _PTR]),
}


_STATS: Dict[int, torch.Tensor] = {}


def _stats(index: int) -> torch.Tensor:
    """(route, [rows, experts hit, launches]) int64 sums on device `index`."""
    if index not in _STATS:
        # a normal tensor even when the first launch runs under
        # inference_mode: `moe_stats` zeroes it outside
        with torch.inference_mode(False):
            _STATS[index] = torch.zeros((len(ROUTE_ROWS), 3),
                                        dtype=torch.int64,
                                        device=torch.device("cuda", index))
    return _STATS[index]


def moe_stats(reset: bool = False) -> Dict[str, List[int]]:
    """The device sums of every card used so far, by route ("small",
    "large"): [rows, experts hit, launches]; read with a sync, so only
    after a window. With `reset`, set to 0 after the read."""
    out = {"small": [0, 0, 0], "large": [0, 0, 0]}
    for t in _STATS.values():
        for name, row in zip(out, t.tolist()):
            out[name] = [a + b for a, b in zip(out[name], row)]
        if reset:
            t.zero_()
    return out


def moe_grouped(x: torch.Tensor, src: torch.Tensor, offsets: torch.Tensor,
                w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """y (R, D) of the sorted rows: the plain loop on the CPU, kernel #14 on
    CUDA (bf16 only)."""
    if not x.is_cuda:
        return moe_grouped_reference(x, src, offsets, w_gate, w_up, w_down)
    experts, inter, hidden = w_gate.shape
    rows = src.numel()
    if (x.dtype is not torch.bfloat16 or x.dim() != 2
            or x.shape[1] != hidden or x.stride(1) != 1
            or any(w.dtype is not torch.bfloat16 or not w.is_contiguous()
                   for w in (w_gate, w_up, w_down))
            or w_up.shape != w_gate.shape
            or w_down.shape != (experts, hidden, inter)
            or src.dtype is not torch.int32 or offsets.dtype is not torch.int32
            or offsets.shape != (experts + 1,) or not experts <= MAX_EXPERTS
            or hidden % 8 or inter % 8 or x.stride(0) % 8
            or x.data_ptr() % 16):
        raise ValueError(
            f"moe_grouped takes bf16 x (T, {hidden}) with 16-byte rows, "
            f"contiguous bf16 weights (E, I, D), (E, I, D), (E, D, I) with E <= "
            f"{MAX_EXPERTS} and D, I multiples of 8, int32 src and offsets "
            f"(E + 1,); got x {x.dtype} {tuple(x.shape)}, weights "
            f"{tuple(w_gate.shape)} {tuple(w_up.shape)} {tuple(w_down.shape)}, "
            f"src {src.dtype}, offsets {offsets.dtype} {tuple(offsets.shape)}")
    y = x.new_empty((rows, hidden))
    if rows == 0:
        return y
    h = x.new_empty((rows, inter))
    index = x.get_device()
    route = moe_plan(rows, experts)
    stats = _stats(index)[route]
    # held until the launch has read their pointers
    src, offsets = src.contiguous(), offsets.contiguous()
    launch(moe_grouped,
           load_library("moe_grouped", ENTRY_POINTS).moe_grouped_swiglu, index,
           x.data_ptr(), src.data_ptr(), x.stride(0), w_gate.data_ptr(),
           w_up.data_ptr(), w_down.data_ptr(), offsets.data_ptr(), experts,
           rows, hidden, inter, h.data_ptr(), y.data_ptr(), route,
           stats.data_ptr())
    return y


counted(moe_grouped)
