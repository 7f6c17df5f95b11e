"""Int8 weight-only matrix product of the LLaMA decoders, and its kernel.

Counterpart of `spn4cir_tpu/ops/quant_matmul.py`:

    y = (x @ values) * scales        # values (D, F) int8, scales (F,) f32

summed in float32, y in x's type, leading dims of x flattened. The kernel
(`csrc/quant_matmul.cu`, replacing the TPU `_kernel`) streams the int8
weight once and never forms a float copy of it: it widens the weights in
registers onto the bf16 tensor cores, float32 x split into three bf16
terms whose products are exact. It is built with nvcc at first use and
counts its launches in `quant_matmul.launches`; `split_plan` cuts D into
as many splits as keep every cluster of splits resident at once, from the
kernel's cluster occupancy read once a device (`device_plan_inputs`).

Routes: on a CUDA tensor `quant_matmul` launches the kernel or raises; on a
CPU tensor it runs `quant_matmul_reference`, the plain PyTorch version,
counting nothing. The LLaMA decoders reach it only in decode steps with
`quant_kernel=True` (`models/llama.py:_mm`), as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from spn4cir_tpu_torch.ops.cuda_build import (counted, launch, load_library,
                                              occupancy)

COLS = 256         # columns of W a block (kCols)
DEPTH = 64         # rows of W a ring stage (kDepth): splits are multiples
MAX_SPLITS = 16    # splits of D: one thread-block cluster (kMaxSplits)
TILE_ROWS = 8      # rows of x an n8 tile; a block takes one or two tiles

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quant_matmul_reference(x: torch.Tensor, values: torch.Tensor,
                           scales: torch.Tensor) -> torch.Tensor:
    """Plain version: the float32 product of x and the widened int8 values
    (bf16 x and int8 values widen exactly), times the float32 scales, cast
    to x's type."""
    y = (x.float() @ values.float()) * scales.float()
    return y.to(x.dtype)


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# x, x code, values, scales; rows, D, F, n_tiles, d_per_split, splits; y;
# stream. The occupancy query: x code, n_tiles, cluster size; the clusters
# the card holds (out)
ENTRY_POINTS = {
    "quant_matmul": [_PTR, _I32, _PTR, _PTR] + [_I32] * 6 + [_PTR, _PTR],
    "quant_matmul_clusters": [_I32, _I32, _I32, ctypes.POINTER(_I32)],
}


@functools.lru_cache(maxsize=None)
def device_plan_inputs(index: int, x_code: int, n_tiles: int
                       ) -> Tuple[int, ...]:
    """For n = 1..MAX_SPLITS, the clusters of n blocks of the kernel (for
    an x type code and n8 tile count) that CUDA device `index` holds at
    once: read once a device, from the occupancy API."""
    fn = load_library("quant_matmul", ENTRY_POINTS).quant_matmul_clusters
    return tuple(occupancy(fn, index, x_code, n_tiles, n, least=0)
                 for n in range(1, MAX_SPLITS + 1))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def n_tiles_for(rows: int) -> int:
    """n8 tiles of x a block: one up to 8 rows, else two (16 a block)."""
    return 1 if rows <= TILE_ROWS else 2


def split_plan(rows: int, d: int, f: int, clusters: Sequence[int]
               ) -> Tuple[int, int, int]:
    """(n_tiles, d_per_split, n_splits): 8·n_tiles rows of x and COLS
    columns of W a block; D cut into the most splits of whole DEPTH stages,
    at most len(clusters), whose clusters (one a row and column tile) the
    card holds all at once: clusters[n - 1] is how many clusters of n
    blocks fit. More splits shorten each block; one cluster too many runs
    a second wave (on the H100, 6 splits of 43 tiles took 1.37x the time
    of 5; PERF.md). A pure function of its arguments, so the order
    of every sum is fixed for a given device."""
    nt = n_tiles_for(rows)
    tiles = _cdiv(rows, TILE_ROWS * nt) * _cdiv(f, COLS)
    steps = _cdiv(d, DEPTH)
    best = 1
    for n in range(2, min(len(clusters), steps) + 1):
        if tiles <= clusters[n - 1]:
            best = n
    per = _cdiv(steps, best) * DEPTH
    return nt, per, _cdiv(d, per)


def _check(x: torch.Tensor, values: torch.Tensor, scales: torch.Tensor
           ) -> None:
    if values.dim() != 2 or x.shape[-1] != values.shape[0]:
        raise ValueError(f"x (..., D) and values (D, F) must share D; got "
                         f"{tuple(x.shape)}, {tuple(values.shape)}")
    if values.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"values must be int8 and scales float32; got "
                         f"{values.dtype}, {scales.dtype}")
    if scales.shape != (values.shape[1],):
        raise ValueError(f"scales must be (F,) = ({values.shape[1]},); got "
                         f"{tuple(scales.shape)}")
    if x.dtype not in _X_CODES:
        raise ValueError(f"the kernel takes float32 or bfloat16 x; got "
                         f"{x.dtype}")
    if not (x.device == values.device == scales.device):
        raise ValueError("x, values and scales must lie on one device")
    if x.device.type != "cuda":
        raise ValueError(f"the quant_matmul kernel launches on CUDA; the "
                         f"tensors lie on {x.device}")
    if not (values.is_contiguous() and scales.is_contiguous()):
        raise ValueError("values and scales must be contiguous")


def quant_matmul(x: torch.Tensor, values: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """(..., D) @ int8 (D, F) with per-column float32 scales -> (..., F) in
    x's type; the kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return quant_matmul_reference(x, values, scales)
    _check(x, values, scales)
    d, f = values.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d).contiguous()
    rows = x2.shape[0]
    y = torch.empty(rows, f, device=x.device, dtype=x.dtype)
    if rows == 0:
        return y.reshape(*lead, f)
    code = _X_CODES[x.dtype]
    index = x.get_device()
    nt, per, n_splits = split_plan(
        rows, d, f, device_plan_inputs(index, code, n_tiles_for(rows)))
    lib = load_library("quant_matmul", ENTRY_POINTS)
    launch(quant_matmul, lib.quant_matmul, index, x2.data_ptr(), code,
           values.data_ptr(), scales.data_ptr(), rows, d, f, nt, per,
           n_splits, y.data_ptr())
    return y.reshape(*lead, f)


counted(quant_matmul)
