"""Int8 weight-only matrix product of the LLaMA decoders, and its kernel.

Counterpart of `spn4cir_tpu/ops/quant_matmul.py`:

    y = (x @ values) * scales        # values (D, F) int8, scales (F,) f32

summed in float32, y in x's type, leading dims of x flattened. The kernel
(`csrc/quant_matmul.cu`, replacing the TPU `_kernel`) streams the int8
weight once and never forms a float copy of it; it is built with nvcc at
first use and counts its launches in `quant_matmul.launches`.

Routes: on a CUDA tensor `quant_matmul` launches the kernel or raises; on a
CPU tensor it runs `quant_matmul_reference`, the plain PyTorch version,
counting nothing. The LLaMA decoders reach it only in decode steps with
`quant_kernel=True` (`models/llama.py:_mm`), as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

CHUNK = 128        # the kernel's x chunk along D (kChunk)
COLS = 256         # columns of a block (kCols)
MAX_TILE_ROWS = 8  # rows of a block's tile (the largest RT)

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quant_matmul_reference(x: torch.Tensor, values: torch.Tensor,
                           scales: torch.Tensor) -> torch.Tensor:
    """Plain version: the float32 product of x and the widened int8 values
    (bf16 x and int8 values widen exactly), times the float32 scales, cast
    to x's type."""
    y = (x.float() @ values.float()) * scales.float()
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from spn4cir_tpu_torch.ops.cuda_build import build_library

    lib = ctypes.CDLL(str(build_library("quant_matmul", ["quant_matmul.cu"])))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.quant_matmul.restype = i32
    lib.quant_matmul.argtypes = ([ptr, i32, ptr, ptr] + [i32] * 6
                                 + [ptr, ptr, ptr])
    return lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(rows: int, d: int, f: int, sm_count: int
               ) -> Tuple[int, int, int]:
    """(rows_per_tile, d_per_split, n_splits): a row tile of 1, 2, 4 or 8;
    D cut into splits of whole chunks so that tiles x splits is about two
    blocks per SM, each split at least two chunks deep. A pure function of
    its arguments, so the order of every sum is fixed for a given device."""
    rt = 1
    while rt < min(rows, MAX_TILE_ROWS):
        rt *= 2
    tiles = _cdiv(rows, rt) * _cdiv(f, COLS)
    n = max(1, min(_cdiv(2 * sm_count, tiles), d // (2 * CHUNK)))
    if n == 1:
        return rt, d, 1
    per = _cdiv(_cdiv(d, n), CHUNK) * CHUNK
    return rt, per, _cdiv(d, per)


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
    if values.shape[1] % 8 == 0 and values.data_ptr() % 8:
        raise ValueError("values must be 8-byte aligned")


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
    sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    rt, per, n_splits = split_plan(rows, d, f, sm)
    part = (torch.empty(n_splits, rows, f, device=x.device,
                        dtype=torch.float32) if n_splits > 1 else y)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().quant_matmul(
            x2.data_ptr(), _X_CODES[x.dtype], values.data_ptr(),
            scales.data_ptr(), rows, d, f, rt, per, n_splits, y.data_ptr(),
            part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul launch failed with CUDA error {err}"
                           f" (rows={rows}, D={d}, F={f}, {x.dtype})")
    quant_matmul.launches += 1
    return y.reshape(*lead, f)


quant_matmul.launches = 0
