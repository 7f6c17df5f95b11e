"""LayerNorm with float32 statistics and affine over bf16 or float32
activations, and its kernel.

The towers' precision policy (`models/layers.py`): the normalisation is
computed in float32 from float32 weight and bias, and the output is rounded
once to the activations' type:

    y = ((x - mean) * rstd * weight + bias).to(x.dtype)    # in float32

over the last axis. There is no Pallas kernel behind it: the JAX package
leaves its LayerNorm to XLA. The kernel (`csrc/layer_norm.cu`) reads x
once in its own type and writes y once, where the plain chain (a float32
copy of x, aten's float32 LayerNorm, a cast back) moves float32
intermediates twice the activation's size. Its backward reads dy and x in
their own type (taking the row statistics again from x) and writes dx; the
float32 dweight / dbias are summed from per-block partial rows in a fixed
order. It is built with nvcc at first use and counts its launches in
`layer_norm_f32.launches` (forward) and `layer_norm_f32_bwd.launches`
(backward: the dx kernel and the reduction of the partials); `ln_plan`
picks the vector width, the vectors a lane and the warps a row from the
width, the dtype and the pointers' alignment alone.

Routes: `layer_norm_f32` on a CPU tensor runs `layer_norm_reference`, the
plain chain, differentiated by autograd, counting nothing; on a CUDA tensor
it launches the kernel, forward and backward, or raises.
`layer_norm_bwd_reference` is the plain backward of the same formula, the
kernel's oracle in the tests. The towers' steps are paced by the host, so
the wrapper keeps its own work per call small: no reshape, no statistics
tensor, one raw stream handle.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from spn4cir_tpu_torch.ops.cuda_build import (counted, launch, load_library,
                                              occupancy, sm_count)

WARPS = 8            # warps a block (kWarps)
MAX_WIDTH = 4096     # the backward folds 2·W float32 in shared memory
#: values a 16-byte vector holds, and the vectors a lane holds before a row
#: takes more warps, per type (on the H100 a float32 lane is faster with 2
#: than with 4, a bf16 lane with 3 than with 2: PERF.md)
VEC = {torch.float32: 4, torch.bfloat16: 8}
VEC_MAX = {torch.float32: 2, torch.bfloat16: 3}
VEC_LIMIT = 4        # vectors a lane holds at most, at 8 warps a row
SCALAR_NV = 16       # single values a lane on the path without vectors
ROW_WARPS = (1, 2, 4, 8)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_reference(x: torch.Tensor, normalized_shape: Sequence[int],
                         weight: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], eps: float
                         ) -> torch.Tensor:
    """Plain version: aten's LayerNorm over a float32 copy of x, cast back
    to x's type."""
    return F.layer_norm(x.float(), tuple(normalized_shape), weight, bias,
                        eps).to(x.dtype)


def layer_norm_stats_reference(x: torch.Tensor, eps: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd) of each row of x over its last axis, float32."""
    xf = x.float().reshape(-1, x.shape[-1])
    mean = xf.mean(-1)
    var = (xf - mean[:, None]).square().mean(-1)
    return mean, torch.rsqrt(var + eps)


def layer_norm_bwd_reference(dy: torch.Tensor, x: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor,
                             weight: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain backward, in float32: with x̂ = (x - mean)·rstd and g = w·dy,
    dx = rstd·(g - mean(g) - x̂·mean(g·x̂)) in x's type, dweight = Σ dy·x̂
    and dbias = Σ dy over the rows, float32."""
    width = x.shape[-1]
    xf = x.float().reshape(-1, width)
    g = dy.float().reshape(-1, width)
    mean, rstd = mean.reshape(-1, 1), rstd.reshape(-1, 1)
    xhat = (xf - mean) * rstd
    wg = g * weight.float()
    dx = rstd * (wg - wg.mean(-1, keepdim=True)
                 - xhat * (wg * xhat).mean(-1, keepdim=True))
    return (dx.to(x.dtype).reshape(x.shape), (g * xhat).sum(0), g.sum(0))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def ln_plan(width: int, dtype: torch.dtype, aligned: bool
            ) -> Tuple[int, int, int]:
    """(vec, nv, row_warps): a lane holds nv vectors of vec values, a row
    takes row_warps warps. 16-byte vectors when the width is a multiple of
    one and every pointer starts on a 16-byte boundary, single values
    otherwise; as few warps a row as keep a lane's values to VEC_MAX
    vectors (24 bf16, 8 float32) or SCALAR_NV single values, and at 8
    warps a row up to VEC_LIMIT vectors. A pure function of its
    arguments."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"the LayerNorm kernel takes float32 or bfloat16 "
                         f"activations; got {dtype}")
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"the LayerNorm kernel takes widths 1..{MAX_WIDTH}; "
                         f"got {width}")
    vec = VEC[dtype] if aligned and width % VEC[dtype] == 0 else 1
    cap = VEC_MAX[dtype] if vec > 1 else SCALAR_NV
    for row_warps in ROW_WARPS:
        need = _cdiv(width // vec, 32 * row_warps)
        if need <= cap or (vec > 1 and row_warps == ROW_WARPS[-1]
                           and need <= VEC_LIMIT):
            return vec, (need if vec > 1 else SCALAR_NV), row_warps
    raise AssertionError(f"no plan for width {width}")  # MAX_WIDTH fits


_PTR, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
# forward: x, dtype code, weight, bias, y; rows, W, vec, nv, row_warps; eps;
# stream. backward: dy, x, dtype code, weight, dx, partials, grid; rows, W,
# vec, nv, row_warps; eps; stream. The occupancy query: dtype code, vec, nv;
# the blocks an SM holds (out)
ENTRY_POINTS = {
    "ln_f32_fwd": [_PTR, _I32, _PTR, _PTR, _PTR, _I64] + [_I32] * 4
                  + [_F32, _PTR],
    "ln_f32_bwd": [_PTR, _PTR, _I32, _PTR, _PTR, _PTR, _I32, _I64]
                  + [_I32] * 4 + [_F32, _PTR],
    "ln_f32_bwd_occupancy": [_I32, _I32, _I32, ctypes.POINTER(_I32)],
}


@functools.lru_cache(maxsize=None)
def bwd_grid_limit(index: int, code: int, vec: int, nv: int) -> int:
    """Blocks of the backward kernel that CUDA device `index` holds at once
    (its grid, and so its partial rows, at most): read once a device."""
    fn = load_library("layer_norm", ENTRY_POINTS).ln_f32_bwd_occupancy
    return occupancy(fn, index, code, vec, nv) * sm_count(index)


def layer_norm_f32_fwd(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The forward kernel: y of x's shape and type (x made contiguous)."""
    x = x.contiguous()
    width = x.shape[-1]
    rows = x.numel() // width
    y = torch.empty_like(x)
    if rows == 0:
        return y
    px, pw, pb = x.data_ptr(), weight.data_ptr(), bias.data_ptr()
    vec, nv, rw = ln_plan(width, x.dtype, (px | pw | pb) % 16 == 0)
    launch(layer_norm_f32, load_library("layer_norm", ENTRY_POINTS).ln_f32_fwd,
           x.get_device(), px, _DTYPE_CODES[x.dtype], pw, pb, y.data_ptr(),
           rows, width, vec, nv, rw, eps)
    return y


def layer_norm_f32_bwd(dy: torch.Tensor, x: torch.Tensor,
                       weight: torch.Tensor, eps: float, need_dx: bool = True,
                       need_params: bool = True
                       ) -> Tuple[Optional[torch.Tensor],
                                  Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """(dx, dweight, dbias) of the forward kernel's y (the row statistics
    taken again from x): dx in x's shape and type, the two float32; what is
    not asked for is None and not computed."""
    x, dy = x.contiguous(), dy.contiguous()
    if dy.dtype is not x.dtype:
        dy = dy.to(x.dtype)
    width = x.shape[-1]
    rows = x.numel() // width
    dx = torch.empty_like(x) if need_dx else None
    if rows == 0 or not (need_dx or need_params):
        dw, db = ((x.new_zeros(width, dtype=torch.float32),
                   x.new_zeros(width, dtype=torch.float32)) if need_params
                  else (None, None))
        return dx, dw, db
    code, index = _DTYPE_CODES[x.dtype], x.get_device()
    pg, px, pw = dy.data_ptr(), x.data_ptr(), weight.data_ptr()
    pdx = 0 if dx is None else dx.data_ptr()
    vec, nv, rw = ln_plan(width, x.dtype, (pg | px | pw | pdx) % 16 == 0)
    grid = min(_cdiv(rows, WARPS // rw), bwd_grid_limit(index, code, vec, nv))
    # the partial rows; the first becomes their column sums, [dw | db]
    part = (x.new_empty((grid, 2, width), dtype=torch.float32)
            if need_params else None)
    launch(layer_norm_f32_bwd,
           load_library("layer_norm", ENTRY_POINTS).ln_f32_bwd, index, pg, px,
           code, pw, pdx or None, None if part is None else part.data_ptr(),
           grid, rows, width, vec, nv, rw, eps)
    dw, db = part[0].unbind() if part is not None else (None, None)
    return dx, dw, db


class _LayerNormF32(torch.autograd.Function):
    """The kernel pair under autograd: saves x in its own type (no float32
    copy, no statistics)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return layer_norm_f32_fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = layer_norm_f32_bwd(dy, x, weight, ctx.eps, need_x,
                                        need_w or need_b)
        return dx, (dw if need_w else None), (db if need_b else None), None


def layer_norm_f32(x: torch.Tensor, normalized_shape: Sequence[int],
                   weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in float32, the output in x's type;
    differentiable. The plain chain on the CPU, the kernel on CUDA."""
    if not x.is_cuda:
        return layer_norm_reference(x, normalized_shape, weight, bias, eps)
    width = x.shape[-1]
    if tuple(normalized_shape) != (width,):
        raise ValueError(f"the LayerNorm kernel normalises the last axis "
                         f"only; got normalized_shape "
                         f"{tuple(normalized_shape)} for x {tuple(x.shape)}")
    if weight is None:
        weight = x.new_ones(width, dtype=torch.float32)
    if bias is None:
        bias = x.new_zeros(width, dtype=torch.float32)
    index = x.get_device()
    if (weight.dtype is not torch.float32 or bias.dtype is not torch.float32
            or weight.shape != (width,) or bias.shape != (width,)
            or weight.get_device() != index or bias.get_device() != index
            or not (weight.is_contiguous() and bias.is_contiguous())):
        raise ValueError(f"weight and bias must be contiguous float32 of "
                         f"shape ({width},) on {x.device}; got "
                         f"{weight.dtype} {tuple(weight.shape)} on "
                         f"{weight.device}, {bias.dtype} {tuple(bias.shape)} "
                         f"on {bias.device}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNormF32.apply(x, weight, bias, float(eps))
    return layer_norm_f32_fwd(x, weight, bias, eps)


counted(layer_norm_f32, layer_norm_f32_bwd)
