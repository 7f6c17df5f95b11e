"""Decode-step attention of the LLaMA decoders, and its kernel.

Counterpart of `spn4cir_tpu/ops/decode_attn.py`. One decode step's attention
per (batch row b, head h), against layer `li` of the stacked cache:

    logits = q[b, h] · K[li, b, :, kvh]ᵀ · hd^-½     [· k_scale[li, b]]
    w      = softmax(logits + bias[b])               [· v_scale[li, b]]
    ctx    = w · V[li, b, :, kvh]

with kvh = h // (H / KVH), so grouped-query attention takes the same route.
`bias` (B, L) float32 carries the causal bound and the left-pad mask. The
kernel (`csrc/decode_attention.cu`, replacing the TPU `_kernel`) is built
with nvcc at first use and counts its launches in
`decode_attention.launches`; `split_plan` cuts L into as few splits as
give every SM a block, from the SM count read once a device
(`device_plan_inputs`).

Routes: on a CUDA tensor `decode_attention` launches the kernel or raises,
for every head_dim that is a multiple of 8 up to 128, every L and every
GQA ratio; on a CPU tensor it runs `decode_attention_reference`, the plain
PyTorch version, counting nothing. The JAX package's geometry gate
(`supports_decode_attention`: MHA only, hd and L multiples of 128) is a TPU
rule and has no counterpart here.

The TPU kernel reads the whole stacked cache and picks the layer in its
index map so that no layer slice is copied; here `k_cache[li]` is a view,
passed as a base pointer and strides.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from spn4cir_tpu_torch.ops.cuda_build import (counted, launch, load_library,
                                              occupancy, sm_count)

MAX_HEAD_DIM = 128
MAX_SPLITS = 8        # splits of L: one thread-block cluster (kMaxSplits)
MIN_SPLIT_ROWS = 64   # splits of L: at most ceil(L / MIN_SPLIT_ROWS)
WARPS = 8             # warps of a block, each on every 8th tile (kWarps)
# rows of a lane group in one tile (group_rows): 2 KB of K and V at hd = 128
# over bf16 and int8, 4 KB over float32
GROUP_ROWS = {torch.float32: 2, torch.bfloat16: 2, torch.int8: 4}

_CACHE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KVH, hd) -> (B, S, KVH·n_rep, hd), HF repeat_kv order."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def read_layer(cache: Tuple[torch.Tensor, ...], li: int, end: int,
               num_heads: int, head_dim: int):
    """Rows [0, end) of layer `li` of the cache tuple ((k, v) or (k, v,
    k_scale, v_scale)) -> (kh, vh, k_scale | None, v_scale | None), heads
    expanded to `num_heads`; an int8 layer widens to float32 (its per-row
    scales factor out of both products exactly)."""
    k, v = cache[0][li, :, :end], cache[1][li, :, :end]
    batch = k.shape[0]
    kv_heads = k.shape[-1] // head_dim
    n_rep = num_heads // kv_heads
    kh = repeat_kv(k.reshape(batch, end, kv_heads, head_dim), n_rep)
    vh = repeat_kv(v.reshape(batch, end, kv_heads, head_dim), n_rep)
    if len(cache) == 4:
        return (kh.float(), vh.float(), cache[2][li, :, :end],
                cache[3][li, :, :end])
    return kh, vh, None, None


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, li: int,
                               bias: torch.Tensor,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain version: the einsum path of the JAX package's
    `llama_decode_step`, its roundings included (float32 logits, the
    softmax weights cast to V's type before the V product)."""
    batch, num_heads, hd = q.shape
    cache = ((k_cache, v_cache) if k_scale is None
             else (k_cache, v_cache, k_scale, v_scale))
    kh, vh, ks, vs = read_layer(cache, li, k_cache.shape[2], num_heads, hd)
    logits = torch.einsum("bhd,bkhd->bhk", q.float(), kh.float()) * (hd ** -0.5)
    if ks is not None:
        logits = logits * ks[:, None, :]
    logits = logits + bias.float()[:, None, :]
    w = torch.softmax(logits, dim=-1).to(vh.dtype)
    if vs is not None:
        w = w * vs[:, None, :].to(w.dtype)
    return torch.einsum("bhk,bkhd->bhd", w, vh)


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, q is bf16, k, v, cache code, the caches' batch and row strides, bias,
# its batch stride, k_scale, v_scale, their batch stride; B, H, KVH, hd, L,
# rows a split, splits; hd^-1/2; out; stream. The occupancy query: cache
# code, hd; the blocks an SM holds (out)
ENTRY_POINTS = {
    "decode_attention": ([_PTR, _I32, _PTR, _PTR, _I32, _I64, _I64, _PTR,
                          _I64, _PTR, _PTR, _I64] + [_I32] * 7
                         + [ctypes.c_float, _PTR, _PTR]),
    "decode_attention_occupancy": [_I32, _I32, ctypes.POINTER(_I32)],
}


@functools.lru_cache(maxsize=None)
def device_plan_inputs(index: int, cache_code: int, head_dim: int
                       ) -> Tuple[int, int]:
    """(SMs, blocks of the kernel an SM holds at once) on CUDA device
    `index` for a cache type code and head_dim, read once a device from
    the device's properties and the kernel's occupancy. `split_plan` takes
    the SMs; the blocks an SM holds are reported beside the kernel's
    times."""
    lib = load_library("decode_attention", ENTRY_POINTS)
    return sm_count(index), occupancy(lib.decode_attention_occupancy, index,
                                      cache_code, head_dim)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def lane_group(head_dim: int) -> int:
    """Lanes of a cache row in the kernel: the power of two >= hd / 8 (a
    lane holds 8 values of hd)."""
    g = 1
    while g * 8 < head_dim:
        g *= 2
    return g


def split_plan(length: int, pairs: int, sm_count: int) -> Tuple[int, int]:
    """(rows_per_split, n_splits): the fewest splits of each (b, h) pair's
    cache rows that give every SM a block (pairs x splits >= sm_count), at
    most MAX_SPLITS and ceil(L / MIN_SPLIT_ROWS). Each split beyond that
    adds a cluster merge and shortens the blocks, which keep fewer tiles in
    flight (PERF.md). A pure function of its arguments, so the order of
    every sum is fixed for a given device."""
    n = max(1, min(_cdiv(sm_count, pairs), MAX_SPLITS,
                   _cdiv(length, MIN_SPLIT_ROWS)))
    rows = _cdiv(length, n)
    return rows, _cdiv(length, rows)


def _check(q, k_cache, v_cache, li, bias, k_scale, v_scale) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"q (B, H, hd) and caches (n_layers, B, L, KVH·hd) "
                         f"of one shape; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    batch, heads, hd = q.shape
    n_layers, cb, length, width = k_cache.shape
    if cb != batch or width % hd or heads % (width // hd):
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q "
                         f"{tuple(q.shape)} (KVH·hd with H % KVH == 0)")
    if not 0 <= li < n_layers:
        raise ValueError(f"layer {li} outside the cache's {n_layers} layers")
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim % 8 == 0 and <= "
                         f"{MAX_HEAD_DIM}; got {hd}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16; got {q.dtype}")
    if k_cache.dtype != v_cache.dtype or k_cache.dtype not in _CACHE_CODES:
        raise ValueError(f"caches must share a type of float32, bfloat16 or "
                         f"int8; got {k_cache.dtype}, {v_cache.dtype}")
    quant = k_cache.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 cache takes k_scale and v_scale, a float "
                         "cache neither")
    if bias.shape != (batch, length) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32 (B, L) = {(batch, length)}; "
                         f"got {bias.dtype} {tuple(bias.shape)}")
    tensors = [q, k_cache, v_cache, bias]
    if quant:
        for sc in (k_scale, v_scale):
            if sc.shape != (n_layers, batch, length) or sc.dtype != torch.float32:
                raise ValueError(f"scales must be float32 (n_layers, B, L) = "
                                 f"{(n_layers, batch, length)}; got "
                                 f"{sc.dtype} {tuple(sc.shape)}")
        tensors += [k_scale, v_scale]
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, the caches, bias and scales must lie on one "
                         "device")
    if q.device.type != "cuda":
        raise ValueError(f"the decode_attention kernel launches on CUDA; the "
                         f"tensors lie on {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, the caches, bias and scales must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("q and the caches must be 16-byte aligned")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, li: int, bias: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, hd); k_cache / v_cache (n_layers, B, L, KVH·hd) float32,
    bfloat16 or int8; li the layer; bias (B, L) float32 additive mask;
    k_scale / v_scale (n_layers, B, L) float32 for an int8 cache. Returns
    ctx (B, H, hd) in the cache's type, float32 for int8: the kernel on CUDA,
    the plain version on the CPU."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, li, bias,
                                          k_scale, v_scale)
    _check(q, k_cache, v_cache, li, bias, k_scale, v_scale)
    batch, heads, hd = q.shape
    length, width = k_cache.shape[2], k_cache.shape[3]
    quant = k_cache.dtype == torch.int8
    out = torch.empty(batch, heads, hd, device=q.device,
                      dtype=torch.float32 if quant else k_cache.dtype)
    code = _CACHE_CODES[k_cache.dtype]
    index = q.get_device()
    rows, n_splits = split_plan(length, batch * heads,
                                device_plan_inputs(index, code, hd)[0])
    k, v = k_cache[li], v_cache[li]   # views: nothing is copied
    ks = k_scale[li] if quant else None
    vs = v_scale[li] if quant else None
    launch(decode_attention,
           load_library("decode_attention", ENTRY_POINTS).decode_attention,
           index, q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
           v.data_ptr(), code, k.stride(0), k.stride(1), bias.data_ptr(),
           bias.stride(0), ks.data_ptr() if quant else None,
           vs.data_ptr() if quant else None, ks.stride(0) if quant else 0,
           batch, heads, width // hd, hd, length, rows, n_splits, hd ** -0.5,
           out.data_ptr())
    return out


counted(decode_attention)
