"""LLaMA decoder: the language model behind the LLaMA-2 rewriter and the
LLaVA captioner (`models/llava.py`).

Counterpart of `spn4cir_tpu/models/llama.py`, under HF `LlamaForCausalLM`
names, so an HF state dict loads with `load_state_dict`:
`model.embed_tokens`, `model.layers.{i}.self_attn.{q,k,v,o}_proj`,
`model.layers.{i}.{input,post_attention}_layernorm`,
`model.layers.{i}.mlp.{gate,up,down}_proj`, `model.norm`, `lm_head`.
RMSNorm pre-norm (variance in float32), rotary embeddings in HF's
rotate_half layout, optional grouped-query attention, SwiGLU MLP, no
biases, an untied head.

Generation is the JAX package's prefill / decode split over a static
(n_layers, B, L, KVH·hd) KV cache, float32, bf16 or int8 with per-row
scales (`LlamaDecodeState`). The functions take `params`: a
`LlamaForCausalLM`, or the dict of `quantize_llama_weights` (int8 matmul
weights as `QuantKernel`, HF names). Unlike the JAX package's pure
functions, `llama_prefill*` and `llama_decode_step` write the cache in
place and return the state they were given: at 7B a bf16 cache is 15.5 GB at
B=16, too big to copy per step.

Kernels (inference only, no gradient):
  - every decode step's attention goes through `ops.decode_attn.
    decode_attention` (kernel #11) when `attn_kernel` is on, the default
    (`DECODE_ATTN_DEFAULT`), for every geometry: GQA and any head_dim % 8 ==
    0 included. Off, the einsum path (`decode_attention_reference`) runs. The
    JAX package pads the cache to a multiple of 128 for its kernel; nothing
    here does, the kernel masks its own tail;
  - with int8 weights and `quant_kernel=True`, every decode step's products
    go through `ops.quant_matmul.quant_matmul` (kernel #12); the default is
    off, as in the JAX package, and prefill never takes it.
Prefill attention is tensor code with an additive mask (causal plus
left-pad, or the chunk's rectangle of it), as in the JAX package: it does
not go through `ops.attention_kernels.attention_route`, whose causal branch
is the short-sequence kernel and refuses S > 128 on a CUDA tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spn4cir_tpu_torch.models.generation import (NEG_INF, top_k_filter,
                                                 top_p_filter)
from spn4cir_tpu_torch.ops.decode_attn import (decode_attention,
                                               decode_attention_reference,
                                               read_layer, repeat_kv)
from spn4cir_tpu_torch.ops.quant_matmul import quant_matmul

# Decode attention through kernel #11 unless the caller says otherwise: the
# JAX package's default; its TPU measurements do not carry over, and the
# H100 A/B is in PERF.md.
DECODE_ATTN_DEFAULT = True


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None => MHA (LLaVA-v1 7B/13B)
    intermediate_size: int = 11008
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def llama_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def llama2_7b_chat(cls) -> "LlamaConfig":
        # LLaMA-2 ships rms_norm_eps=1e-5 and a 4k context
        return cls(max_position_embeddings=4096, rms_eps=1e-5)

    @classmethod
    def tiny(cls, vocab_size: int = 128, **kw) -> "LlamaConfig":
        base = dict(vocab_size=vocab_size, hidden_size=32, num_layers=2,
                    num_heads=4, intermediate_size=64,
                    max_position_embeddings=128)
        base.update(kw)
        return cls(**base)


# ---------------------------------------------------------------------------
# RoPE (HF layout: [first-half, second-half] rotate_half, NOT interleaved),
# RMSNorm
# ---------------------------------------------------------------------------

def rope_tables(cfg: LlamaConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given (…,) int positions -> (…, head_dim)."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, hd, 2, dtype=torch.float32, device=positions.device) / hd))
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, head_dim); cos/sin: (S, head_dim) or (B, S, head_dim),
    broadcast over the heads. HF apply_rotary_pos_emb; a bf16 x comes out
    float32, as in the JAX package (type promotion against the tables)."""
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return x * c + _rotate_half(x) * s


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """HF LlamaRMSNorm: variance in float32, the weight applied in x's type."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight.to(dt)


# ---------------------------------------------------------------------------
# weight-only int8: per-output-channel absmax
# ---------------------------------------------------------------------------

class QuantKernel(NamedTuple):
    """An int8 weight with float32 scales. A matmul weight holds values
    (D, F), the JAX package's (in, out) layout that kernel #12 reads, with
    scales (F,) applied to the product; the embedding table holds values
    (V, D) with per-row scales (V,), the lookup axis."""

    values: torch.Tensor
    scales: torch.Tensor


def _mm(x: torch.Tensor, w, use_kernel: bool = False) -> torch.Tensor:
    """x @ w for a dense HF weight (F, D) or a QuantKernel.

    A dense product runs in the promoted type of x and w, as `x @ w` does
    in JAX (a float32 x against bf16 weights is a float32 product). A
    QuantKernel takes kernel #12 when `use_kernel` (decode steps with
    `quant_kernel=True`), else dequant-after-matmul: the product in x's
    type, then the scales in x's type."""
    if isinstance(w, QuantKernel):
        if use_kernel:
            return quant_matmul(x, w.values, w.scales)
        return (x @ w.values.to(x.dtype)) * w.scales.to(x.dtype)
    dt = torch.promote_types(x.dtype, w.dtype)
    return F.linear(x.to(dt), w.to(dt))


def _embed_rows(table, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup: a dense (V, D) table, or an int8 QuantKernel whose
    rows come out float32 (so an int8-weight residual stream is float32)."""
    if isinstance(table, QuantKernel):
        return table.values[ids].to(torch.float32) * table.scales[ids][..., None]
    return table[ids]


def embed_tokens(params, ids: torch.Tensor) -> torch.Tensor:
    """The prompt's input embeddings: `_embed_rows` over the embedding
    table of `params` (a LlamaForCausalLM or a quantized dict)."""
    return _embed_rows(_flat(params)["model.embed_tokens.weight"], ids)


def params_device(params) -> torch.device:
    """The device that holds the weights of `params`."""
    table = _flat(params)["model.embed_tokens.weight"]
    return (table.values if isinstance(table, QuantKernel) else table).device


_PROJ = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
         "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def _quant_table(w: torch.Tensor) -> QuantKernel:
    """A (V, D) embedding table -> int8 rows with per-row scales (V,): the
    JAX package's absmax, clamped before the division."""
    w = w.detach().to(torch.float32)
    scales = torch.clamp(w.abs().amax(dim=1), min=1e-12) / 127.0
    vals = torch.clamp(torch.round(w / scales[:, None]), -127, 127)
    return QuantKernel(vals.to(torch.int8), scales)


def _quant_cols(w: torch.Tensor) -> QuantKernel:
    """An HF (F, D) weight -> QuantKernel((D, F) int8, (F,) scales): the
    per-output-channel scales are the rows' of the HF layout."""
    q = _quant_table(w)
    return QuantKernel(q.values.t().contiguous(), q.scales)


_PROJ_WEIGHTS = tuple(f"{p}.weight" for p in _PROJ)


def quantize_llama_weights(params) -> Dict[str, Any]:
    """Weight-only int8 of a LlamaForCausalLM (or its state dict): every
    matmul weight (q/k/v/o, gate/up/down of each layer, lm_head) gets
    per-output-channel absmax scales, embed_tokens per-row scales; the
    RMSNorm weights stay as they are. Returns a dict under the HF names that
    `llama_prefill`, `llama_decode_step` and `llama_generate` take as
    `params`. One weight at a time is widened to float32, on its device."""
    flat = _flat(params)
    out: Dict[str, Any] = {}
    for name, w in flat.items():
        if name == "model.embed_tokens.weight":
            out[name] = _quant_table(w)
        elif name == "lm_head.weight" or name.endswith(_PROJ_WEIGHTS):
            out[name] = _quant_cols(w)
        else:
            out[name] = w.detach()
    return out


# ---------------------------------------------------------------------------
# the module tree (HF names) and its teacher-forced forward
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_llama_param(name: str, p: torch.Tensor,
                     generator: torch.Generator) -> None:
    """One LM weight drawn in place: normal 0.02 for the embedding and the
    head, fan_in^-½ for the projections, ones for the norms."""
    if name.endswith("layernorm.weight") or name == "model.norm.weight":
        p.fill_(1.0)
    elif name in ("model.embed_tokens.weight", "lm_head.weight"):
        p.normal_(0.0, 0.02, generator=generator)
    else:
        p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)


class LlamaRMSNorm(nn.Module):
    def __init__(self, hidden: int, eps: float, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden, **factory))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        hd = cfg.head_dim
        d = cfg.hidden_size
        self.q_proj = nn.Linear(d, cfg.num_heads * hd, bias=False, **factory)
        self.k_proj = nn.Linear(d, cfg.kv_heads * hd, bias=False, **factory)
        self.v_proj = nn.Linear(d, cfg.kv_heads * hd, bias=False, **factory)
        self.o_proj = nn.Linear(cfg.num_heads * hd, d, bias=False, **factory)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(d, f, bias=False, **factory)
        self.up_proj = nn.Linear(d, f, bias=False, **factory)
        self.down_proj = nn.Linear(f, d, bias=False, **factory)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.self_attn = LlamaAttention(cfg, **factory)
        self.mlp = LlamaMLP(cfg, **factory)
        self.input_layernorm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_eps,
                                            **factory)
        self.post_attention_layernorm = LlamaRMSNorm(cfg.hidden_size,
                                                     cfg.rms_eps, **factory)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **factory)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, **factory)
                                    for _ in range(cfg.num_layers))
        self.norm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_eps, **factory)


class LlamaForCausalLM(nn.Module):
    """Teacher-forced causal LM: ids or embeddings -> (B, S, vocab) float32
    logits, and the weights that the generation functions read.

    `device="meta"` then `to_empty(device=...)` and `init_weights` builds a
    7B on the card without a first random pass."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        factory = dict(device=device, dtype=dtype)
        self.model = LlamaModel(cfg, **factory)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 **factory)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights drawn in place from `generator` (of the weights'
        device): the JAX initialisers' scales (`init_llama_param`)."""
        for name, p in self.named_parameters():
            init_llama_param(name, p, generator)

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """`inputs_embeds` takes precedence over `input_ids` (the LLaVA
        path splices image features into the embeddings)."""
        cfg = self.cfg
        w = _weights(self, cfg)
        if inputs_embeds is None:
            inputs_embeds = _embed_rows(w.embed, input_ids)
        x = inputs_embeds.to(self.lm_head.weight.dtype)
        ar = torch.arange(x.shape[1], device=x.device)
        out = _full_forward(cfg, w, x, rope_tables(cfg, ar),
                            _pad_mask(attention_mask, _causal(ar, len(ar))),
                            _mm)
        return _mm(out.to(torch.float32), w.lm_head)


# ---------------------------------------------------------------------------
# the weights as the generation functions read them
# ---------------------------------------------------------------------------

def _flat(params) -> Mapping[str, Any]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


class _Weights(NamedTuple):
    embed: Any
    layers: List[Dict[str, Any]]
    norm: torch.Tensor
    lm_head: Any


def _weights(params, cfg: LlamaConfig) -> _Weights:
    flat = _flat(params)
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        lw = {key: flat[f"{p}{name}.weight"] for key, name in zip(
            ("q", "k", "v", "o", "gate", "up", "down"), _PROJ)}
        lw["input_ln"] = flat[f"{p}input_layernorm.weight"]
        lw["post_ln"] = flat[f"{p}post_attention_layernorm.weight"]
        layers.append(lw)
    return _Weights(flat["model.embed_tokens.weight"], layers,
                    flat["model.norm.weight"], flat["lm_head.weight"])


def _causal(keys: torch.Tensor, rows: int, off: int = 0) -> torch.Tensor:
    """(rows, len(keys)) additive mask: key j visible to row i (global
    off + i) iff j <= off + i."""
    q = off + torch.arange(rows, device=keys.device)
    return torch.where(keys[None, :] <= q[:, None], 0.0, NEG_INF)


def _qkv(cfg: LlamaConfig, lw, h: torch.Tensor, mm):
    """q (…, H, hd), k (…, KVH, hd), v (…, KVH·hd) of the normed stream h."""
    hd = cfg.head_dim
    lead = h.shape[:-1]
    q = mm(h, lw["q"]).reshape(*lead, cfg.num_heads, hd)
    k = mm(h, lw["k"]).reshape(*lead, cfg.kv_heads, hd)
    return q, k, mm(h, lw["v"])


def _attend(q, kh, vh, mask, k_scale, v_scale) -> torch.Tensor:
    """softmax(q·khᵀ·hd^-½ [· k_scale] + mask) [· v_scale] · vh over
    (B, S, H, hd) tensors: float32 logits (the JAX package's
    preferred_element_type), the weights cast to vh's type before the V
    product. Returns (B, S, H, hd)."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          kh.to(torch.float32)) * (hd ** -0.5)
    if k_scale is not None:
        logits = logits * k_scale[:, None, None, :]
    logits = logits + mask
    w = torch.softmax(logits, dim=-1).to(vh.dtype)
    if v_scale is not None:
        w = w * v_scale[:, None, None, :].to(w.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vh)


def _residual_mlp(cfg: LlamaConfig, lw, x, ctx, mm) -> torch.Tensor:
    """x + o(ctx), then the SwiGLU MLP block; the residual stream keeps x's
    type."""
    x = x + mm(ctx, lw["o"]).to(x.dtype)
    h = rms_norm(x, lw["post_ln"], cfg.rms_eps)
    gate = mm(h, lw["gate"])
    up = mm(h, lw["up"])
    return x + mm(F.silu(gate) * up, lw["down"]).to(x.dtype)


# ---------------------------------------------------------------------------
# KV-cached incremental decoding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LlamaDecodeState:
    """Static-shape KV cache: k/v (n_layers, B, L, kv_heads·head_dim).

    int8 cache (`init_llama_state(dtype=torch.int8)`): k/v hold per-row
    symmetric int8 and k_scale/v_scale (n_layers, B, L) float32 the
    per-(layer, batch, position) absmax/127 scales; they factor out of both
    attention products exactly."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def cache(self) -> Tuple[torch.Tensor, ...]:
        if self.quantized:
            return (self.k, self.v, self.k_scale, self.v_scale)
        return (self.k, self.v)

    def clone(self) -> "LlamaDecodeState":
        return LlamaDecodeState(*(t.clone() for t in self.cache))


def init_llama_state(cfg: LlamaConfig, batch: int, max_length: int,
                     dtype=torch.float32, device=None) -> LlamaDecodeState:
    """A zero cache of float32, bfloat16 or int8 (with unit scales)."""
    shape = (cfg.num_layers, batch, max_length, cfg.kv_heads * cfg.head_dim)
    k = torch.zeros(shape, dtype=dtype, device=device)
    v = torch.zeros(shape, dtype=dtype, device=device)
    if dtype == torch.int8:
        ones = (cfg.num_layers, batch, max_length)
        return LlamaDecodeState(
            k, v, torch.ones(ones, dtype=torch.float32, device=device),
            torch.ones(ones, dtype=torch.float32, device=device))
    return LlamaDecodeState(k, v)


def _quant_rows(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> int8 rows + (...,) float32 absmax/127 scales (symmetric),
    the clamp after the division, as the JAX package's `_quant_rows`."""
    tf = t.to(torch.float32)
    scale = torch.clamp(tf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _cache_write(state: LlamaDecodeState, li: int, off: int,
                 kflat: torch.Tensor, v: torch.Tensor) -> None:
    """Write rows [off, off + c) of layer `li` in place; the int8 form
    quantizes per row. kflat / v: (B, c, KVH·hd) at full precision."""
    end = off + kflat.shape[1]
    if state.quantized:
        kq, ks = _quant_rows(kflat)
        vq, vs = _quant_rows(v)
        state.k[li, :, off:end] = kq
        state.v[li, :, off:end] = vq
        state.k_scale[li, :, off:end] = ks
        state.v_scale[li, :, off:end] = vs
    else:
        state.k[li, :, off:end] = kflat.to(state.k.dtype)
        state.v[li, :, off:end] = v.to(state.v.dtype)


def _pad_mask(pad_mask: Optional[torch.Tensor], causal: torch.Tensor
              ) -> torch.Tensor:
    """(rows, keys) causal mask + the (B, keys) pad mask -> (B or 1, 1,
    rows, keys)."""
    if pad_mask is None:
        return causal[None, None]
    pad = (1.0 - pad_mask.to(torch.float32)) * NEG_INF
    return causal[None, None] + pad[:, None, None, :]


def _full_forward(cfg: LlamaConfig, w: _Weights, x: torch.Tensor, tables,
                  mask: torch.Tensor, mm,
                  state: Optional[LlamaDecodeState] = None) -> torch.Tensor:
    """Every layer over all positions of x (B, P, D), attending to the fresh
    keys and values (not the cache's rounding) under the additive mask,
    then the final norm; with `state`, cache rows [0, P) are written."""
    batch, plen, _ = x.shape
    n_rep = cfg.num_heads // cfg.kv_heads
    cos, sin = tables
    for li, lw in enumerate(w.layers):
        h = rms_norm(x, lw["input_ln"], cfg.rms_eps)
        q, k, v = _qkv(cfg, lw, h, mm)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if state is not None:
            _cache_write(state, li, 0, k.reshape(batch, plen, -1), v)
        vh = v.reshape(batch, plen, cfg.kv_heads, -1)
        ctx = _attend(q, repeat_kv(k, n_rep), repeat_kv(vh, n_rep), mask,
                      None, None)
        x = _residual_mlp(cfg, lw, x, ctx.reshape(batch, plen, -1), mm)
    return rms_norm(x, w.norm, cfg.rms_eps)


@torch.no_grad()
def llama_prefill(params, cfg: LlamaConfig, state: LlamaDecodeState,
                  x: torch.Tensor, *, positions: Optional[torch.Tensor] = None,
                  pad_mask: Optional[torch.Tensor] = None,
                  quant_kernel: bool = False
                  ) -> Tuple[torch.Tensor, LlamaDecodeState]:
    """The whole prompt in one batched forward: x (B, P, D) input embeddings
    -> (last-position logits (B, vocab) float32, the state with cache rows
    [0, P) written).

    `positions` (B, P) and `pad_mask` (B, P, 1 = real) take LEFT-padded
    ragged batches (per-row RoPE positions, pad keys masked); both default
    to the dense single-length case."""
    w = _weights(params, cfg)
    mm = lambda a, wt: _mm(a, wt, quant_kernel)  # noqa: E731
    ar = torch.arange(x.shape[1], device=x.device)
    out = _full_forward(cfg, w, x, rope_tables(
        cfg, ar if positions is None else positions),
        _pad_mask(pad_mask, _causal(ar, len(ar))), mm, state)
    return mm(out[:, -1].to(torch.float32), w.lm_head), state


@torch.no_grad()
def llama_prefill_chunked(params, cfg: LlamaConfig, state: LlamaDecodeState,
                          x: torch.Tensor, *, chunk: int,
                          positions: Optional[torch.Tensor] = None,
                          pad_mask: Optional[torch.Tensor] = None,
                          quant_kernel: bool = False
                          ) -> Tuple[torch.Tensor, LlamaDecodeState]:
    """`llama_prefill` in prompt chunks of `chunk` positions: chunk c
    attends over cache rows [0, off + C), so the float32 logits are
    (B, H, C, off + C) and not (B, H, P, P). Earlier chunks' keys are read
    back from the cache at its type, as decode reads them."""
    w = _weights(params, cfg)
    mm = lambda a, wt: _mm(a, wt, quant_kernel)  # noqa: E731
    batch, plen, _ = x.shape
    keys = torch.arange(plen, device=x.device)
    last = None
    for off in range(0, plen, chunk):
        end = min(off + chunk, plen)
        c = end - off
        xb = x[:, off:end]
        cos, sin = rope_tables(cfg, keys[off:end] if positions is None
                               else positions[:, off:end])
        mask = _pad_mask(None if pad_mask is None else pad_mask[:, :end],
                         _causal(keys[:end], c, off))
        for li, lw in enumerate(w.layers):
            h = rms_norm(xb, lw["input_ln"], cfg.rms_eps)
            q, k, v = _qkv(cfg, lw, h, mm)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            _cache_write(state, li, off, k.reshape(batch, c, -1), v)
            kh, vh, ks, vs = read_layer(state.cache, li, end, cfg.num_heads,
                                        cfg.head_dim)
            ctx = _attend(q, kh, vh, mask, ks, vs)
            xb = _residual_mlp(cfg, lw, xb, ctx.reshape(batch, c, -1), mm)
        last = xb[:, -1]
    out = rms_norm(last, w.norm, cfg.rms_eps)
    return mm(out.to(torch.float32), w.lm_head), state


@torch.no_grad()
def llama_decode_step(params, cfg: LlamaConfig, state: LlamaDecodeState,
                      x: torch.Tensor, pos: int, *,
                      rope_pos: Optional[torch.Tensor] = None,
                      key_mask: Optional[torch.Tensor] = None,
                      quant_kernel: bool = False,
                      attn_kernel: bool = False
                      ) -> Tuple[torch.Tensor, LlamaDecodeState]:
    """One incremental step: x (B, D) input embedding at cache position
    `pos` -> (logits (B, vocab) float32, the state with row `pos` written).

    `rope_pos` (B,) gives per-row RoPE positions of a LEFT-padded batch;
    `key_mask` (B, L) marks the valid cache rows. `attn_kernel` sends every
    layer's attention through `decode_attention` (kernel #11 on CUDA), off
    it takes the einsum path; `quant_kernel` sends int8 weights through
    kernel #12."""
    w = _weights(params, cfg)
    mm = lambda a, wt: _mm(a, wt, quant_kernel)  # noqa: E731
    hd = cfg.head_dim
    batch = x.shape[0]
    max_len = state.k.shape[2]
    dev = x.device
    # torch.full, not torch.tensor: no host-to-device copy, so the step's
    # launches never wait for the device
    cos, sin = rope_tables(cfg, torch.full((), pos, device=dev)
                           if rope_pos is None else rope_pos)
    if rope_pos is not None:
        cos, sin = cos[:, None, :], sin[:, None, :]  # (B, 1, hd) over heads

    def rope1(t):  # (B, H, hd) at one position
        return t * cos + _rotate_half(t) * sin

    # one (B, L) additive mask: the causal bound and the left-pad keys
    bias = torch.where(torch.arange(max_len, device=dev) <= pos, 0.0,
                       NEG_INF)[None, :]
    if key_mask is not None:
        bias = bias + (1.0 - key_mask.to(torch.float32)) * NEG_INF
    bias = bias.expand(batch, max_len).contiguous()
    attend = decode_attention if attn_kernel else decode_attention_reference
    scales = (state.k_scale, state.v_scale)
    for li, lw in enumerate(w.layers):
        h = rms_norm(x, lw["input_ln"], cfg.rms_eps)
        q, k, v = _qkv(cfg, lw, h, mm)
        q, k = rope1(q), rope1(k)
        _cache_write(state, li, pos, k.reshape(batch, 1, -1), v[:, None])
        ctx = attend(q.contiguous(), state.k, state.v, li, bias, *scales)
        x = _residual_mlp(cfg, lw, x, ctx.reshape(batch, -1), mm)
    x = rms_norm(x, w.norm, cfg.rms_eps)
    return mm(x.to(torch.float32), w.lm_head), state


@torch.no_grad()
def llama_generate(params, cfg: LlamaConfig, inputs_embeds: torch.Tensor, *,
                   eos_id: int, pad_id: int, max_new_tokens: int,
                   do_sample: bool = False, temperature: float = 1.0,
                   top_p: float = 1.0, top_k: int = 0,
                   cache_dtype=torch.float32,
                   generator: Optional[torch.Generator] = None,
                   attention_mask: Optional[torch.Tensor] = None,
                   quant_kernel: Optional[bool] = None,
                   prefill_chunk: Optional[int] = None,
                   attn_kernel: Optional[bool] = None) -> torch.Tensor:
    """Generate continuations of an embedded prompt: inputs_embeds (B, P, D)
    -> (B, max_new_tokens) new token ids, `pad_id` after EOS.

    Sampling follows HF `generate`'s warper order (temperature -> top-k ->
    top-p), then one draw per row with `torch.multinomial` from `generator`
    (a generator of the device; seed 0 when none is given); greedy takes
    the argmax. Ragged batches: LEFT-padded embeddings with
    `attention_mask` (B, P, 1 = real); per-row RoPE positions come from the
    mask's cumsum and pad keys stay masked through prefill and every decode
    step. The prompt goes through `llama_prefill` (or, with
    `prefill_chunk` < P, `llama_prefill_chunked`), never through kernel
    #12; then max_new_tokens - 1 decode steps run, a fixed count whatever
    EOS does. The cache holds exactly P + max_new_tokens rows.

    `quant_kernel` (None = off, the JAX package's default everywhere)
    sends the decode steps' products over int8 weights through kernel #12;
    off, they dequantize after the matmul. Callers that quantize weights,
    the LLaVA captioner (`models/llava.py`) and
    `datagen.captioner.make_llava_captioner(quantize_weights=True)`
    included, leave it off unless asked, as the JAX captioner does.
    `attn_kernel` (None = `DECODE_ATTN_DEFAULT`, on) sends the decode
    steps' attention through kernel #11."""
    if quant_kernel is None:
        quant_kernel = False
    if attn_kernel is None:
        attn_kernel = DECODE_ATTN_DEFAULT
    dev = inputs_embeds.device
    batch, prompt_len, _ = inputs_embeds.shape
    total = prompt_len + max_new_tokens
    state = init_llama_state(cfg, batch, total, dtype=cache_dtype, device=dev)
    if generator is None and do_sample:
        generator = torch.Generator(device=dev).manual_seed(0)
    embed = _weights(params, cfg).embed
    if attention_mask is not None:
        am = attention_mask.to(torch.int64)
        positions = torch.clamp(torch.cumsum(am, dim=1) - 1, min=0)
        lengths = am.sum(dim=1)
        valid = torch.cat([am, torch.ones(batch, max_new_tokens,
                                          dtype=torch.int64, device=dev)], 1)
    else:
        am = positions = lengths = valid = None

    def sample_from(logits):
        if do_sample:
            filt = logits / max(temperature, 1e-6)
            if top_k:
                filt = top_k_filter(filt, top_k)
            if top_p < 1.0:
                filt = top_p_filter(filt, top_p)
            return torch.multinomial(torch.softmax(filt, dim=-1), 1,
                                     generator=generator)[:, 0]
        return torch.argmax(logits, dim=-1)

    if prefill_chunk and prefill_chunk < prompt_len:
        logits0, state = llama_prefill_chunked(
            params, cfg, state, inputs_embeds, chunk=prefill_chunk,
            positions=positions, pad_mask=am)
    else:
        logits0, state = llama_prefill(params, cfg, state, inputs_embeds,
                                       positions=positions, pad_mask=am)
    tok = sample_from(logits0)
    out = torch.full((batch, max_new_tokens), pad_id, dtype=torch.int64,
                     device=dev)
    out[:, 0] = tok
    finished = tok == eos_id
    for i in range(1, max_new_tokens):
        x = _embed_rows(embed, tok)
        logits, state = llama_decode_step(
            params, cfg, state, x, prompt_len + i - 1,
            rope_pos=None if lengths is None else lengths + i - 1,
            key_mask=valid, quant_kernel=quant_kernel,
            attn_kernel=attn_kernel)
        nxt = torch.where(finished, pad_id, sample_from(logits))
        out[:, i] = nxt
        finished = finished | (nxt == eos_id)
        tok = nxt
    return out
