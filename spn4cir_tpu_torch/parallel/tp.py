"""Tensor parallelism (Megatron, by hand) for the encoder towers and the
LLaMA / LLaVA decoders.

Counterpart of `spn4cir_tpu/parallel/tp.py`. The JAX package annotates
parameter shardings on a `model` mesh axis and lets GSPMD insert the
collectives; here each rank of the mesh's model group holds its slice of
the weights and the collectives are explicit:

- column-parallel (the output dim split; its bias with it): the attention's
  q/k/v projections and the MLP's up-projection. The input is copied to
  the group: identity forward, SUM of the input's gradient backward;
- row-parallel (the input dim split): the attention's out-projection and
  the MLP's down-projection, their output SUMmed over the group before the
  replicated bias.

One all-reduce after the attention and one after the MLP per block, the
Megatron pattern. Each attention's `num_heads` becomes the local count, and
a fused q/k/v projection is cut per q, k and v by heads, not as one block
of its output. A block whose heads or FFN width do not divide the model
size stays replicated: the result is the same, only the balance changes.
Everything else (LayerNorms, embeddings, the patch convolution, the heads)
is replicated.

Rules by module, the JAX package's name rules (`_COLUMN`/`_ROW` for the
towers of `models/layers.py`, `_COLUMN2`/`_ROW2` for the BERT family):
every `SelfAttention` (CLIP's fused `in_proj_weight`; BLIP's, EVA's and
Unicom's fused `qkv`, EVA's `q_bias`/`v_bias`; LLaVA's HF q/k/v) with its
`out_proj`/`proj`; the MLPs (`c_fc`/`c_proj`, `fc1`/`fc2`); MED's and the
Q-Former's `BertSelfAttention` (query/key/value) with its `BertSelfOutput`,
and `BertIntermediate`/`BertOutput` (the Q-Former's `*_query` pair too).
The matmuls reach the collectives through `models.layers.linear`, which
asks a layer for its `tp` (set here), and the fused projections through a
forward pre-hook on their attention module.

LLaMA (`shard_llama_params`): the local geometry is a `LlamaConfig` with
num_heads/n, kv_heads/n and intermediate_size/n; q/k/v/gate/up hold
column slices and o/down row slices, for dense and int8 `QuantKernel`
weights alike (the per-output-channel scales travel with column slices and
are replicated on row slices); o and down are SUMmed over the group and a
column-parallel lm_head is gathered to (B, V) before sampling (both through
`models.llama.ShardedWeight`). The KV cache is (L, B, S, local kv width),
and #11 runs on each rank over its local heads. The embedding table stays
replicated (262 MB of bf16 at 7B) where the JAX package splits its hidden
dim.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spn4cir_tpu_torch.parallel.mesh import (AXIS_MODEL, Mesh, all_reduce,
                                             make_mesh)


# --------------------------------------------------------------------------
# the two Megatron operators
# --------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group) if group is not None else x


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group) if group is not None else x


class ColumnParallel:
    """`layer.tp` of a column-parallel Linear: y = x W_locᵀ + b_loc."""

    def __init__(self, group):
        self.group = group

    def __call__(self, x, weight, bias):
        return F.linear(copy_to_model(x, self.group), weight, bias)


class RowParallel:
    """`layer.tp` of a row-parallel Linear: y = SUM(x_loc W_locᵀ) + b."""

    def __init__(self, group):
        self.group = group

    def __call__(self, x, weight, bias):
        y = reduce_from_model(F.linear(x, weight), self.group)
        return y if bias is None else y + bias


# --------------------------------------------------------------------------
# slicing
# --------------------------------------------------------------------------

def _chunk(t: torch.Tensor, dim: int, parts: int, n: int, i: int
           ) -> torch.Tensor:
    """Slice i of n of `t` along `dim`, taken inside each of `parts` equal
    blocks (a fused q/k/v: parts=3)."""
    blocks = t.chunk(parts, dim)
    return torch.cat([b.chunk(n, dim)[i] for b in blocks], dim).clone()


_MISSING = object()

# the edits of one cut in the order made, each a callable that reverts it
# (`tensor_parallel`), or None where the cut stays
Undo = Optional[List]


def _put(undo: Undo, obj, name: str, value) -> None:
    """setattr, recording in `undo` how to put the old value back."""
    if undo is not None:
        old = getattr(obj, name, _MISSING)
        undo.append(lambda: (delattr(obj, name) if old is _MISSING
                             else setattr(obj, name, old)))
    setattr(obj, name, value)


def _set(owner: nn.Module, name: str, dim: int, parts: int, n: int, i: int,
         undo: Undo):
    p = getattr(owner, name)
    new = nn.Parameter(_chunk(p.data, dim, parts, n, i),
                       requires_grad=p.requires_grad)
    new._tp = (dim, parts)
    _put(undo, owner, name, new)


def _column(layer: nn.Linear, n: int, i: int, undo: Undo, parts: int = 1,
            group=None):
    _set(layer, "weight", 0, parts, n, i, undo)
    if layer.bias is not None:
        _set(layer, "bias", 0, parts, n, i, undo)
    if group is not None:
        _put(undo, layer, "tp", ColumnParallel(group))


def _row(layer: nn.Linear, n: int, i: int, group, undo: Undo):
    _set(layer, "weight", 1, 1, n, i, undo)
    _put(undo, layer, "tp", RowParallel(group))


def _copy_input_hook(group):
    def hook(module, args):
        return (copy_to_model(args[0], group),) + tuple(args[1:])
    return hook


def _shard_attention(m: nn.Module, n: int, i: int, group, undo: Undo
                     ) -> bool:
    """A `models.layers.SelfAttention`: its fused or separate q/k/v cut by
    heads, the out-projection row-parallel, the input copied to the group
    by a pre-hook (the projections read it outside `linear`)."""
    if m.num_heads % n:
        return False
    if hasattr(m, "in_proj_weight"):          # CLIP
        _set(m, "in_proj_weight", 0, 3, n, i, undo)
        _set(m, "in_proj_bias", 0, 3, n, i, undo)
    elif hasattr(m, "qkv"):                   # BLIP / EVA / Unicom
        _column(m.qkv, n, i, undo, parts=3)
        for name in ("q_bias", "v_bias"):     # EVA
            if hasattr(m, name):
                _set(m, name, 0, 1, n, i, undo)
    else:                                     # LLaVA's HF q/k/v
        for proj in (m.q_proj, m.k_proj, m.v_proj):
            _column(proj, n, i, undo)
    _row(m.out_proj if hasattr(m, "out_proj") else m.proj, n, i, group,
         undo)
    _put(undo, m, "num_heads", m.num_heads // n)
    hook = m.register_forward_pre_hook(_copy_input_hook(group))
    if undo is not None:
        undo.append(hook.remove)
    return True


def _shard_bert_attention(m: nn.Module, n: int, i: int, group,
                          undo: Undo) -> bool:
    """MED / Q-Former `BertAttention`: query/key/value column-parallel by
    heads, `output.dense` row-parallel; the dropout of the attention
    weights still draws for every head (`med.Dropout`'s `heads`)."""
    sa = m.self
    if sa.num_heads % n:
        return False
    for proj in (sa.query, sa.key, sa.value):
        _column(proj, n, i, undo, group=group)
    _row(m.output.dense, n, i, group, undo)
    _put(undo, sa, "head_slice", (i * (sa.num_heads // n), sa.num_heads))
    _put(undo, sa, "num_heads", sa.num_heads // n)
    return True


def _shard_mlp(up: nn.Linear, down: nn.Linear, n: int, i: int, group,
               undo: Undo) -> bool:
    if up.out_features % n:
        return False
    _column(up, n, i, undo, group=group)
    _row(down, n, i, group, undo)
    return True


def _is_cut(module: nn.Module, mesh: Mesh) -> bool:
    """Nothing to cut: one model rank, or a module cut already."""
    return (mesh.size(AXIS_MODEL) == 1
            or getattr(module, "_tp_mesh", None) is not None)


def _shard(module: nn.Module, mesh: Mesh, undo: Undo) -> None:
    from spn4cir_tpu_torch.models.layers import SelfAttention
    from spn4cir_tpu_torch.models.med import (BertAttention, BertIntermediate,
                                              BertOutput)

    n = mesh.size(AXIS_MODEL)
    i, group = mesh.index(AXIS_MODEL), mesh.group(AXIS_MODEL)
    for name, m in list(module.named_modules()):
        if isinstance(m, SelfAttention):
            _shard_attention(m, n, i, group, undo)
        elif isinstance(m, BertAttention):
            _shard_bert_attention(m, n, i, group, undo)
        elif name.rsplit(".", 1)[-1] == "mlp":  # a block's MLP, by name
            up, down = (("c_fc", "c_proj") if hasattr(m, "c_fc")
                        else ("fc1", "fc2"))
            _shard_mlp(getattr(m, up), getattr(m, down), n, i, group, undo)
    # MED's FFN: BertIntermediate and its sibling BertOutput
    for m in list(module.modules()):
        for up, down in (("intermediate", "output"),
                         ("intermediate_query", "output_query")):
            a, b = getattr(m, up, None), getattr(m, down, None)
            if isinstance(a, BertIntermediate) and isinstance(b, BertOutput):
                _shard_mlp(a.dense, b.dense, n, i, group, undo)
    _put(undo, module, "_tp_mesh", mesh)


def shard_module_tp(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut `module`'s towers to this rank's tensor-parallel slice, in place
    and for good (see the module docstring for the rules); a second call
    does nothing. Do it before the optimizer is made: the slices are new
    parameters. Returns `module`."""
    if not _is_cut(module, mesh):
        _shard(module, mesh, None)
    return module


@contextlib.contextmanager
def tensor_parallel(module: nn.Module, mesh: Mesh):
    """`module` cut as `shard_module_tp` cuts it inside the block, and
    whole again after it: the original parameters, kept aside meanwhile,
    are put back (nothing is gathered), so the block must change no
    weights. For a pass after which one rank goes on alone with the
    module, such as the gallery encode of a service that rank 0 then
    serves. A module that is cut already stays cut."""
    if _is_cut(module, mesh):
        yield module
        return
    undo: List = []
    _shard(module, mesh, undo)
    try:
        yield module
    finally:
        for revert in reversed(undo):
            revert()


def tp_sharded_names(module: nn.Module) -> Dict[str, Tuple[int, int]]:
    """{parameter name: (split dim, fused parts)} of the sliced ones."""
    return {name: p._tp for name, p in module.named_parameters()
            if hasattr(p, "_tp")}


def full_state_dict(module: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The state dict of the whole model, the slices gathered over the
    model group (every rank of it must call this)."""
    group = mesh.group(AXIS_MODEL)
    sliced = tp_sharded_names(module)
    out = {}
    for name, t in module.state_dict().items():
        if name not in sliced or group is None:
            out[name] = t
            continue
        dim, parts = sliced[name]
        pieces = [torch.empty_like(t) for _ in range(mesh.size(AXIS_MODEL))]
        torch.distributed.all_gather(pieces, t.contiguous(), group=group)
        blocks = [p.chunk(parts, dim) for p in pieces]
        out[name] = torch.cat([torch.cat([b[k] for b in blocks], dim)
                               for k in range(parts)], dim)
    return out


def make_model_mesh(model: int, device=None) -> Mesh:
    """(1, 1, model): the datagen CLIs' --mesh_model, pure TP over `model`
    ranks (their batch stays whole on every rank)."""
    return make_mesh(data=1, bank=1, model=model, device=device)


# --------------------------------------------------------------------------
# LLaMA / LLaVA
# --------------------------------------------------------------------------

_LLAMA_COLUMN = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                 "mlp.gate_proj", "mlp.up_proj")
_LLAMA_ROW = ("self_attn.o_proj", "mlp.down_proj")


def llama_local_config(cfg, n: int):
    """The rank's geometry: heads, kv heads and FFN width divided where
    they divide (a block that does not stays whole); head_dim fixed."""
    attn = cfg.num_heads % n == 0 and cfg.kv_heads % n == 0
    mlp = cfg.intermediate_size % n == 0
    return dataclasses.replace(
        cfg, head_dim_fixed=cfg.head_dim,
        num_heads=cfg.num_heads // n if attn else cfg.num_heads,
        num_kv_heads=cfg.kv_heads // n if attn else cfg.num_kv_heads,
        intermediate_size=(cfg.intermediate_size // n if mlp
                           else cfg.intermediate_size)), attn, mlp


def _cols(w, n: int, i: int):
    """Column slice of a matmul weight: HF (F, D) rows, or a QuantKernel's
    (D, F) columns with its (F,) scales."""
    from spn4cir_tpu_torch.models.llama import QuantKernel

    if isinstance(w, QuantKernel):
        return QuantKernel(w.values.chunk(n, 1)[i].contiguous(),
                           w.scales.chunk(n, 0)[i].contiguous())
    return w.detach().chunk(n, 0)[i].contiguous()


def _rows(w, n: int, i: int):
    """Row (input-dim) slice: HF (D, F) columns, or a QuantKernel's (F, D)
    rows with its scales whole."""
    from spn4cir_tpu_torch.models.llama import QuantKernel

    if isinstance(w, QuantKernel):
        return QuantKernel(w.values.chunk(n, 0)[i].contiguous(), w.scales)
    return w.detach().chunk(n, 1)[i].contiguous()


def shard_llama_params(params, cfg, mesh: Mesh):
    """(this rank's params, its LlamaConfig) of a LlamaForCausalLM or a
    quantized dict (`quantize_llama_weights`). The slices are copies, so
    the caller may free the full weights."""
    from spn4cir_tpu_torch.models.llama import ShardedWeight, _flat

    n = mesh.size(AXIS_MODEL)
    flat = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in _flat(params).items()}
    if n == 1:
        return flat, cfg
    i, group = mesh.index(AXIS_MODEL), mesh.group(AXIS_MODEL)
    local_cfg, attn, mlp = llama_local_config(cfg, n)
    out = {}
    for name, w in flat.items():
        stem = name[:-len(".weight")] if name.endswith(".weight") else name
        split = (attn if "self_attn" in stem else mlp)
        if stem.endswith(_LLAMA_COLUMN) and split:
            out[name] = _cols(w, n, i)
        elif stem.endswith(_LLAMA_ROW) and split:
            out[name] = ShardedWeight(_rows(w, n, i), group, "sum")
        elif name == "lm_head.weight" and cfg.vocab_size % n == 0:
            out[name] = ShardedWeight(_cols(w, n, i), group, "gather")
        else:
            out[name] = w
    return out, local_cfg
