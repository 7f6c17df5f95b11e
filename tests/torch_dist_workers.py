"""Rank-side bodies of the port's multi-process tests (run by
`torch_dist.DistPool`). Every function takes (rank, world, *args) with
numpy / plain arguments and returns numpy / plain values. Imports torch and
the port, never JAX."""

from __future__ import annotations

import numpy as np
import torch

from spn4cir_tpu_torch.ops.bank_kernels import QuantBank
from spn4cir_tpu_torch.parallel import mesh as pm

_MESHES = {}


def mesh_of(data: int, bank: int = 1, model: int = 1) -> pm.Mesh:
    """One Mesh per shape for the life of the pool (groups are made once)."""
    key = (data, bank, model)
    if key not in _MESHES:
        _MESHES[key] = pm.Mesh(data, bank, model)
    return _MESHES[key]


def _bank(arrays):
    """A numpy bank (one array, or (values, scales) of an int8 bank)."""
    if isinstance(arrays, tuple):
        return QuantBank(torch.from_numpy(arrays[0]),
                         torch.from_numpy(arrays[1]))
    t = torch.from_numpy(arrays)
    return t


def mesh_layout(rank, world, data, bank, model):
    mesh = mesh_of(data, bank, model)
    import torch.distributed as dist

    return {"coords": dict(mesh.coords),
            "groups": {a: dist.get_process_group_ranks(mesh.group(a))
                       for a in pm.AXES}}


def sharded_loss(rank, world, data, bank, max_query, q, bank_arrays, labels,
                 tau, m_actual, bf16=False):
    """The sharded loss, dQ and dtau of this rank's rows."""
    from spn4cir_tpu_torch.parallel.loss import (sharded_bank_infonce,
                                                 sharded_max_query_infonce)

    mesh = mesh_of(data, bank)
    full = _bank(bank_arrays)
    if bf16:
        full = full.to(torch.bfloat16)
    shard, _ = pm.bank_shard(full, mesh, device="cpu")
    query = pm.local_rows(torch.from_numpy(q), mesh).clone().requires_grad_()
    lab = pm.local_rows(torch.from_numpy(labels), mesh)
    tau_t = torch.tensor(tau, dtype=torch.float32, requires_grad=True)
    fn = sharded_max_query_infonce if max_query else sharded_bank_infonce
    loss = fn(query, shard, lab, tau_t, mesh, m_actual=m_actual)
    loss.backward()
    return {"loss": float(loss), "dq": query.grad.numpy(),
            "dtau": float(tau_t.grad), "data": mesh.index(pm.AXIS_DATA),
            "bank": mesh.index(pm.AXIS_BANK)}


# --------------------------------------------------------------------------
# training steps
# --------------------------------------------------------------------------

def build(kind: str, state_dict=None, dropout: float = 0.0, tau=0.05):
    """A test-tiny backbone of `kind` on the CPU, loaded from a numpy state
    dict of its `.model` (converted from the JAX parameters)."""
    from spn4cir_tpu_torch.models.api import build_backbone

    if kind in ("clip", "zs"):
        from torch_fixtures import synthetic_tokenizer

        bb = build_backbone(kind, clip_model_name="test-tiny", tau=tau,
                            tokenizer=synthetic_tokenizer())
    elif kind == "blip":
        bb = build_backbone("blip", blip_size="test-tiny", dropout=dropout)
    else:
        bb = build_backbone("blip2", blip2_size="test-tiny", dropout=dropout)
    if state_dict is not None:
        bb.model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                                  for k, v in state_dict.items()})
    return bb


def _weights(bb, mesh):
    from spn4cir_tpu_torch.parallel.tp import full_state_dict

    sd = (full_state_dict(bb.model, mesh) if mesh.size(pm.AXIS_MODEL) > 1
          else bb.model.state_dict())
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def stage2_steps(rank, world, shape, kind, state_dict, bank_arrays, batches,
                 lr, m_actual, dropout=0.0, seed=None):
    """`make_sharded_stage2_step` for len(batches) steps; returns the losses
    and (rank 0) the weights after them."""
    from spn4cir_tpu_torch.parallel.tp import shard_module_tp
    from spn4cir_tpu_torch.parallel.train import make_sharded_stage2_step
    from spn4cir_tpu_torch.train.stage2 import create_train_state

    mesh = mesh_of(*shape)
    bb = build(kind, state_dict, dropout)
    shard_module_tp(bb, mesh)
    state = create_train_state(bb, lr)
    shard, _ = pm.bank_shard(_bank(bank_arrays), mesh, device="cpu")
    step = make_sharded_stage2_step(bb, mesh, m_actual=m_actual)
    gen = None
    if dropout:
        bb.train()
        gen = torch.Generator().manual_seed(seed)
    losses = [float(step(state, shard, pm.local_rows(_tensors(b), mesh), gen))
              for b in batches]
    weights = _weights(bb, mesh)
    return {"losses": losses, "weights": weights if rank == 0 else None,
            "tau": float(bb.loss_tau()) if kind != "clip" else None}


def stage1_steps(rank, world, shape, kind, state_dict, batches, lr,
                 neg_type=0, dropout=0.0, seed=None):
    """`make_sharded_stage1_step` for len(batches) steps."""
    from spn4cir_tpu_torch.parallel.tp import shard_module_tp
    from spn4cir_tpu_torch.parallel.train import make_sharded_stage1_step
    from spn4cir_tpu_torch.train.stage1 import create_stage1_state

    mesh = mesh_of(*shape)
    bb = build(kind, state_dict, dropout)
    shard_module_tp(bb, mesh)
    state = create_stage1_state(bb, lr)
    step = make_sharded_stage1_step(bb, mesh, with_dropout=bool(dropout),
                                    neg_type=neg_type)
    gen = None
    if dropout:
        bb.train()
        gen = torch.Generator().manual_seed(seed)
    losses = [float(step(state, pm.local_rows(_tensors(b), mesh), gen))
              for b in batches]
    weights = _weights(bb, mesh)
    return {"losses": losses, "weights": weights if rank == 0 else None}


# --------------------------------------------------------------------------
# tensor parallelism
# --------------------------------------------------------------------------

def tower(kind: str):
    """A small tower of `kind`: eva and med, whose heads and FFN divide 2;
    med3, whose 3 heads do not (its FFN of 64 does)."""
    if kind == "eva":
        from spn4cir_tpu_torch.models.eva_vit import EvaViT, EvaViTConfig

        return EvaViT(EvaViTConfig.tiny())
    from spn4cir_tpu_torch.models.med import MedBert, MedConfig

    import dataclasses

    if kind == "med3":
        return MedBert(dataclasses.replace(MedConfig.tiny(), hidden_size=48,
                                           num_heads=3))
    return MedBert(MedConfig.tiny())


def tp_encode(rank, world, kind, state_dict, inputs):
    """The encode of `kind` with the towers cut over a (1, 1, world) mesh:
    clip (gallery and text features), eva (tokens), med (hidden states
    over encoder states). Returns numpy outputs (every rank)."""
    from spn4cir_tpu_torch.parallel.tp import (full_state_dict,
                                               shard_module_tp,
                                               tp_sharded_names)

    mesh = mesh_of(1, 1, world)
    if kind == "clip":
        module = build("clip", state_dict)
    else:
        module = tower(kind)
        module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in state_dict.items()})
    shard_module_tp(module, mesh)
    with torch.no_grad():
        if kind == "clip":
            out = {"image": module.gallery_features(
                       torch.from_numpy(inputs["images"])),
                   "text": module.encode_text(
                       torch.from_numpy(inputs["text_ids"]))}
        elif kind == "eva":
            out = {"tokens": module(torch.from_numpy(inputs["images"]))}
        else:
            out = {"hidden": module(
                torch.from_numpy(inputs["ids"]),
                encoder_hidden_states=torch.from_numpy(inputs["enc"]))}
    sizes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    full = full_state_dict(module.model if kind == "clip" else module, mesh)
    gap = max((full[k] - torch.from_numpy(np.asarray(v))).abs().max().item()
              for k, v in state_dict.items())
    return {"out": {k: v.float().numpy() for k, v in out.items()},
            "sliced": sorted(tp_sharded_names(module)), "sizes": sizes,
            "full_state_gap": gap}


def tp_index(rank, world, shape, state_dict, root):
    """`extract_index_features(mesh=shape)` of the test-tiny CLIP over the
    CIRR val gallery at `root`. Returns the index, how the MLPs' layers
    ran during the pass (`tp` kinds), whether the backbone is whole again
    after it (the same parameters, no `tp`, no hooks), and (rank 0 alone,
    with no collective to join) its gallery features after it."""
    from spn4cir_tpu_torch.data.datasets import CIRDataset
    from spn4cir_tpu_torch.data.transforms import ImageTransform
    from spn4cir_tpu_torch.eval.retrieval import extract_index_features

    mesh = mesh_of(*shape)
    bb = build("clip", state_dict).eval()
    before = {n: p.detach().clone() for n, p in bb.named_parameters()}
    ran = set()

    def record(mlp, args):
        ran.update(type(getattr(layer, "tp", None)).__name__
                   for layer in (mlp.c_fc, mlp.c_proj))

    hooks = [m.register_forward_pre_hook(record) for m in bb.modules()
             if hasattr(m, "c_fc")]
    ds = CIRDataset("cirr", "val", "classic",
                    ImageTransform("targetpad", bb.input_dim, 1.25), root)
    index = extract_index_features(bb, ds, 4, num_workers=0, mesh=mesh)
    for h in hooks:
        h.remove()
    after = dict(bb.named_parameters())
    whole = (sorted(before) == sorted(after)
             and all(torch.equal(before[n], after[n]) for n in before)
             and not any(hasattr(m, "tp") or m._forward_pre_hooks
                         for m in bb.modules())
             and getattr(bb, "_tp_mesh", None) is None)
    alone = None
    if rank == 0:
        with torch.no_grad():
            alone = bb.gallery_features(torch.from_numpy(
                np.random.RandomState(0).randn(
                    2, bb.input_dim, bb.input_dim, 3).astype(np.float32))
            ).numpy()
    return {"target": index.target.numpy(), "refer": index.refer,
            "ran": sorted(ran), "whole": whole, "alone": alone}


def _shape(w):
    from spn4cir_tpu_torch.models.llama import QuantKernel, ShardedWeight

    if isinstance(w, ShardedWeight):
        return ("combined",) + _shape(w.weight)
    if isinstance(w, QuantKernel):
        return tuple(w.values.shape)
    return tuple(w.shape)


def tp_generate(rank, world, cfg_kw, state_dict, embeds, quant, max_new,
                mask=None):
    """Greedy LLaMA tokens with the LM cut over (1, 1, world)."""
    from spn4cir_tpu_torch.models.llama import (LlamaConfig,
                                                LlamaForCausalLM,
                                                llama_generate,
                                                quantize_llama_weights)
    from spn4cir_tpu_torch.parallel.tp import shard_llama_params

    mesh = mesh_of(1, 1, world)
    cfg = LlamaConfig.tiny(**cfg_kw)
    model = LlamaForCausalLM(cfg)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    params = quantize_llama_weights(model) if quant else model
    local, lcfg = shard_llama_params(params, cfg, mesh)
    out = llama_generate(local, lcfg, torch.from_numpy(embeds), eos_id=1,
                         pad_id=1, max_new_tokens=max_new,
                         attention_mask=(None if mask is None
                                         else torch.from_numpy(mask)))
    shapes = {k: _shape(v) for k, v in local.items() if "layers.0." in k
              or k == "lm_head.weight"}
    return {"tokens": out.numpy(), "cfg": (lcfg.num_heads, lcfg.kv_heads,
                                           lcfg.intermediate_size,
                                           lcfg.head_dim),
            "shapes": shapes}


def tp_rewrite(rank, world, pairs, batch_size):
    """The tiny rewriter (random weights from seed 0) with its LM over
    (1, 1, world)."""
    from spn4cir_tpu_torch.datagen.llm_rewrite import load_torch_rewriter

    mesh = mesh_of(1, 1, world) if world > 1 else None
    rw = load_torch_rewriter(tiny=True, data="cirr", batch_size=batch_size,
                             device="cpu", mesh=mesh)
    return [rw(a, b) for a, b in pairs]


def tp_caption(rank, world, images):
    """The tiny LLaVA captioner (random weights from seed 0) over
    (1, 1, world)."""
    from spn4cir_tpu_torch.datagen.captioner import make_llava_captioner

    mesh = mesh_of(1, 1, world) if world > 1 else None
    _, _, batched_fn = make_llava_captioner(None, llava_size="tiny",
                                            device="cpu", mesh=mesh,
                                            max_new_tokens=12)
    return batched_fn(list(images))
