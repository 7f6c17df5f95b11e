"""Checkpoint conversion for the PyTorch port.

`clip_state_dict_from_jax` turns the JAX package's CLIP parameters (a numpy
pytree) into the port's OpenAI-CLIP-named state dict. It inverts
`spn4cir_tpu.models.convert.convert_clip_state_dict`:
  - per-layer block weights are unstacked from the nn.scan axis
    (`.../blocks/block/...`, leading axis = layer);
  - Dense kernels (in, out) become Linear weights (out, in), the fused qkv
    kernel (d, 3d) becoming `in_proj_weight` (3d, d);
  - convolution kernels (the ViT patch embedding, every ResNet
    convolution) go from HWIO to OIHW;
  - a ResNet tower's BatchNorm running mean and variance come from the JAX
    tree's `batch_stats` collection, not from `params`.

`clip_state_dict_from_train_state` carries training state across: the
parameters of a JAX train state after some optimizer steps, under the
port's names, every leaf copied (a zero-copy view of a live buffer would
let one side's training mutate the other's tree).

`load_clip_checkpoint` reads an OpenAI / clip4cir `.pt` file; since the port
keeps OpenAI's names, the state dict loads without conversion.

`blip_state_dict_from_jax` does the same for the blip4cir backbone: it
reads `convert_blip_vit_state_dict`, `convert_med_state_dict` and
`convert_blip_retrieval` of the JAX package backwards, into the BLIP
checkpoint's names (timm's for the ViT, HF BERT's for MED).
`load_blip_checkpoint` reads a BLIP / BLIP4CIR `.pth` (or a checkpoint the
port saved), strips the `blip.` wrapper prefix and resamples the position
embedding when the resolutions differ (`interpolate_pos_embed`, bicubic).

`blip2_state_dict_from_jax` and `load_blip2_checkpoint` do the same for the
blip24cir backbone, into LAVIS's names (`visual_encoder.*` with EVA's
`q_bias` / `v_bias`, `ln_vision`, `Qformer.bert.*`, `Qformer_query.bert.*`,
the projections, `query_tokens`, `prompt_tokens`, `temp`); they invert
`convert_eva_vit_state_dict`, `convert_qformer_state_dict` and
`convert_blip2_cir` of the JAX package.

`tgcir_state_dict_from_jax` and `load_tgcir_checkpoint` do the same for
the tgcir backbone: the JAX `TGCIRModule` tree (its CLIP through
`clip_state_dict_from_jax`) into the port's names, and a reference TG-CIR
`CIRPlus` checkpoint, whose S separate token-learner Conv1d(D -> 1) slots
are stacked into the port's one Linear(D -> S), as the JAX package's
`convert_tgcir_state_dict` reads it.

`llama_state_dict_from_jax` and `load_llama_checkpoint` do the same for the
LLaMA of the datagen rewriter, into HF `LlamaForCausalLM`'s names; they
invert `convert_llama_state_dict` of the JAX package, for a dense tree and
for an int8 one.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from spn4cir_tpu_torch.models.blip_vit import BlipViTConfig
from spn4cir_tpu_torch.models.clip import CLIPConfig
from spn4cir_tpu_torch.models.eva_vit import EvaViTConfig
from spn4cir_tpu_torch.models.llama import LlamaConfig, QuantKernel
from spn4cir_tpu_torch.models.med import MedConfig
from spn4cir_tpu_torch.models.qformer import QFormerConfig

# keys of an OpenAI jit archive that describe the model rather than hold
# weights (the OpenAI loader deletes them too)
_METADATA_KEYS = ("input_resolution", "context_length", "vocab_size")


def _tensor(x) -> torch.Tensor:
    # np.array copies: the state dict must not alias the caller's buffers
    return torch.from_numpy(np.array(x, np.float32))


def transformer_state_dict(tree: Mapping, prefix: str = "resblocks"
                           ) -> Dict[str, torch.Tensor]:
    """A JAX `Transformer` params tree (scan-stacked under blocks/block) ->
    the port's `Transformer` entries `{prefix}.{i}.*`."""
    sd: Dict[str, torch.Tensor] = {}
    block = tree["blocks"]["block"]
    n = np.shape(block["ln_1"]["ln"]["scale"])[0]

    def put(name, leaf, transpose=False):
        arr = np.asarray(leaf)
        for i in range(n):
            sd[f"{prefix}.{i}.{name}"] = _tensor(arr[i].T if transpose
                                                 else arr[i])

    for ln in ("ln_1", "ln_2"):
        put(f"{ln}.weight", block[ln]["ln"]["scale"])
        put(f"{ln}.bias", block[ln]["ln"]["bias"])
    put("attn.in_proj_weight", block["attn"]["qkv"]["kernel"], True)
    put("attn.in_proj_bias", block["attn"]["qkv"]["bias"])
    put("attn.out_proj.weight", block["attn"]["out"]["kernel"], True)
    put("attn.out_proj.bias", block["attn"]["out"]["bias"])
    put("mlp.c_fc.weight", block["mlp"]["fc"]["kernel"], True)
    put("mlp.c_fc.bias", block["mlp"]["fc"]["bias"])
    put("mlp.c_proj.weight", block["mlp"]["proj"]["kernel"], True)
    put("mlp.c_proj.bias", block["mlp"]["proj"]["bias"])
    return sd


def _oihw(kernel) -> torch.Tensor:
    return _tensor(np.asarray(kernel).transpose(3, 2, 0, 1))


def modified_resnet_state_dict(vis: Mapping, stats: Mapping
                               ) -> Dict[str, torch.Tensor]:
    """A JAX `ModifiedResNet` params tree and its `batch_stats` tree -> the
    port's `visual.*` entries (the inverse of the JAX package's
    `_convert_modified_resnet`)."""
    sd: Dict[str, torch.Tensor] = {}

    def conv_bn(tree_key_conv, tree_key_bn, node, stat_node, conv_name,
                bn_name):
        sd[f"{conv_name}.weight"] = _oihw(node[tree_key_conv]["kernel"])
        sd[f"{bn_name}.weight"] = _tensor(node[tree_key_bn]["bn"]["scale"])
        sd[f"{bn_name}.bias"] = _tensor(node[tree_key_bn]["bn"]["bias"])
        sd[f"{bn_name}.running_mean"] = _tensor(
            stat_node[tree_key_bn]["bn"]["mean"])
        sd[f"{bn_name}.running_var"] = _tensor(
            stat_node[tree_key_bn]["bn"]["var"])

    for i in (1, 2, 3):
        conv_bn(f"conv{i}", f"bn{i}", vis, stats, f"visual.conv{i}",
                f"visual.bn{i}")
    for key in sorted(k for k in vis if k.startswith("layer")):
        stage, blk = key[len("layer"):].split("_")
        name = f"visual.layer{stage}.{blk}"
        for j in (1, 2, 3):
            conv_bn(f"conv{j}", f"bn{j}", vis[key], stats[key],
                    f"{name}.conv{j}", f"{name}.bn{j}")
        if "downsample_conv" in vis[key]:
            conv_bn("downsample_conv", "downsample_bn", vis[key], stats[key],
                    f"{name}.downsample.0", f"{name}.downsample.1")
    pool = vis["attnpool"]
    sd["visual.attnpool.positional_embedding"] = _tensor(
        pool["positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        sd[f"visual.attnpool.{proj}.weight"] = _tensor(
            np.asarray(pool[proj]["kernel"]).T)
        sd[f"visual.attnpool.{proj}.bias"] = _tensor(pool[proj]["bias"])
    return sd


def clip_state_dict_from_jax(params_np: Mapping[str, Any], cfg: CLIPConfig,
                             batch_stats: Optional[Mapping[str, Any]] = None
                             ) -> Dict[str, torch.Tensor]:
    """JAX CLIP params ({'params': ...} or the inner tree, numpy leaves) ->
    the port's state dict (float32 CPU tensors). A ResNet tower also needs
    its running statistics: `batch_stats`, or the 'batch_stats' entry of
    `params_np` when it is the whole variables dict."""
    p = params_np.get("params", params_np)
    sd: Dict[str, torch.Tensor] = {}
    vis, txt = p["visual"], p["text"]
    if cfg.is_vit:
        sd["visual.conv1.weight"] = _oihw(vis["patch_embed"]["kernel"])
        sd["visual.class_embedding"] = _tensor(vis["class_embedding"])
        sd["visual.positional_embedding"] = _tensor(
            vis["positional_embedding"])
        sd["visual.ln_pre.weight"] = _tensor(vis["ln_pre"]["ln"]["scale"])
        sd["visual.ln_pre.bias"] = _tensor(vis["ln_pre"]["ln"]["bias"])
        sd.update(transformer_state_dict(vis["transformer"],
                                         "visual.transformer.resblocks"))
        sd["visual.ln_post.weight"] = _tensor(vis["ln_post"]["ln"]["scale"])
        sd["visual.ln_post.bias"] = _tensor(vis["ln_post"]["ln"]["bias"])
        sd["visual.proj"] = _tensor(vis["proj"])
    else:
        if batch_stats is None:
            batch_stats = params_np.get("batch_stats")
        if batch_stats is None:
            raise ValueError("a ResNet tower needs the JAX tree's "
                             "batch_stats (the BatchNorm running statistics)")
        sd.update(modified_resnet_state_dict(vis, batch_stats["visual"]))

    sd["token_embedding.weight"] = _tensor(txt["token_embedding"])
    sd["positional_embedding"] = _tensor(txt["positional_embedding"])
    sd.update(transformer_state_dict(txt["transformer"],
                                     "transformer.resblocks"))
    sd["ln_final.weight"] = _tensor(txt["ln_final"]["ln"]["scale"])
    sd["ln_final.bias"] = _tensor(txt["ln_final"]["ln"]["bias"])
    sd["text_projection"] = _tensor(txt["text_projection"])
    sd["logit_scale"] = _tensor(p["logit_scale"])
    return sd


def clip_state_dict_from_train_state(state: Any, cfg: CLIPConfig,
                                     batch_stats: Optional[Mapping] = None
                                     ) -> Dict[str, torch.Tensor]:
    """The parameters of a JAX train state (anything with `.params`, or the
    params tree itself; device or numpy leaves) -> the port's state dict.
    Leaves are read through `np.array`, so the result owns its memory.
    `batch_stats` as in `clip_state_dict_from_jax` (training never moves a
    frozen tower's statistics, so they come from the initial variables)."""
    return clip_state_dict_from_jax(getattr(state, "params", state), cfg,
                                    batch_stats)


def load_clip_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read an OpenAI CLIP / clip4cir checkpoint into a float32 state dict.

    Accepts a jit archive, a raw state dict, or the {'CLIP': sd} /
    {'state_dict': sd} wrappers, with or without a 'clip.' key prefix."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except RuntimeError:  # OpenAI's releases are TorchScript archives
        obj = torch.jit.load(path, map_location="cpu")
    if hasattr(obj, "state_dict"):
        sd = obj.state_dict()
    elif isinstance(obj, dict) and "state_dict" in obj:
        sd = obj["state_dict"]
    elif isinstance(obj, dict) and "CLIP" in obj:
        sd = obj["CLIP"]
    else:
        sd = obj
    return {(k[len("clip."):] if k.startswith("clip.") else k):
            v.detach().to(torch.float32)
            for k, v in sd.items() if k not in _METADATA_KEYS}


# ---------------------------------------------------------------------------
# blip4cir
# ---------------------------------------------------------------------------

def _unstack(sd: Dict[str, torch.Tensor], prefix: str, name: str, leaf,
             transpose: bool = False) -> None:
    """A scan-stacked leaf (leading axis = layer) -> `{prefix}.{i}.{name}`."""
    arr = np.asarray(leaf)
    for i in range(arr.shape[0]):
        sd[f"{prefix}.{i}.{name}"] = _tensor(arr[i].T if transpose else arr[i])


def blip_vit_state_dict(tree: Mapping, prefix: str = "visual_encoder"
                        ) -> Dict[str, torch.Tensor]:
    """A JAX `BlipViT` params tree -> the port's timm-named entries (bare
    names with an empty `prefix`)."""
    pre = f"{prefix}." if prefix else ""
    sd: Dict[str, torch.Tensor] = {
        f"{pre}cls_token": _tensor(tree["cls_token"]),
        f"{pre}pos_embed": _tensor(np.asarray(tree["pos_embed"])[None]),
        f"{pre}patch_embed.proj.weight": _oihw(
            tree["patch_embed"]["kernel"]),
        f"{pre}patch_embed.proj.bias": _tensor(
            tree["patch_embed"]["bias"]),
        f"{pre}norm.weight": _tensor(tree["norm"]["ln"]["scale"]),
        f"{pre}norm.bias": _tensor(tree["norm"]["ln"]["bias"]),
    }
    block = tree["blocks"]["blocks"]["block"]
    blocks = f"{pre}blocks"
    for ours, theirs in (("norm1", "ln_1"), ("norm2", "ln_2")):
        _unstack(sd, blocks, f"{ours}.weight", block[theirs]["ln"]["scale"])
        _unstack(sd, blocks, f"{ours}.bias", block[theirs]["ln"]["bias"])
    for ours, node in (("attn.qkv", block["attn"]["qkv"]),
                       ("attn.proj", block["attn"]["out"]),
                       ("mlp.fc1", block["mlp"]["fc"]),
                       ("mlp.fc2", block["mlp"]["proj"])):
        _unstack(sd, blocks, f"{ours}.weight", node["kernel"], True)
        _unstack(sd, blocks, f"{ours}.bias", node["bias"])
    return sd


def med_state_dict(tree: Mapping, prefix: str = "text_encoder"
                   ) -> Dict[str, torch.Tensor]:
    """A JAX `MedBert` params tree -> the port's HF-named entries. Layers
    whose cross-attention was never traced (a text-only tree) have no
    `cross_attn` entry; those keys are then left out."""
    pre = f"{prefix}." if prefix else ""
    emb = f"{pre}embeddings"
    sd: Dict[str, torch.Tensor] = {
        f"{emb}.word_embeddings.weight": _tensor(tree["word_embeddings"]),
        f"{emb}.position_embeddings.weight": _tensor(
            tree["position_embeddings"]),
        f"{emb}.LayerNorm.weight": _tensor(tree["embeddings_ln"]["scale"]),
        f"{emb}.LayerNorm.bias": _tensor(tree["embeddings_ln"]["bias"]),
    }
    if "token_type_embeddings" in tree:
        sd[f"{emb}.token_type_embeddings.weight"] = _tensor(
            tree["token_type_embeddings"])
    layer = tree["layers"]["layer"]
    layers = f"{pre}encoder.layer"

    def dense(name, node):
        _unstack(sd, layers, f"{name}.weight", node["kernel"], True)
        _unstack(sd, layers, f"{name}.bias", node["bias"])

    def norm(name, node):
        _unstack(sd, layers, f"{name}.weight", node["scale"])
        _unstack(sd, layers, f"{name}.bias", node["bias"])

    for ours, theirs in (("attention", "self_attn"),
                         ("crossattention", "cross_attn")):
        if theirs not in layer:
            continue
        for proj in ("query", "key", "value"):
            dense(f"{ours}.self.{proj}", layer[theirs][proj])
        dense(f"{ours}.output.dense", layer[theirs]["output"])
        norm(f"{ours}.output.LayerNorm", layer[theirs]["ln"])
    dense("intermediate.dense", layer["intermediate"])
    dense("output.dense", layer["output"])
    norm("output.LayerNorm", layer["ln"])
    return sd


def blip_state_dict_from_jax(params_np: Mapping[str, Any],
                             vit_cfg: Optional[BlipViTConfig] = None,
                             med_cfg: Optional[MedConfig] = None
                             ) -> Dict[str, torch.Tensor]:
    """JAX `BlipCirModule` params ({'params': ...}, the inner tree, or
    anything with `.params`; numpy or device leaves) -> the state dict of the
    port's `BlipCirModule` (float32 CPU tensors that own their memory). The
    configs, when given, check the layer counts."""
    p = getattr(params_np, "params", params_np)
    p = p.get("params", p)
    sd = blip_vit_state_dict(p["visual_encoder"])
    sd.update(med_state_dict(p["text_encoder"]))
    for proj in ("vision_proj", "text_proj"):
        sd[f"{proj}.weight"] = _tensor(np.asarray(p[proj]["kernel"]).T)
        sd[f"{proj}.bias"] = _tensor(p[proj]["bias"])
    sd["tau"] = _tensor(p["tau"])
    for cfg_layers, key in (
            (vit_cfg and vit_cfg.layers, "visual_encoder.blocks.{}.norm1.weight"),
            (med_cfg and med_cfg.num_layers,
             "text_encoder.encoder.layer.{}.output.dense.weight")):
        if cfg_layers and (key.format(cfg_layers - 1) not in sd
                           or key.format(cfg_layers) in sd):
            raise ValueError(f"the tree's depth is not the config's "
                             f"{cfg_layers} layers ({key})")
    return sd


def interpolate_pos_embed(pos: torch.Tensor, target_num_tokens: int,
                          num_prefix: int = 1) -> torch.Tensor:
    """Bicubic resampling of a (1, T, D) position embedding's grid to
    `target_num_tokens` (prefix tokens unchanged, align_corners=False), as
    BLIP does when a checkpoint's resolution differs from the model's."""
    if pos.shape[1] == target_num_tokens:
        return pos
    dim = pos.shape[-1]
    orig = int(round((pos.shape[1] - num_prefix) ** 0.5))
    new = int(round((target_num_tokens - num_prefix) ** 0.5))
    if orig * orig != pos.shape[1] - num_prefix or \
            new * new != target_num_tokens - num_prefix:
        raise ValueError(f"position grids are not square: {pos.shape[1]} -> "
                         f"{target_num_tokens} tokens")
    grid = pos[:, num_prefix:].reshape(1, orig, orig, dim).permute(0, 3, 1, 2)
    grid = torch.nn.functional.interpolate(
        grid.float(), size=(new, new), mode="bicubic", align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, new * new, dim)
    return torch.cat([pos[:, :num_prefix].float(), grid], dim=1)

def _unwrap_checkpoint(path: str) -> Dict[str, Any]:
    """torch.load, then the {'state_dict': sd} / {'model': sd} wrappers."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            return obj[key]
    return obj


def load_blip_checkpoint(path: str, num_tokens: Optional[int] = None
                         ) -> Dict[str, torch.Tensor]:
    """Read a BLIP_Retrieval / BLIP4CIR checkpoint (or one the port saved)
    into a float32 state dict for `BlipCirModule`: takes the {'model': sd} /
    {'state_dict': sd} wrappers, strips the CIRPlus `blip.` prefix, drops
    HF's `position_ids` buffers and BLIP's momentum / queue entries, and
    resamples `visual_encoder.pos_embed` to `num_tokens`."""
    obj = _unwrap_checkpoint(path)
    if any(k.startswith("blip.") for k in obj):
        obj = {k[len("blip."):]: v for k, v in obj.items()
               if k.startswith("blip.")}
    keep = ("visual_encoder.", "text_encoder.", "vision_proj.", "text_proj.")
    sd = {k: v.detach().to(torch.float32) for k, v in obj.items()
          if (k.startswith(keep) or k == "tau") and "position_ids" not in k}
    if num_tokens is not None and "visual_encoder.pos_embed" in sd:
        sd["visual_encoder.pos_embed"] = interpolate_pos_embed(
            sd["visual_encoder.pos_embed"], num_tokens)
    return sd


# ---------------------------------------------------------------------------
# blip24cir
# ---------------------------------------------------------------------------

def eva_vit_state_dict(tree: Mapping, prefix: str = "visual_encoder"
                       ) -> Dict[str, torch.Tensor]:
    """A JAX `EvaViT` params tree -> the port's LAVIS-named entries (bare
    names with an empty `prefix`). The fused qkv bias splits into `q_bias`
    and `v_bias`; its key third must be zero (EVA has no key bias)."""
    pre = f"{prefix}." if prefix else ""
    sd: Dict[str, torch.Tensor] = {
        f"{pre}cls_token": _tensor(tree["cls_token"]),
        f"{pre}pos_embed": _tensor(np.asarray(tree["pos_embed"])[None]),
        f"{pre}patch_embed.proj.weight": _oihw(tree["patch_embed"]["kernel"]),
        f"{pre}patch_embed.proj.bias": _tensor(tree["patch_embed"]["bias"]),
    }
    block = tree["blocks"]["blocks"]["block"]
    blocks = f"{pre}blocks"
    for ours, theirs in (("norm1", "ln_1"), ("norm2", "ln_2")):
        _unstack(sd, blocks, f"{ours}.weight", block[theirs]["ln"]["scale"])
        _unstack(sd, blocks, f"{ours}.bias", block[theirs]["ln"]["bias"])
    _unstack(sd, blocks, "attn.qkv.weight", block["attn"]["qkv"]["kernel"],
             True)
    bias = np.asarray(block["attn"]["qkv"]["bias"])
    width = bias.shape[-1] // 3
    if np.any(bias[:, width:2 * width]):
        raise ValueError("EVA has no key bias: the key third of the fused qkv "
                         "bias must be zero")
    _unstack(sd, blocks, "attn.q_bias", bias[:, :width])
    _unstack(sd, blocks, "attn.v_bias", bias[:, 2 * width:])
    for ours, node in (("attn.proj", block["attn"]["out"]),
                       ("mlp.fc1", block["mlp"]["fc"]),
                       ("mlp.fc2", block["mlp"]["proj"])):
        _unstack(sd, blocks, f"{ours}.weight", node["kernel"], True)
        _unstack(sd, blocks, f"{ours}.bias", node["bias"])
    return sd


def _put_pairs(sd: Dict[str, torch.Tensor], layers: str, layer: int,
               stride: int, name: str, leaf, transpose: bool = False) -> None:
    """A pair-scan-stacked leaf (leading axis = pair k) -> layer
    `layer + stride·k`."""
    arr = np.asarray(leaf)
    for k in range(arr.shape[0]):
        sd[f"{layers}.{layer + stride * k}.{name}"] = _tensor(
            arr[k].T if transpose else arr[k])


def qformer_state_dict(tree: Mapping, prefix: str = "Qformer.bert"
                       ) -> Dict[str, torch.Tensor]:
    """A JAX `QFormer` params tree (pairs of a cross layer and a plain
    layer, scan-stacked) -> the port's LAVIS-named entries: even layers from
    `pairs/cross_layer`, odd ones from `pairs/plain_layer`. A tree without
    `cross_attn` (the JAX package's trainable copy) gives no
    `crossattention` entries."""
    emb = f"{prefix}.embeddings"
    sd: Dict[str, torch.Tensor] = {
        f"{emb}.word_embeddings.weight": _tensor(tree["word_embeddings"]),
        f"{emb}.position_embeddings.weight": _tensor(
            tree["position_embeddings"]),
        f"{emb}.LayerNorm.weight": _tensor(tree["embeddings_ln"]["scale"]),
        f"{emb}.LayerNorm.bias": _tensor(tree["embeddings_ln"]["bias"]),
    }
    layers = f"{prefix}.encoder.layer"
    for first, member in ((0, "cross_layer"), (1, "plain_layer")):
        node = tree["pairs"][member]

        def dense(name, leaf):
            _put_pairs(sd, layers, first, 2, f"{name}.weight", leaf["kernel"],
                       True)
            _put_pairs(sd, layers, first, 2, f"{name}.bias", leaf["bias"])

        def norm(name, leaf):
            _put_pairs(sd, layers, first, 2, f"{name}.weight", leaf["scale"])
            _put_pairs(sd, layers, first, 2, f"{name}.bias", leaf["bias"])

        for ours, theirs in (("attention", "self_attn"),
                             ("crossattention", "cross_attn")):
            if theirs not in node:
                continue
            for proj in ("query", "key", "value"):
                dense(f"{ours}.self.{proj}", node[theirs][proj])
            dense(f"{ours}.output.dense", node[theirs]["output"])
            norm(f"{ours}.output.LayerNorm", node[theirs]["ln"])
        ffn = node["ffn"]
        for suffix in ("", "_query"):
            dense(f"intermediate{suffix}.dense", ffn[f"intermediate{suffix}"])
            dense(f"output{suffix}.dense", ffn[f"output{suffix}"])
            norm(f"output{suffix}.LayerNorm", ffn[f"ln{suffix}"])
    return sd


def blip2_state_dict_from_jax(params_np: Mapping[str, Any],
                              vit_cfg: Optional[EvaViTConfig] = None,
                              q_cfg: Optional[QFormerConfig] = None
                              ) -> Dict[str, torch.Tensor]:
    """JAX `Blip2CirModule` params ({'params': ...}, the inner tree, or
    anything with `.params`; numpy or device leaves) -> the state dict of the
    port's `Blip2CirModule` (float32 CPU tensors that own their memory). The
    JAX tree's trainable copy has no cross-attention (it never
    cross-attends); the port keeps LAVIS's, copied from `Qformer` as
    `init_stage2`'s deep copy has it. The configs, when given, check the
    layer counts."""
    p = getattr(params_np, "params", params_np)
    p = p.get("params", p)
    sd = eva_vit_state_dict(p["visual_encoder"])
    sd["ln_vision.weight"] = _tensor(p["ln_vision"]["ln"]["scale"])
    sd["ln_vision.bias"] = _tensor(p["ln_vision"]["ln"]["bias"])
    sd.update(qformer_state_dict(p["qformer"], "Qformer.bert"))
    copy = qformer_state_dict(p["qformer_query"], "Qformer_query.bert")
    for k, v in sd.items():
        if k.startswith("Qformer.bert.") and ".crossattention." in k:
            copy.setdefault("Qformer_query." + k[len("Qformer."):], v.clone())
    sd.update(copy)
    for proj in ("vision_proj", "text_proj", "text_proj_q"):
        sd[f"{proj}.weight"] = _tensor(np.asarray(p[proj]["kernel"]).T)
        sd[f"{proj}.bias"] = _tensor(p[proj]["bias"])
    for name in ("query_tokens", "prompt_tokens"):
        sd[name] = _tensor(p[name])
    sd["temp"] = _tensor(p["tau"])
    for cfg_layers, key in (
            (vit_cfg and vit_cfg.layers, "visual_encoder.blocks.{}.norm1.weight"),
            (q_cfg and q_cfg.num_layers,
             "Qformer.bert.encoder.layer.{}.output.dense.weight")):
        if cfg_layers and (key.format(cfg_layers - 1) not in sd
                           or key.format(cfg_layers) in sd):
            raise ValueError(f"the tree's depth is not the config's "
                             f"{cfg_layers} layers ({key})")
    return sd


_BLIP2_KEEP = ("visual_encoder.", "ln_vision.", "Qformer.", "Qformer_query.",
               "vision_proj.", "text_proj.", "text_proj_q.")
_BLIP2_TENSORS = ("query_tokens", "prompt_tokens", "temp")


def load_blip2_checkpoint(path: str, num_tokens: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
    """Read a LAVIS `Blip2QformerCirAlignPrompt` / SPRC checkpoint (or one
    the port saved) into a float32 state dict for `Blip2CirModule`: takes
    the {'model': sd} / {'state_dict': sd} wrappers, strips the
    `blip_model.` prefix, drops the Q-Formers' `cls` heads and HF's
    `position_ids`, fills `Qformer_query.*` / `text_proj_q.*` from
    `Qformer.*` / `text_proj.*` when they are absent (the `init_stage2`
    surgery of a stage-1 checkpoint), gives `prompt_tokens` zeros when
    absent, and resamples `visual_encoder.pos_embed` to `num_tokens`. A
    missing `temp` is left to the caller (the CLIs take --tau)."""
    obj = _unwrap_checkpoint(path)
    if any(k.startswith("blip_model.") for k in obj):
        obj = {k[len("blip_model."):]: v for k, v in obj.items()
               if k.startswith("blip_model.")}
    sd = {k: v.detach().to(torch.float32) for k, v in obj.items()
          if (k.startswith(_BLIP2_KEEP) or k in _BLIP2_TENSORS)
          and "position_ids" not in k
          and not k.startswith(("Qformer.cls.", "Qformer_query.cls."))}
    if not any(k.startswith("Qformer_query.") for k in sd):
        for k in [k for k in sd if k.startswith("Qformer.")]:
            sd["Qformer_query." + k[len("Qformer."):]] = sd[k].clone()
    if "text_proj_q.weight" not in sd:
        for leaf in ("weight", "bias"):
            sd[f"text_proj_q.{leaf}"] = sd[f"text_proj.{leaf}"].clone()
    if "prompt_tokens" not in sd:
        sd["prompt_tokens"] = torch.zeros_like(sd["query_tokens"])
    if num_tokens is not None and "visual_encoder.pos_embed" in sd:
        sd["visual_encoder.pos_embed"] = interpolate_pos_embed(
            sd["visual_encoder.pos_embed"], num_tokens)
    return sd


# ---------------------------------------------------------------------------
# tgcir
# ---------------------------------------------------------------------------

def _linear_from_jax(sd: Dict[str, torch.Tensor], name: str, node: Mapping
                     ) -> None:
    sd[f"{name}.weight"] = _tensor(np.asarray(node["kernel"]).T)
    sd[f"{name}.bias"] = _tensor(node["bias"])


def tgcir_state_dict_from_jax(params_np: Mapping[str, Any], cfg: CLIPConfig
                              ) -> Dict[str, torch.Tensor]:
    """JAX `TGCIRModule` params ({'params': ...} or the inner tree, numpy
    leaves) -> the port's `TGCIRModule` state dict. Dense kernels (in, out)
    become Linear weights (out, in)."""
    p = params_np.get("params", params_np)
    sd = {f"clip.{k}": v
          for k, v in clip_state_dict_from_jax(p["clip"], cfg).items()}
    for name in ("fc", "text_fc"):
        _linear_from_jax(sd, name, p[name])
    for name in ("tokenlearn", "tokenlearn_text"):
        _linear_from_jax(sd, f"{name}.attn", p[name]["attn"])
    for name in ("masks", "masks_text"):
        sd[f"{name}.weight"] = _tensor(p[name]["masks"])
    for fc in ("fc1", "fc2"):
        _linear_from_jax(sd, f"s_remain.{fc}", p["s_remain"][fc])
    return sd


def load_tgcir_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference TG-CIR `CIRPlus` checkpoint (or one the port saved)
    into a float32 state dict for `TGCIRModule`: takes the {'state_dict':
    sd} wrapper and a `state_dict.` key prefix; `backbone.clip.*`,
    `backbone.fc`, `backbone.text_fc`, `backbone.masks.weight` and
    `backbone.masks_text.weight` keep their names less `backbone.`;
    `s_remain_map.{0,2}` becomes `s_remain.fc{1,2}`; the S token-learner
    slots `backbone.tokenlearn*.tokenizers.{i}.conv.0.{weight,bias}` are
    stacked into `tokenlearn*.attn`. The reference's aliased
    `backbone.image_backbone.*` and its unused `t_remain_map`,
    `t_replace_map` and `local_weight` are dropped."""
    obj = _unwrap_checkpoint(path)
    if any(k.startswith("state_dict.") for k in obj):
        obj = {k[len("state_dict."):]: v for k, v in obj.items()
               if k.startswith("state_dict.")}
    obj = {k: v.detach().to(torch.float32) for k, v in obj.items()
           if isinstance(v, torch.Tensor)}
    if not any(k.startswith("backbone.") for k in obj):
        return obj                                  # the port's own names
    bb = "backbone."
    sd = {k[len(bb):]: v for k, v in obj.items()
          if k.startswith(bb + "clip.")
          and k[len(bb + "clip."):] not in _METADATA_KEYS}
    for name in ("fc.weight", "fc.bias", "text_fc.weight", "text_fc.bias",
                 "masks.weight", "masks_text.weight"):
        sd[name] = obj[bb + name]
    for fc, idx in (("fc1", 0), ("fc2", 2)):
        for leaf in ("weight", "bias"):
            sd[f"s_remain.{fc}.{leaf}"] = obj[f"s_remain_map.{idx}.{leaf}"]
    for name in ("tokenlearn", "tokenlearn_text"):
        slots = sorted({int(k.split(".")[3]) for k in obj
                        if k.startswith(f"{bb}{name}.tokenizers.")})
        conv = [f"{bb}{name}.tokenizers.{i}.conv.0" for i in slots]
        sd[f"{name}.attn.weight"] = torch.stack(
            [obj[c + ".weight"].reshape(-1) for c in conv])
        sd[f"{name}.attn.bias"] = torch.stack(
            [obj[c + ".bias"].reshape(()) for c in conv])
    return sd


# ---------------------------------------------------------------------------
# LLaMA (the datagen rewriter's LM)
# ---------------------------------------------------------------------------

def _is_quant(leaf) -> bool:
    """A QuantKernel of either package: a named (values, scales) pair."""
    return isinstance(leaf, tuple) and getattr(leaf, "_fields", ()) == (
        "values", "scales")


def llama_state_dict_from_jax(params_np: Mapping[str, Any],
                              cfg: LlamaConfig) -> Dict[str, Any]:
    """JAX `LlamaLM` params ({'params': ...} or the inner tree; numpy or
    device leaves) -> the port's weights under HF `LlamaForCausalLM` names.
    Inverts `spn4cir_tpu.models.convert.convert_llama_state_dict`: the
    scan-stacked layers are unstacked and each (in, out) kernel becomes an
    (out, in) Linear weight. A dense tree gives a float32 state dict for
    `load_state_dict`; an int8 tree (`quantize_llama_weights` of the JAX
    package, QuantKernel leaves) gives the dict that the port's
    `quantize_llama_weights` returns, its int8 values kept in the (in, out)
    layout that kernel #12 reads."""
    p = params_np.get("params", params_np)
    layer = p["layers"]["layer"]
    sd: Dict[str, Any] = {}

    def put(name, leaf, transpose):
        if _is_quant(leaf):
            vals, scales = np.asarray(leaf.values), np.asarray(leaf.scales)
            for i in range(cfg.num_layers):
                sd[name.format(i)] = QuantKernel(
                    torch.from_numpy(np.array(vals[i], np.int8)),
                    _tensor(scales[i]))
            return
        arr = np.asarray(leaf)
        for i in range(cfg.num_layers):
            sd[name.format(i)] = _tensor(arr[i].T if transpose else arr[i])

    pre = "model.layers.{}."
    put(pre + "input_layernorm.weight", layer["input_ln"]["scale"], False)
    put(pre + "post_attention_layernorm.weight", layer["post_ln"]["scale"],
        False)
    for proj in ("q", "k", "v", "o"):
        put(pre + f"self_attn.{proj}_proj.weight",
            layer["attn"][proj]["kernel"], True)
    for proj in ("gate", "up", "down"):
        put(pre + f"mlp.{proj}_proj.weight", layer[proj]["kernel"], True)
    for name, leaf, transpose in (
            ("model.embed_tokens.weight", p["embed_tokens"], False),
            ("lm_head.weight", p["lm_head"], True)):
        if _is_quant(leaf):
            sd[name] = QuantKernel(
                torch.from_numpy(np.array(leaf.values, np.int8)),
                _tensor(leaf.scales))
        else:
            sd[name] = _tensor(np.asarray(leaf).T if transpose else leaf)
    sd["model.norm.weight"] = _tensor(p["norm"]["scale"])
    return sd


def load_llama_checkpoint(path: str, cfg: LlamaConfig
                          ) -> Dict[str, torch.Tensor]:
    """Read an HF `LlamaForCausalLM` state dict (a torch file, possibly
    under {'state_dict': ...} / {'model': ...}) for the port's
    `LlamaForCausalLM`, in its own types; HF's `rotary_emb.inv_freq`
    buffers are dropped (the port computes the tables). The layer count must
    be the config's."""
    obj = _unwrap_checkpoint(path)
    sd = {k: v.detach() for k, v in obj.items()
          if not k.endswith("rotary_emb.inv_freq")}
    last = f"model.layers.{cfg.num_layers - 1}.input_layernorm.weight"
    extra = f"model.layers.{cfg.num_layers}.input_layernorm.weight"
    if last not in sd or extra in sd:
        raise ValueError(f"{path} is not a {cfg.num_layers}-layer LLaMA "
                         f"state dict")
    return sd
