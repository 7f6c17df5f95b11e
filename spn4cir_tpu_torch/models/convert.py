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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from spn4cir_tpu_torch.models.clip import CLIPConfig

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
