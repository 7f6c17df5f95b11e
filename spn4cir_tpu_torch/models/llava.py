"""LLaVA-v1: the CLIP ViT-L/14 vision tower, the linear projector and a
decoder LM: LLaMA (LLaVA-v1's own), or DeepSeek-V3 at Moonlight-16B-A3B's
widths or Kimi-Linear-48B-A3B's (`models/deepseek_v3.py`) in the same slot.

Counterpart of `spn4cir_tpu/models/llava.py`, under the parameter names of
HF's `LlavaLlamaForCausalLM`, so a LLaVA state dict loads with
`models.convert.load_llava_checkpoint` and `load_state_dict`:
  * `model.vision_tower.vision_tower.vision_model.*`, HF `CLIPVisionModel`'s
    names (`embeddings.{patch_embedding, class_embedding,
    position_embedding}`, `pre_layrnorm` (sic), `encoder.layers.{i}.
    {self_attn.{q,k,v,out}_proj, layer_norm1, layer_norm2, mlp.fc1,
    mlp.fc2}`), QuickGELU;
  * `model.mm_projector` (Linear vision width -> LM hidden);
  * the LLaMA under `model.embed_tokens`, `model.layers.*`, `model.norm` and
    `lm_head`, read by `models/llama.py` as it reads the rewriter's; or the
    DeepSeek-V3 LM under HF `DeepseekV3ForCausalLM`'s names
    (`LlavaDeepseekV3ForCausalLM`). `LlavaConfig.llama` holds the LM's
    configuration, a `LlamaConfig` or a `DeepseekV3Config`, and picks it.

The feature tap (`clip_encoder.py:29-37`) is hidden_states[-2] without the
CLS token and before any final LayerNorm, so the tower holds only the
`effective_layers` blocks it runs (23 of ViT-L/14's 24) and no
`post_layernorm`. Its attention goes through the shared core
`models/layers.SelfAttention.attend`: at S = 257 that is kernel #3
(`long_attention`) on a CUDA tensor.

`LlavaCaptioner.caption` is the captioning contract of
`zscir/captioner_llava.py:32-62`: the llava_v1 template, the image token
spliced in (`tokenizer_image_token`, `splice_image_embeds`), sampling at
T=0.01 / top_p=0.01 through `models.llama.llama_generate` (decode steps
through kernel #11, `attn_kernel=None` -> `DECODE_ATTN_DEFAULT`) or
`models.deepseek_v3.deepseek_v3_generate` (kernel #14 in every MoE layer),
one loop for both (`generation.decode_loop`), stop at EOS ('</s>' =
conv.sep2). Kernel #12 stays off unless the caller sets `quant_kernel`, as
in the JAX captioner (`llava.py:238`). The DeepSeek-V3 LM takes neither
`quantize()` nor `mesh=`. The tower and the projector run under the span
`caption.vision`.

Precision: the LM's weights take the model's `dtype` (bf16 on the card for
the 7B); the tower and the projector keep float32 weights, cast at use to
the activations' `dtype` (bf16 on the card), LayerNorm statistics in
float32, as the JAX module does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from spn4cir_tpu_torch.models.deepseek_v3 import (DeepseekV3Config,
                                                  DeepseekV3ForCausalLM,
                                                  deepseek_v3_generate,
                                                  init_deepseek_param)
from spn4cir_tpu_torch.models.layers import (LayerNorm, SelfAttention, linear,
                                             quick_gelu)
from spn4cir_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                            _embed_rows, _flat,
                                            init_llama_param, llama_generate,
                                            quantize_llama_weights)
from spn4cir_tpu_torch.utils.logging import span
from spn4cir_tpu_torch.utils.tensors import as_tensor

IMAGE_TOKEN_INDEX = -200  # zscir/llava/constants.py:8
DEFAULT_IMAGE_TOKEN = "<image>"

# conv_llava_v1 (zscir/llava/conversation.py:336-347)
LLAVA_V1_SYSTEM = (
    "A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the human's questions.")
LLAVA_V1_ROLES = ("USER", "ASSISTANT")
LLAVA_V1_SEP = " "
LLAVA_V1_SEP2 = "</s>"

#: the names of the parameters outside the language model
VISION_PREFIXES = ("model.vision_tower.", "model.mm_projector.")


@dataclasses.dataclass(frozen=True)
class LlavaVisionConfig:
    """HF CLIPVisionModel geometry (clip-vit-large-patch14 defaults)."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    select_layer: int = -2  # hidden_states index, HF convention
    select_feature: str = "patch"  # 'patch' drops CLS; 'cls_patch' keeps

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def effective_layers(self) -> int:
        """Blocks actually run: hidden_states[-2] = depth-1 blocks applied."""
        n = (self.num_layers + self.select_layer + 1
             if self.select_layer < 0 else self.select_layer)
        assert 0 < n <= self.num_layers
        return n

    @classmethod
    def tiny(cls, **kw) -> "LlavaVisionConfig":
        base = dict(image_size=28, patch_size=14, width=32, num_layers=3,
                    num_heads=4)
        base.update(kw)
        return cls(**base)


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    """`llama`: the language model's configuration, a `LlamaConfig` or a
    `DeepseekV3Config`."""

    llama: Union[LlamaConfig, DeepseekV3Config]
    vision: LlavaVisionConfig

    @property
    def deepseek(self) -> bool:
        return isinstance(self.llama, DeepseekV3Config)

    @classmethod
    def v1_7b(cls) -> "LlavaConfig":
        return cls(llama=LlamaConfig.llama_7b(), vision=LlavaVisionConfig())

    @classmethod
    def moonlight(cls) -> "LlavaConfig":
        """LLaVA-v1's tower and projector before Moonlight-16B-A3B."""
        return cls(llama=DeepseekV3Config.moonlight_16b_a3b(),
                   vision=LlavaVisionConfig())

    @classmethod
    def kimi_linear(cls, experts_held: int = 64,
                    first_expert: int = 0) -> "LlavaConfig":
        """LLaVA-v1's tower and projector before Kimi-Linear-48B-A3B, with
        `experts_held` of each layer's 256 experts from `first_expert` on:
        by default one device's share of a four-way expert-parallel
        deployment (the whole model, 98 GB in bf16, fits no one card)."""
        return cls(llama=DeepseekV3Config.kimi_linear_48b_a3b(
            experts_held=experts_held, first_expert=first_expert),
                   vision=LlavaVisionConfig())

    @classmethod
    def tiny(cls, vocab_size: int = 128, lm: str = "llama") -> "LlavaConfig":
        """`lm`: "llama", "deepseek" (Moonlight's kind) or "kimi"."""
        lm_cfg = {"deepseek": DeepseekV3Config.tiny,
                  "kimi": DeepseekV3Config.tiny_kimi}.get(
                      lm, LlamaConfig.tiny)(vocab_size=vocab_size)
        return cls(llama=lm_cfg, vision=LlavaVisionConfig.tiny())


# ---------------------------------------------------------------------------
# the vision tower, HF CLIPVisionModel's names
# ---------------------------------------------------------------------------

class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: LlavaVisionConfig, **factory):
        super().__init__()
        p = cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, cfg.width, p, stride=p,
                                         bias=False, **factory)
        self.class_embedding = nn.Parameter(torch.empty(cfg.width, **factory))
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, cfg.width,
                                               **factory)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in the activation dtype -> (B, 1+P, width): the
        bias-free stride-p convolution as one matmul over flattened
        (channel, row, column) patches (OIHW weight), CLS first, plus the
        positions."""
        b, h, w, c = images.shape
        p = self.patch_embedding.kernel_size[0]
        patches = images.reshape(b, h // p, p, w // p, p, c).permute(
            0, 1, 3, 5, 2, 4).reshape(b, (h // p) * (w // p), c * p * p)
        weight = self.patch_embedding.weight.to(images.dtype).reshape(
            self.patch_embedding.out_channels, -1)
        x = patches @ weight.T
        cls = self.class_embedding.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.position_embedding.weight.to(x.dtype)


class CLIPAttention(SelfAttention):
    """HF's separate q / k / v projections, fused into one product at use
    for the shared attention core."""

    def __init__(self, width: int, num_heads: int, **factory):
        super().__init__(num_heads)
        self.q_proj = nn.Linear(width, width, **factory)
        self.k_proj = nn.Linear(width, width, **factory)
        self.v_proj = nn.Linear(width, width, **factory)
        self.out_proj = nn.Linear(width, width, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        projs = (self.q_proj, self.k_proj, self.v_proj)
        weight = torch.cat([m.weight for m in projs]).to(x.dtype)
        bias = torch.cat([m.bias for m in projs]).to(x.dtype)
        return linear(self.attend(F.linear(x, weight, bias)), self.out_proj)


class CLIPMLP(nn.Module):
    def __init__(self, width: int, **factory):
        super().__init__()
        self.fc1 = nn.Linear(width, 4 * width, **factory)
        self.fc2 = nn.Linear(4 * width, width, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(quick_gelu(linear(x, self.fc1)), self.fc2)


class CLIPEncoderLayer(nn.Module):
    """Pre-LN block, LN eps 1e-5 in float32."""

    def __init__(self, cfg: LlavaVisionConfig, **factory):
        super().__init__()
        self.self_attn = CLIPAttention(cfg.width, cfg.num_heads, **factory)
        self.layer_norm1 = LayerNorm(cfg.width, **factory)
        self.mlp = CLIPMLP(cfg.width, **factory)
        self.layer_norm2 = LayerNorm(cfg.width, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: LlavaVisionConfig, **factory):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, **factory)
                                    for _ in range(cfg.effective_layers))


class LlavaVisionTower(nn.Module):
    """HF CLIPVisionTransformer cut at the feature tap: embeddings ->
    pre-LN -> `effective_layers` blocks; no post_layernorm."""

    def __init__(self, cfg: LlavaVisionConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg, **factory)
        self.pre_layrnorm = LayerNorm(cfg.width, **factory)
        self.encoder = CLIPEncoder(cfg, **factory)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, P, width) patch features ('patch'), or
        (B, 1+P, width) with 'cls_patch'."""
        x = self.pre_layrnorm(self.embeddings(images))
        for layer in self.encoder.layers:
            x = layer(x)
        return x[:, 1:] if self.cfg.select_feature == "patch" else x


class _CLIPVisionModel(nn.Module):
    """HF CLIPVisionModel: only the name level `vision_model`."""

    def __init__(self, cfg: LlavaVisionConfig, **factory):
        super().__init__()
        self.vision_model = LlavaVisionTower(cfg, **factory)


class CLIPVisionTower(nn.Module):
    """LLaVA's CLIPVisionTower: only the name level `vision_tower`."""

    def __init__(self, cfg: LlavaVisionConfig, **factory):
        super().__init__()
        self.vision_tower = _CLIPVisionModel(cfg, **factory)


@torch.no_grad()
def init_vision_param(name: str, p: torch.Tensor,
                      generator: torch.Generator, width: int) -> None:
    """One tower or projector weight drawn in place: normal width^-½ for
    the class token and the positions (the JAX initialiser), fan-in normal
    for the matrices and the patch convolution, zero biases, unit norms."""
    if name.endswith(("class_embedding", "position_embedding.weight")):
        p.normal_(0.0, width ** -0.5, generator=generator)
    elif "norm" in name.rsplit(".", 2)[-2] or name.endswith("bias"):
        p.fill_(1.0 if name.endswith("weight") else 0.0)
    else:
        p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)


class _LlavaVision:
    """The LLaVA side of a multimodal LM: the tower and the projector
    attached under `model.`, their initialisation and `encode_images`."""

    init_lm_param = staticmethod(init_llama_param)

    def _attach_vision(self, cfg: LlavaConfig, device, dtype) -> None:
        self.llava_cfg = cfg
        self.act_dtype = dtype or torch.float32
        self.model.vision_tower = CLIPVisionTower(cfg.vision, device=device)
        self.model.mm_projector = nn.Linear(cfg.vision.width,
                                            cfg.llama.hidden_size,
                                            device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        width = self.llava_cfg.vision.width
        for name, p in self.named_parameters():
            if name.startswith(VISION_PREFIXES):
                init_vision_param(name, p, generator, width)
            else:
                self.init_lm_param(name, p, generator)

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) preprocessed -> (B, P, LM hidden) projected patch
        features in the activation dtype (llava_arch.py:85-88)."""
        tower = self.model.vision_tower.vision_tower.vision_model
        return linear(tower(images.to(self.act_dtype)),
                      self.model.mm_projector)


class LlavaLlamaForCausalLM(_LlavaVision, LlamaForCausalLM):
    """vision tower + mm_projector + LLaMA (llava_arch.py:26-46). The
    LLaMA keeps `LlamaForCausalLM`'s names and forward (`inputs_embeds`
    takes the spliced embeddings); `encode_images` is the LLaVA side.

    `device="meta"` then `to_empty(device=...)` and `init_weights` builds a
    7B on the card without a first random pass."""

    def __init__(self, cfg: LlavaConfig, device=None, dtype=None):
        super().__init__(cfg.llama, device=device, dtype=dtype)
        self._attach_vision(cfg, device, dtype)


class LlavaDeepseekV3ForCausalLM(_LlavaVision, DeepseekV3ForCausalLM):
    """vision tower + mm_projector + DeepSeek-V3 under HF
    `DeepseekV3ForCausalLM`'s names."""

    init_lm_param = staticmethod(init_deepseek_param)

    def __init__(self, cfg: LlavaConfig, device=None, dtype=None):
        super().__init__(cfg.llama, device=device, dtype=dtype)
        self._attach_vision(cfg, device, dtype)


# ---------------------------------------------------------------------------
# the prompt and the splice
# ---------------------------------------------------------------------------

def tokenizer_image_token(prompt: str, encode: Callable[[str], List[int]],
                          bos_id: Optional[int],
                          image_token_index: int = IMAGE_TOKEN_INDEX
                          ) -> List[int]:
    """`zscir/llava/mm_utils.py:18-37` over a generic `encode`: split the
    prompt on '<image>', tokenize each chunk, and splice
    `image_token_index` between chunks, dropping each later chunk's BOS."""
    chunks = [encode(c) for c in prompt.split(DEFAULT_IMAGE_TOKEN)]

    def insert_separator(seq, sep):
        return [e for pair in zip(seq, [sep] * len(seq)) for e in pair][:-1]

    input_ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and bos_id is not None and chunks[0][0] == bos_id:
        offset = 1
        input_ids.append(chunks[0][0])
    for x in insert_separator(chunks, [image_token_index] * (offset + 1)):
        input_ids.extend(x[offset:])
    return input_ids


def build_llava_v1_prompt(user_message: str) -> str:
    """conv_llava_v1 single-turn prompt (conversation.py:50-60, TWO style):
    system + sep + 'USER: <msg>' + sep + 'ASSISTANT:'. The captioner's
    message is '<image>\\nuser: {prompt}' (captioner_llava.py:35-41)."""
    msg = f"{DEFAULT_IMAGE_TOKEN}\nuser: {user_message}"
    return (LLAVA_V1_SYSTEM + LLAVA_V1_SEP
            + f"{LLAVA_V1_ROLES[0]}: {msg}" + LLAVA_V1_SEP
            + f"{LLAVA_V1_ROLES[1]}:")


def splice_image_embeds(embed_table, ids: Sequence[int],
                        image_features: torch.Tensor) -> torch.Tensor:
    """(B, P_pre + num_patches + P_post, D) inputs_embeds from a shared
    prompt id list holding exactly one IMAGE_TOKEN_INDEX (llava_arch.py:
    137-143: embeddings before, the image features, embeddings after).
    image_features: (B, num_patches, D). `embed_table` is the dense (V, D)
    table or the int8 QuantKernel of a weight-quantized LM (its rows come
    out float32, `models.llama._embed_rows`)."""
    ids = list(ids)
    img_pos = ids.index(IMAGE_TOKEN_INDEX)
    dev = image_features.device
    pre = _embed_rows(embed_table, torch.tensor(ids[:img_pos], device=dev))
    post = _embed_rows(embed_table,
                       torch.tensor(ids[img_pos + 1:], device=dev))
    b = image_features.shape[0]
    return torch.cat([pre[None].expand(b, -1, -1),
                      image_features.to(pre.dtype),
                      post[None].expand(b, -1, -1)], dim=1)


# ---------------------------------------------------------------------------
# the captioner
# ---------------------------------------------------------------------------

class LlavaCaptioner:
    """Batched LLaVA captioning with the reference's prompt and sampling
    contract (captioner_llava.py:32-62).

    `tokenizer` exposes encode(str) -> List[int] (BOS included),
    decode(List[int]) -> str, bos_token_id and eos_token_id: an HF LLaMA
    tokenizer, or the byte tokenizer (`tokenizer/bytelevel.py`).

    The weights live in `self.model` (built on the meta device and moved to
    `device` uninitialised: `init_params` or `load_state_dict` fills them).
    The LM that generation reads is `self.lm_params`: the model itself, or
    after `quantize()` the int8 dict of `quantize_llama_weights`.
    `quant_kernel` (False by default, as in the JAX captioner) sends the
    decode steps' int8 products through kernel #12.

    `mesh` (a `parallel.mesh.Mesh` with a model axis; every rank of it
    makes the same calls): at the first caption the vision tower is cut to
    this rank's tensor-parallel slice (`parallel.tp.shard_module_tp`), the
    projector stays whole, and the LM becomes this rank's slice and local
    geometry (`parallel.tp.shard_llama_params`); its full weights are
    released. A DeepSeek-V3 LM (`cfg.deepseek`) refuses `mesh` and
    `quantize()`: its int8 weights and tensor parallelism are not
    ported."""

    def __init__(self, cfg: LlavaConfig, tokenizer,
                 dtype: torch.dtype = torch.float32, device="cpu",
                 mesh=None):
        from spn4cir_tpu_torch.parallel.mesh import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise ValueError(f"mesh= takes a parallel.mesh.Mesh, not "
                             f"{type(mesh).__name__}")
        if mesh is not None and cfg.deepseek:
            raise ValueError("the DeepSeek-V3 LM runs on one device: tensor "
                             "parallelism (mesh=) is not ported for it")
        self.mesh = mesh
        self.lm_cfg = cfg.llama
        self.cfg = cfg
        self.tok = tokenizer
        self.device = torch.device(device)
        model_cls = (LlavaDeepseekV3ForCausalLM if cfg.deepseek
                     else LlavaLlamaForCausalLM)
        self.model = model_cls(cfg, device="meta", dtype=dtype)
        self.model.to_empty(device=self.device)
        self.model.eval()
        self.lm_params = self.model
        self.quant_kernel = False

    def init_params(self, generator: torch.Generator) -> None:
        """Random weights from `generator` (a generator of the device)."""
        self.model.init_weights(generator)

    @torch.no_grad()
    def quantize(self) -> None:
        """Weight-only int8 LM (`quantize_llama_weights`); the dense LM
        tensors are released, the tower and the projector stay."""
        if self.cfg.deepseek:
            raise ValueError("int8 weights are not ported for the DeepSeek-V3 "
                             "LM: quantize() takes the LLaMA LM only")
        dense = {k: v for k, v in self.model.named_parameters()
                 if not k.startswith(VISION_PREFIXES)}
        self.lm_params = quantize_llama_weights(dense)
        for p in dense.values():
            p.data = p.data.new_empty(0)

    @torch.no_grad()
    def shard(self) -> None:
        """Cut the tower and the LM to this rank's slices (once)."""
        from spn4cir_tpu_torch.parallel.tp import (shard_llama_params,
                                                   shard_module_tp)

        if self.mesh is None or self.lm_cfg is not self.cfg.llama:
            return
        shard_module_tp(self.model.model.vision_tower, self.mesh)
        lm = {k: v for k, v in _flat(self.lm_params).items()
              if not k.startswith(VISION_PREFIXES)}
        self.lm_params, self.lm_cfg = shard_llama_params(
            lm, self.cfg.llama, self.mesh)
        for name, p in self.model.named_parameters():
            if not name.startswith(VISION_PREFIXES):
                p.data = p.data.new_empty(0)

    def prompt_ids(self, user_message: str) -> List[int]:
        prompt = build_llava_v1_prompt(user_message)
        return tokenizer_image_token(prompt, self.tok.encode,
                                     getattr(self.tok, "bos_token_id", None))

    @torch.inference_mode()
    def caption(self, images, user_message: str, *,
                max_new_tokens: int = 64, temperature: float = 0.01,
                top_p: float = 0.01,
                generator: Optional[torch.Generator] = None,
                cache_dtype=None, attn_kernel=None, tap=None) -> List[str]:
        """images: (B, H, W, 3) preprocessed floats -> B caption strings.

        `cache_dtype` defaults to bfloat16 at LM widths >= 1024 and float32
        below, as in the JAX package. `tap` (DeepSeek-V3 LM): a callable that
        receives the routes, logits and tokens as they are produced
        (`models.deepseek_v3.deepseek_v3_generate`)."""
        if cache_dtype is None:
            cache_dtype = (torch.bfloat16
                           if self.cfg.llama.hidden_size >= 1024
                           else torch.float32)
        self.shard()
        ids = self.prompt_ids(user_message)
        eos = self.tok.eos_token_id
        with span("caption.vision"):
            images = as_tensor(images).to(self.device)
            feats = self.model.encode_images(images)
            table = (self.model.model.embed_tokens.weight if self.cfg.deepseek
                     else _flat(self.lm_params)["model.embed_tokens.weight"])
            embeds = splice_image_embeds(table, ids, feats)
        if self.cfg.deepseek:
            out = deepseek_v3_generate(
                self.model, self.lm_cfg, embeds, eos_id=eos, pad_id=eos,
                max_new_tokens=max_new_tokens, do_sample=True,
                temperature=temperature, top_p=top_p, generator=generator,
                cache_dtype=cache_dtype, tap=tap)
        else:
            out = llama_generate(
                self.lm_params, self.lm_cfg, embeds, eos_id=eos, pad_id=eos,
                max_new_tokens=max_new_tokens, do_sample=True,
                temperature=temperature, top_p=top_p, generator=generator,
                cache_dtype=cache_dtype, quant_kernel=self.quant_kernel,
                attn_kernel=attn_kernel)
        captions = []
        for row in out.cpu().tolist():
            toks = []
            for t in row:
                if t == eos:
                    break
                toks.append(t)
            text = self.tok.decode(toks)
            captions.append(text.strip().replace(LLAVA_V1_SEP2, ""))
        return captions
