"""DeepSeek-V3 decoder: latent attention (MLA) and a mixture of experts, the
architecture of Moonlight-16B-A3B, the second language model of the LLaVA
captioner (`models/llava.py`); and Kimi-Linear-48B-A3B, the same decoder
with Kimi Delta Attention (KDA) in place of MLA in three layers of four
(`kda_layers`), MLA without position rotation (`mla_use_nope`), and a
mixture of experts of which this device holds a share (`experts_held`).

Under the parameter names of HF `DeepseekV3ForCausalLM`, so a published
state dict loads with `load_state_dict`: `model.embed_tokens`,
`model.layers.{i}.self_attn.{q_proj, kv_a_proj_with_mqa, kv_a_layernorm,
kv_b_proj, o_proj}`, `model.layers.{i}.{input,post_attention}_layernorm`,
`mlp.{gate,up,down}_proj` on the first `first_k_dense_replace` layers,
`mlp.gate.{weight, e_score_correction_bias}`,
`mlp.experts.{e}.{gate,up,down}_proj` and `mlp.shared_experts.*` on the
others, `model.norm`, `lm_head`. The equations are transformers'
`DeepseekV3` (and HF's `modeling_deepseek.py`, which agree on these points):

  - RMSNorm pre-norm, the variance in float32 (`models/llama.rms_norm`);
  - attention: q = q_proj(h) per head [nope 128 | rope 64]; [c | k_pe] =
    kv_a_proj_with_mqa(h), c (512) through kv_a_layernorm; per head [k_nope
    | v] = kv_b_proj(c); RoPE on the 64 rope dimensions, pairs de-interleaved
    then rotate_half, k_pe shared by the heads; scores over q·k of 192
    dimensions at 192^-½; the causal mask; o_proj;
  - the router: float32 logits of the hidden state, sigmoid scores, the
    top-k chosen by score + e_score_correction_bias, weights the chosen
    unbiased scores over their sum (+1e-20) times routed_scaling_factor;
    the output is Σ w·E(x) (float32, then the hidden type) + shared(x).
Only Moonlight's and Kimi-Linear's geometry: no q compression
(`q_lora_rank` None), no group-limited routing (topk_group == n_group), no
rope scaling.

Kimi Delta Attention (`KimiDeltaAttention`; parameter names after HF
`modeling_kimi.py` and fla's `KimiDeltaAttention`), per head of 128:
q, k, v = SiLU(ShortConv₄(W_{q,k,v} h)), the convolution causal and
depthwise with no bias (`{q,k,v}_conv1d`); the log decay g = −exp(A_log) ·
softplus(f_proj(h) + dt_bias) per channel, f_proj low-rank (hidden -> 128
-> heads·128); β = sigmoid(b_proj(h)) a head; the gated delta rule over a
float32 state of 128 x 128 a head (`ops/kda.py`, kernel #15, which also
L2-normalises q and k and scales q by 128^-½); out = o_proj(RMSNorm(o) ⊙
sigmoid(g_proj(h))), the norm a head (`o_norm`), g_proj low-rank like
f_proj. The projections run in the model's type; the convolution, the
gates, the recurrence and the gated norm in float32.

The expert share: the router scores all `n_routed_experts` experts and
chooses k of them; the layer holds `experts_held` experts from
`first_expert` on (`experts.{i}` is expert first_expert + i) and computes
only the routes that land on them, plus the shared experts in full. That is
one device's part of an expert-parallel layer; what the other devices'
experts add is not computed here.

Generation splits prefill and decode as `models/llama.py` does, over a
`DeepseekV3DecodeState`: one latent row a token and an MLA layer, [c | k_pe]
(512 + 64), after kv_a_layernorm and after RoPE, in the cache type; and for
each KDA layer a float32 state (heads, 128, 128) and the last 3 rows of q, k
and v before the convolution, in the model's type, both of a fixed size a
sequence, which the prefill writes and each decode step updates in place.
Prefill
decompresses the latent per head; a decode step takes the absorbed form:
the query's nope part through kv_b_proj's key half into the latent,
q_lat = q_nope·W_k (512), scores [q_lat | q_pe]·[c | k_pe] against the
cache, and the values read back through the value half, ctx·W_v, all 16
heads on one latent row (float32 products over the bf16 cache). Both
compute the same function (a test holds them to each other).

A decode step reads its position from a 0-d device tensor and attends to
every cache row under an additive mask (0 up to the position, -inf above,
so the rows above weigh exactly 0): its shapes are the batch's, and nothing
in it waits for the host. On a CUDA device `deepseek_v3_generate` captures
it once in a CUDA graph (`DecodeGraph`, one a model) and replays it for
every new token; the CPU runs the same body eagerly.

Kernels: the routed experts of every MoE layer, prefill and decode, go
through `ops.moe_grouped` (kernel #14 on a CUDA tensor; the routing
permutation and the combine are tensor code, no host sync). The shared
experts run as a plain SwiGLU (three products). Attention is tensor code.

Precision: weights and the residual stream in the model's type (bf16 on
the card), products in that type, attention scores and softmax in float32,
router in float32, the routed sum in float32 and rounded once, the head in
the model's type and its logits widened to float32 (HF's order).

Spans (`utils.logging.span`, recorded only under a profiler): `mla.attend`
or `kda.attend` around each layer's attention, `kda.recur` around #15,
`moe.route`, `moe.experts` (routed and
shared), `moe.combine` per MoE layer; a replayed decode step records none
of them (its host work is one `cudaGraphLaunch`). A `tap(kind, index,
tensor)` callable given to the generation functions receives each MoE
layer's choice, ("route", layer, (B, S, k)), S = 1 at a decode step, before
the experts run (after the replay, from the graph's own index tensors, on a
replayed step).

Counters of `deepseek_v3_generate`'s steps:
`deepseek_v3_decode_step.eager_steps` (run as Python), `.captures` (graphs
captured) and `.replays`. `moe_grouped.launches` follows `ops/cuda_build`'s
rule: a capture counts none and each replay counts the step's launches, so
it equals the launches of #14's device sums, `moe_stats()`; so do
`kda_prefill.launches` and `kda_decode.launches` (#15).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spn4cir_tpu_torch.models.generation import decode_loop, sample_logits
from spn4cir_tpu_torch.models.llama import LlamaRMSNorm, _rotate_half
from spn4cir_tpu_torch.ops.cuda_build import capturing, replayed
from spn4cir_tpu_torch.ops.kda import kda_decode, kda_prefill
from spn4cir_tpu_torch.ops.moe_grouped import (moe_combine, moe_grouped,
                                               route_permutation)
from spn4cir_tpu_torch.utils.logging import span

Tap = Optional[Callable[[str, int, torch.Tensor], None]]

#: the port's field -> the key of HF's config.json
HF_KEYS = {
    "vocab_size": "vocab_size", "hidden_size": "hidden_size",
    "intermediate_size": "intermediate_size",
    "moe_intermediate_size": "moe_intermediate_size",
    "num_layers": "num_hidden_layers", "num_heads": "num_attention_heads",
    "q_lora_rank": "q_lora_rank", "kv_lora_rank": "kv_lora_rank",
    "qk_nope_head_dim": "qk_nope_head_dim",
    "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
    "n_routed_experts": "n_routed_experts",
    "n_shared_experts": "n_shared_experts",
    "num_experts_per_tok": "num_experts_per_tok",
    "first_k_dense_replace": "first_k_dense_replace",
    "moe_layer_freq": "moe_layer_freq",
    "routed_scaling_factor": "routed_scaling_factor",
    "norm_topk_prob": "norm_topk_prob", "n_group": "n_group",
    "topk_group": "topk_group", "rope_theta": "rope_theta",
    "rms_eps": "rms_norm_eps",
    "max_position_embeddings": "max_position_embeddings",
}
#: settings of HF's config.json that the port reads only to refuse others
HF_FIXED = {"model_type": "deepseek_v3", "hidden_act": "silu",
            "scoring_func": "sigmoid", "topk_method": "noaux_tc",
            "attention_bias": False, "tie_word_embeddings": False}

#: the port's field -> the key of Kimi-Linear's config.json (`kimi_linear`)
KIMI_KEYS = {
    "vocab_size": "vocab_size", "hidden_size": "hidden_size",
    "intermediate_size": "intermediate_size",
    "moe_intermediate_size": "moe_intermediate_size",
    "num_layers": "num_hidden_layers", "num_heads": "num_attention_heads",
    "q_lora_rank": "q_lora_rank", "kv_lora_rank": "kv_lora_rank",
    "qk_nope_head_dim": "qk_nope_head_dim",
    "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
    "n_shared_experts": "num_shared_experts",
    "num_experts_per_tok": "num_experts_per_token",
    "first_k_dense_replace": "first_k_dense_replace",
    "moe_layer_freq": "moe_layer_freq",
    "routed_scaling_factor": "routed_scaling_factor",
    "norm_topk_prob": "moe_renormalize", "n_group": "num_expert_group",
    "topk_group": "topk_group", "rope_theta": "rope_theta",
    "rms_eps": "rms_norm_eps", "max_position_embeddings": "model_max_length",
    "mla_use_nope": "mla_use_nope",
}
#: settings of Kimi-Linear's config.json that the port reads only to refuse
#: others
KIMI_FIXED = {"model_type": "kimi_linear", "hidden_act": "silu",
              "moe_router_activation_func": "sigmoid",
              "use_grouped_topk": True, "num_nextn_predict_layers": 0,
              "rope_scaling": None, "tie_word_embeddings": False}


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_layers: int = 27
    num_heads: int = 16
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    n_group: int = 1
    topk_group: int = 1
    rope_theta: float = 50000.0
    rms_eps: float = 1e-5
    max_position_embeddings: int = 8192
    #: Kimi-Linear: the layers (0-based) whose attention is KDA, the others
    #: MLA; KDA's heads, head size and short-convolution width
    kda_layers: Tuple[int, ...] = ()
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    kda_conv_size: int = 4
    #: MLA with no position rotation of its rope dimensions
    mla_use_nope: bool = False
    #: the routed experts this device holds, from `first_expert` on (None:
    #: all n_routed_experts)
    experts_held: Optional[int] = None
    first_expert: int = 0

    def __post_init__(self):
        if self.q_lora_rank is not None:
            raise ValueError("the port's DeepSeek-V3 has no q compression "
                             "(q_lora_rank must be None, as Moonlight's is)")
        if self.topk_group != self.n_group or self.moe_layer_freq != 1:
            raise ValueError("the port's DeepSeek-V3 routes over every "
                             "expert (topk_group == n_group) with experts "
                             "in every layer after the dense ones")
        if not (0 <= self.first_expert and 1 <= self.held_experts
                and self.first_expert + self.held_experts
                <= self.n_routed_experts):
            raise ValueError(f"experts {self.first_expert} .. "
                             f"{self.first_expert + self.held_experts - 1} "
                             f"are not among the {self.n_routed_experts} "
                             f"routed experts")
        if any(not 0 <= i < self.num_layers for i in self.kda_layers):
            raise ValueError(f"kda_layers {self.kda_layers} are not among "
                             f"the {self.num_layers} layers")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """A cached token a layer: [c | k_pe]."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def held_experts(self) -> int:
        return (self.n_routed_experts if self.experts_held is None
                else self.experts_held)

    @property
    def kda_dim(self) -> int:
        """KDA's q, k, v and gate width: heads x head size."""
        return self.kda_num_heads * self.kda_head_dim

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace

    def is_kda(self, layer: int) -> bool:
        return layer in self.kda_layers

    def slot(self, layer: int) -> int:
        """The layer's index among the layers of its attention's kind: its
        row of the decode state's latent cache (MLA) or KDA state."""
        return sum(self.is_kda(i) == self.is_kda(layer) for i in range(layer))

    @property
    def mla_layers(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.num_layers) if not self.is_kda(i))

    @classmethod
    def moonlight_16b_a3b(cls) -> "DeepseekV3Config":
        """moonshotai/Moonlight-16B-A3B's config.json."""
        return cls()

    @classmethod
    def kimi_linear_48b_a3b(cls, experts_held: Optional[int] = None,
                            first_expert: int = 0) -> "DeepseekV3Config":
        """moonshotai/Kimi-Linear-48B-A3B-Instruct's config.json: 27 layers,
        KDA in all but 3, 7, ..., 23 and 26 (0-based); all 256 experts, or
        `experts_held` of them from `first_expert` on."""
        return cls(hidden_size=2304, intermediate_size=9216,
                   moe_intermediate_size=1024, num_heads=32,
                   n_routed_experts=256, n_shared_experts=1,
                   num_experts_per_tok=8, rope_theta=10000.0,
                   max_position_embeddings=1048576,
                   kda_layers=tuple(i for i in range(27) if i % 4 != 3
                                    and i != 26),
                   mla_use_nope=True, experts_held=experts_held,
                   first_expert=first_expert)

    @classmethod
    def tiny(cls, vocab_size: int = 128, **kw) -> "DeepseekV3Config":
        base = dict(vocab_size=vocab_size, hidden_size=32,
                    intermediate_size=64, moe_intermediate_size=16,
                    num_layers=3, num_heads=4, kv_lora_rank=16,
                    qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
                    n_routed_experts=8, n_shared_experts=2,
                    num_experts_per_tok=3, max_position_embeddings=512)
        base.update(kw)
        return cls(**base)

    @classmethod
    def tiny_kimi(cls, vocab_size: int = 128, **kw) -> "DeepseekV3Config":
        """Kimi-Linear's pattern at a small size: [KDA, KDA, KDA, MLA, KDA,
        MLA], layer 0 dense, 8 experts top-2 and 1 shared, 4 KDA heads of
        16."""
        base = dict(vocab_size=vocab_size, hidden_size=64,
                    intermediate_size=128, moe_intermediate_size=32,
                    num_layers=6, num_heads=4, kv_lora_rank=16,
                    qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
                    n_routed_experts=8, n_shared_experts=1,
                    num_experts_per_tok=2, max_position_embeddings=512,
                    kda_layers=(0, 1, 2, 4), kda_num_heads=4,
                    kda_head_dim=16, mla_use_nope=True)
        base.update(kw)
        return cls(**base)

    @classmethod
    def from_hf(cls, hf: Mapping[str, Any]) -> "DeepseekV3Config":
        """The configuration of an HF config.json (a mapping), DeepSeek-V3's
        keys or Kimi-Linear's (`model_type` "kimi_linear"); settings the
        port does not run are refused. A Kimi file that holds a share of
        the experts gives their count as `num_experts`, the published count
        under `published`, and the first expert held as
        `first_expert_held`."""
        if hf.get("model_type") == "kimi_linear":
            return cls._from_kimi(hf)
        for key, want in HF_FIXED.items():
            if key in hf and hf[key] != want:
                raise ValueError(f"config.json has {key}={hf[key]!r}; the "
                                 f"port runs {want!r}")
        if hf.get("rope_scaling"):
            raise ValueError("the port's DeepSeek-V3 runs no rope scaling")
        return cls(**{f: hf[k] for f, k in HF_KEYS.items() if k in hf})

    @classmethod
    def _from_kimi(cls, hf: Mapping[str, Any]) -> "DeepseekV3Config":
        for key, want in KIMI_FIXED.items():
            if key in hf and hf[key] != want:
                raise ValueError(f"config.json has {key}={hf[key]!r}; the "
                                 f"port runs {want!r}")
        kw = {f: hf[k] for f, k in KIMI_KEYS.items() if k in hf}
        lin = hf["linear_attn_config"]
        kda = tuple(i - 1 for i in lin["kda_layers"])
        full = tuple(i - 1 for i in lin["full_attn_layers"])
        if sorted(kda + full) != list(range(hf["num_hidden_layers"])):
            raise ValueError("linear_attn_config's kda_layers and "
                             "full_attn_layers must split the layers")
        if hf.get("num_key_value_heads", hf["num_attention_heads"]) != \
                hf["num_attention_heads"]:
            raise ValueError("MLA's key and value heads are its heads")
        routed = hf.get("published", {}).get("num_experts", hf["num_experts"])
        return cls(**kw, kda_layers=kda, kda_num_heads=lin["num_heads"],
                   kda_head_dim=lin["head_dim"],
                   kda_conv_size=lin["short_conv_kernel_size"],
                   n_routed_experts=routed,
                   experts_held=(None if routed == hf["num_experts"]
                                 else hf["num_experts"]),
                   first_expert=hf.get("first_expert_held", 0))

    def to_hf(self) -> Dict[str, Any]:
        """The keys of HF's config.json that the model reads, under its
        family's names: Kimi-Linear's where a layer is KDA, DeepSeek-V3's
        otherwise."""
        if not self.kda_layers:
            out = {k: getattr(self, f) for f, k in HF_KEYS.items()}
            out.update(HF_FIXED)
            return out
        out = {k: getattr(self, f) for f, k in KIMI_KEYS.items()}
        out.update(KIMI_FIXED)
        out["num_key_value_heads"] = self.num_heads
        out["num_experts"] = self.held_experts
        if self.held_experts != self.n_routed_experts:
            out["published"] = {"num_experts": self.n_routed_experts}
            out["first_expert_held"] = self.first_expert
        out["linear_attn_config"] = {
            "kda_layers": [i + 1 for i in self.kda_layers],
            "full_attn_layers": [i + 1 for i in self.mla_layers],
            "num_heads": self.kda_num_heads, "head_dim": self.kda_head_dim,
            "short_conv_kernel_size": self.kda_conv_size}
        return out


# ---------------------------------------------------------------------------
# the module tree (HF names)
# ---------------------------------------------------------------------------

class DeepseekV3Attention(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, **factory):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_heads
        self.q_proj = nn.Linear(d, h * cfg.qk_head_dim, bias=False, **factory)
        self.kv_a_proj_with_mqa = nn.Linear(d, cfg.latent_dim, bias=False,
                                            **factory)
        self.kv_a_layernorm = LlamaRMSNorm(cfg.kv_lora_rank, cfg.rms_eps,
                                           **factory)
        self.kv_b_proj = nn.Linear(
            cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            bias=False, **factory)
        self.o_proj = nn.Linear(h * cfg.v_head_dim, d, bias=False, **factory)


class KimiDeltaAttention(nn.Module):
    """Kimi Delta Attention's parameters: q/k/v_proj (D -> H·d), their
    depthwise causal convolutions `{q,k,v}_conv1d` (H·d, 1, conv_size) with
    no bias, `A_log` (H,) and `dt_bias` (H·d,) in float32 whatever the
    model's type, f_proj and g_proj as two factors each (D -> d -> H·d),
    b_proj (D -> H), `o_norm` (d,) and o_proj (H·d -> D)."""

    def __init__(self, cfg: DeepseekV3Config, **factory):
        super().__init__()
        d, n, hd = cfg.hidden_size, cfg.kda_dim, cfg.kda_head_dim
        device = factory.get("device")
        self.q_proj = nn.Linear(d, n, bias=False, **factory)
        self.k_proj = nn.Linear(d, n, bias=False, **factory)
        self.v_proj = nn.Linear(d, n, bias=False, **factory)
        for name in ("q_conv1d", "k_conv1d", "v_conv1d"):
            setattr(self, name, nn.Conv1d(n, n, cfg.kda_conv_size, groups=n,
                                          bias=False, **factory))
        self.A_log = nn.Parameter(torch.empty(cfg.kda_num_heads,
                                              device=device,
                                              dtype=torch.float32))
        self.f_proj = nn.Sequential(nn.Linear(d, hd, bias=False, **factory),
                                    nn.Linear(hd, n, bias=False, **factory))
        self.dt_bias = nn.Parameter(torch.empty(n, device=device,
                                                dtype=torch.float32))
        self.b_proj = nn.Linear(d, cfg.kda_num_heads, bias=False, **factory)
        self.g_proj = nn.Sequential(nn.Linear(d, hd, bias=False, **factory),
                                    nn.Linear(hd, n, bias=False, **factory))
        self.o_norm = LlamaRMSNorm(hd, cfg.rms_eps, **factory)
        self.o_proj = nn.Linear(n, d, bias=False, **factory)


class DeepseekV3MLP(nn.Module):
    def __init__(self, hidden: int, width: int, **factory):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, width, bias=False, **factory)
        self.up_proj = nn.Linear(hidden, width, bias=False, **factory)
        self.down_proj = nn.Linear(width, hidden, bias=False, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DeepseekV3TopkRouter(nn.Module):
    """`weight` (E, D) in the model's type; `e_score_correction_bias` (E,)
    float32 whatever the model's type, as published checkpoints hold it."""

    def __init__(self, cfg: DeepseekV3Config, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            cfg.n_routed_experts, cfg.hidden_size, device=device, dtype=dtype))
        self.e_score_correction_bias = nn.Parameter(
            torch.zeros(cfg.n_routed_experts, device=device,
                        dtype=torch.float32), requires_grad=False)


_STACKED = (("gate_proj", "w_gate"), ("up_proj", "w_up"),
            ("down_proj", "w_down"))


class DeepseekV3MoE(nn.Module):
    """The router (over all n_routed_experts), the routed experts this
    device holds (`experts.{i}` is expert first_expert + i) and the shared
    experts (one MLP of n_shared_experts·moe_intermediate_size). Each routed
    expert keeps its
    HF-named parameters, which are views of three stacked tensors `w_gate`,
    `w_up` (E, I, D) and `w_down` (E, D, I) that kernel #14 reads; any
    `_apply` (`to`, `to_empty`, ...) stacks them again, and so does a
    `load_state_dict` that puts new tensors in place of the views
    (`assign=True`)."""

    def __init__(self, cfg: DeepseekV3Config, **factory):
        super().__init__()
        d, width = cfg.hidden_size, cfg.moe_intermediate_size
        self.gate = DeepseekV3TopkRouter(cfg, **factory)
        self.experts = nn.ModuleList(DeepseekV3MLP(d, width, **factory)
                                     for _ in range(cfg.held_experts))
        self.shared_experts = DeepseekV3MLP(d, width * cfg.n_shared_experts,
                                            **factory)
        self._stack()
        self.register_load_state_dict_post_hook(_restack)

    @torch.no_grad()
    def _stack(self) -> None:
        for proj, attr in _STACKED:
            ws = [getattr(e, proj).weight for e in self.experts]
            stacked = torch.stack([w.data for w in ws])
            for i, w in enumerate(ws):
                w.data = stacked[i]
            setattr(self, attr, stacked)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self._stack()
        return self


def _restack(moe: DeepseekV3MoE, incompatible_keys) -> None:
    if any(getattr(e, proj).weight.data_ptr()
           != getattr(moe, attr)[i].data_ptr()
           for proj, attr in _STACKED for i, e in enumerate(moe.experts)):
        moe._stack()


class DeepseekV3DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, index: int, **factory):
        super().__init__()
        self.self_attn = (KimiDeltaAttention(cfg, **factory)
                          if cfg.is_kda(index) else
                          DeepseekV3Attention(cfg, **factory))
        self.mlp = (DeepseekV3MoE(cfg, **factory) if cfg.is_moe(index) else
                    DeepseekV3MLP(cfg.hidden_size, cfg.intermediate_size,
                                  **factory))
        self.input_layernorm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_eps,
                                            **factory)
        self.post_attention_layernorm = LlamaRMSNorm(cfg.hidden_size,
                                                     cfg.rms_eps, **factory)


class DeepseekV3Model(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, **factory):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **factory)
        self.layers = nn.ModuleList(DeepseekV3DecoderLayer(cfg, i, **factory)
                                    for i in range(cfg.num_layers))
        self.norm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_eps, **factory)


@torch.no_grad()
def init_deepseek_param(name: str, p: torch.Tensor,
                        generator: torch.Generator) -> None:
    """One LM weight drawn in place: ones for the norms, zeros for the
    selection bias, normal 0.02 for the embedding and the head, KDA's
    `A_log` and `dt_bias` as the published initialisation draws them
    (A ~ U(1, 16); dt log-uniform in [1e-3, 0.1] through the inverse
    softplus), fan_in^-½ for the matrices and convolutions."""
    if name.endswith(("layernorm.weight", "o_norm.weight")) or \
            name == "model.norm.weight":
        p.fill_(1.0)
    elif name.endswith("e_score_correction_bias"):
        p.zero_()
    elif name in ("model.embed_tokens.weight", "lm_head.weight"):
        p.normal_(0.0, 0.02, generator=generator)
    elif name.endswith("A_log"):
        p.copy_(kda_a_log(p.shape, generator, p.device))
    elif name.endswith("dt_bias"):
        p.copy_(kda_dt_bias(p.shape, generator, p.device))
    else:
        p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)


def kda_a_log(shape, generator: torch.Generator, device) -> torch.Tensor:
    """log A, A ~ U(1, 16) (fla's `KimiDeltaAttention`)."""
    return torch.empty(shape, device=device).uniform_(
        1.0, 16.0, generator=generator).log_()


def kda_dt_bias(shape, generator: torch.Generator, device) -> torch.Tensor:
    """softplus⁻¹(dt), dt log-uniform in [1e-3, 0.1], at least 1e-4 (fla's
    `KimiDeltaAttention`)."""
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(torch.rand(shape, generator=generator, device=device)
                   * (hi - lo) + lo).clamp_(min=1e-4)
    return dt + torch.log(-torch.expm1(-dt))


class DeepseekV3ForCausalLM(nn.Module):
    """Teacher-forced causal LM: ids or embeddings -> (B, S, vocab) float32
    logits over the decompressed attention, and the weights the generation
    functions read.

    `device="meta"` then `to_empty(device=...)` and `init_weights` builds the
    16B model on the card without a first random pass."""

    def __init__(self, cfg: DeepseekV3Config, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        factory = dict(device=device, dtype=dtype)
        self.model = DeepseekV3Model(cfg, **factory)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 **factory)
        self._decode_graph: Optional["DecodeGraph"] = None

    def _apply(self, fn, recurse=True):
        # a captured graph reads the weights at their addresses, which a
        # move or a cast changes
        self._decode_graph = None
        return super()._apply(fn, recurse)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for name, p in self.named_parameters():
            init_deepseek_param(name, p, generator)

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        if inputs_embeds is None:
            inputs_embeds = self.model.embed_tokens.weight[input_ids]
        x = inputs_embeds.to(self.lm_head.weight.dtype)
        x = _prefill_layers(self, self.cfg, x, None, None)
        return _head(self, x)


# ---------------------------------------------------------------------------
# the layers' arithmetic
# ---------------------------------------------------------------------------

def rope_tables(cfg: DeepseekV3Config, positions: torch.Tensor):
    """float32 cos / sin of the rope dimensions at (…,) int positions ->
    (…, qk_rope_head_dim), transformers' [freqs | freqs] layout; (None,
    None) with `mla_use_nope`, whose rope dimensions are not rotated."""
    if cfg.mla_use_nope:
        return None, None
    d = cfg.qk_rope_head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=positions.device) / d))
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope_interleave(x: torch.Tensor, cos: torch.Tensor,
                          sin: torch.Tensor) -> torch.Tensor:
    """transformers' `apply_rotary_pos_emb_interleave` on x (…, d): the
    pairs (x0, x1), (x2, x3), … de-interleaved to [x0 x2 … | x1 x3 …], then
    rotate_half; float32 out (promoted against the tables), in the
    de-interleaved layout."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    return x * cos + _rotate_half(x) * sin


def _mla_inputs(cfg: DeepseekV3Config, attn: DeepseekV3Attention,
                h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """h (B, S, D) -> q_nope (B, S, H, nope) in h's type, q_pe (B, S, H,
    rope) float32, and the latent row [c | k_pe] (B, S, r + rope) in h's
    type, c after kv_a_layernorm and k_pe after RoPE (as they are where
    `cos` is None: `mla_use_nope`)."""
    b, s, _ = h.shape
    q = F.linear(h, attn.q_proj.weight).view(b, s, cfg.num_heads,
                                             cfg.qk_head_dim)
    q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], -1)
    c, k_pe = F.linear(h, attn.kv_a_proj_with_mqa.weight).split(
        [cfg.kv_lora_rank, cfg.qk_rope_head_dim], -1)
    if cos is None:
        q_pe = q_pe.float()
    else:
        q_pe = apply_rope_interleave(q_pe, cos[..., None, :],
                                     sin[..., None, :])
        k_pe = apply_rope_interleave(k_pe, cos, sin).to(h.dtype)
    return q_nope, q_pe, torch.cat([attn.kv_a_layernorm(c), k_pe], dim=-1)


def _mla_decompressed(cfg: DeepseekV3Config, attn: DeepseekV3Attention,
                      q_nope, q_pe, latent, mask) -> torch.Tensor:
    """Every head's keys and values from the latent rows (B, S, r + rope):
    [k_nope | v] = kv_b_proj(c), scores q_nope·k_nope + q_pe·k_pe in
    float32 under the additive mask, the weights in v's type. Returns the
    (B, S, D) output of o_proj."""
    b, s = latent.shape[:2]
    r, vd = cfg.kv_lora_rank, cfg.v_head_dim
    kv = F.linear(latent[..., :r], attn.kv_b_proj.weight).view(
        b, s, cfg.num_heads, cfg.qk_nope_head_dim + vd)
    k_nope, v = kv.split([cfg.qk_nope_head_dim, vd], -1)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
              + torch.einsum("bqhr,bkr->bhqk", q_pe,
                             latent[..., r:].float())) * cfg.qk_head_dim ** -0.5
    w = torch.softmax(logits + mask, dim=-1).to(v.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, q_nope.shape[1], -1)
    return F.linear(ctx, attn.o_proj.weight)


def absorbed_weights(cfg: DeepseekV3Config, attn: DeepseekV3Attention
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kv_b_proj's key and value halves per head, (H, nope, r) and (H, v,
    r), float32."""
    w = attn.kv_b_proj.weight.view(cfg.num_heads, -1, cfg.kv_lora_rank)
    return (w[:, :cfg.qk_nope_head_dim].float(),
            w[:, cfg.qk_nope_head_dim:].float())


def _mla_absorbed(cfg: DeepseekV3Config, attn: DeepseekV3Attention,
                  q_nope, q_pe, latent, w_k, w_v, mask=0.0) -> torch.Tensor:
    """One query a row (q_nope (B, 1, H, nope), q_pe (B, 1, H, rope))
    against latent rows (B, L, r + rope) under the additive `mask` (L,) (0
    on the rows the query sees, -inf on the others), in the absorbed form:
    [q_nope·W_k | q_pe]·[c | k_pe], softmax, (p·c)·W_v, float32 products.
    Returns the (B, 1, D) output of o_proj."""
    b = q_nope.shape[0]
    lat = latent.float()
    q_lat = torch.einsum("bhd,hdc->bhc", q_nope[:, 0].float(), w_k)
    q = torch.cat([q_lat, q_pe[:, 0]], dim=-1)
    logits = (torch.einsum("bhc,blc->bhl", q, lat) * cfg.qk_head_dim ** -0.5
              + mask)
    p = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhl,blc->bhc", p, lat[..., :cfg.kv_lora_rank])
    out = torch.einsum("bhc,hdc->bhd", ctx, w_v).reshape(b, 1, -1)
    return F.linear(out.to(attn.o_proj.weight.dtype), attn.o_proj.weight)


def _swiglu(mlp: DeepseekV3MLP, x: torch.Tensor) -> torch.Tensor:
    return F.linear(F.silu(F.linear(x, mlp.gate_proj.weight))
                    * F.linear(x, mlp.up_proj.weight), mlp.down_proj.weight)


def route(cfg: DeepseekV3Config, gate: DeepseekV3TopkRouter, h: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(topk indices (N, k) int64, weights (N, k) float32) of h (N, D):
    float32 logits, sigmoid scores, the top-k of score + bias, the chosen
    unbiased scores normalised and scaled."""
    scores = torch.sigmoid(F.linear(h.float(), gate.weight.float()))
    choice = scores + gate.e_score_correction_bias.float()
    idx = torch.topk(choice, cfg.num_experts_per_tok, dim=-1).indices
    w = scores.gather(1, idx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * cfg.routed_scaling_factor


def _held_routes(cfg: DeepseekV3Config, idx: torch.Tensor):
    """(src, offsets, inv, held) of a (T, k) choice for the experts held
    here: the routes to the others sort after the held ones, past
    offsets[-1], and `held` (T, k) marks the routes that count. Where every
    expert is held, the whole-layer permutation and no `held`: Moonlight's
    decode step then runs none of the mask's seven small kernels a layer
    (2% of its caption rate on the H100)."""
    if cfg.held_experts == cfg.n_routed_experts:
        return (*route_permutation(idx, cfg.n_routed_experts), None)
    local = idx - cfg.first_expert
    held = (local >= 0) & (local < cfg.held_experts)
    src, offsets, inv = route_permutation(
        torch.where(held, local, cfg.held_experts), cfg.held_experts + 1)
    return src, offsets[:-1], inv, held


def _moe(cfg: DeepseekV3Config, moe: DeepseekV3MoE, h: torch.Tensor,
         layer: int, tap: Tap) -> torch.Tensor:
    lead = h.shape[:-1]
    flat = h.reshape(-1, h.shape[-1])
    with span("moe.route"):
        idx, w = route(cfg, moe.gate, flat)
        src, offsets, inv, held = _held_routes(cfg, idx)
    if tap is not None:
        tap("route", layer, idx.view(*lead, -1))
    with span("moe.experts"):
        y = moe_grouped(flat, src, offsets, moe.w_gate, moe.w_up, moe.w_down)
        shared = _swiglu(moe.shared_experts, flat)
    with span("moe.combine"):
        out = moe_combine(y, inv, w, held).to(h.dtype) + shared
    return out.view(h.shape)


# ---------------------------------------------------------------------------
# Kimi Delta Attention
# ---------------------------------------------------------------------------

def _short_conv(window: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The causal depthwise convolution over window (B, K - 1 + S, C): out[t]
    = Σ_j w[:, j] · window[t + j] (j = 0 .. K - 1, in that order) in float32,
    then SiLU -> (B, S, C). Prefill and decode both call it, so they agree
    to the bit."""
    k = weight.shape[-1]
    s = window.shape[1] - k + 1
    x, w = window.float(), weight.float()[:, 0]
    out = x[:, :s] * w[:, 0]
    for j in range(1, k):
        out += x[:, j:j + s] * w[:, j]
    return F.silu(out, inplace=True)


def _kda_gates(cfg: DeepseekV3Config, attn: KimiDeltaAttention,
               h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The log decay g = −exp(A_log) · softplus(f_proj(h) + dt_bias), (B, S,
    H, d), and β = sigmoid(b_proj(h)), (B, S, H), in float32."""
    b, s, _ = h.shape
    f = F.linear(F.linear(h, attn.f_proj[0].weight), attn.f_proj[1].weight)
    g = F.softplus(f.float() + attn.dt_bias.float()).view(
        b, s, cfg.kda_num_heads, cfg.kda_head_dim)
    g = g * -torch.exp(attn.A_log.float())[:, None]
    beta = torch.sigmoid(F.linear(h, attn.b_proj.weight).float())
    return g, beta


def _kda_out(cfg: DeepseekV3Config, attn: KimiDeltaAttention,
             o: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """o_proj(RMSNorm(o) ⊙ sigmoid(g_proj(h))), the norm over each head's
    d in float32, o_proj in h's type."""
    b, s, _ = h.shape
    gate = F.linear(F.linear(h, attn.g_proj[0].weight), attn.g_proj[1].weight)
    y = (o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + cfg.rms_eps)
         * attn.o_norm.weight.float()
         * torch.sigmoid(gate.float()).view(o.shape))
    return F.linear(y.reshape(b, s, cfg.kda_dim).to(h.dtype),
                    attn.o_proj.weight)


def _kda_parts(attn: KimiDeltaAttention):
    """(projection, convolution) of q, k and v, in the tail's order."""
    return ((attn.q_proj, attn.q_conv1d), (attn.k_proj, attn.k_conv1d),
            (attn.v_proj, attn.v_conv1d))


def _kda_prefill(cfg: DeepseekV3Config, attn: KimiDeltaAttention,
                 h: torch.Tensor, state: torch.Tensor,
                 tail: Optional[torch.Tensor]) -> torch.Tensor:
    """Every position of h (B, S, D) from a zero state: the final S into
    `state` (B, H, d, d) and, given `tail` (B, K - 1, 3·H·d), the last K - 1
    rows of q, k and v before the convolution into it ([q | k | v]; zeros
    before the first position). One projection at a time, to hold one
    float32 window at once."""
    b, s, _ = h.shape
    n, pad = cfg.kda_dim, cfg.kda_conv_size - 1
    qkv = []
    for i, (proj, conv) in enumerate(_kda_parts(attn)):
        rows = F.linear(h, proj.weight)
        window = torch.cat([rows.new_zeros((b, pad, n)), rows], 1)
        del rows
        if tail is not None:
            tail[..., i * n:(i + 1) * n] = window[:, s:]
        qkv.append(_short_conv(window, conv.weight).view(
            b, s, cfg.kda_num_heads, cfg.kda_head_dim))
        del window
    q, k, v = qkv
    g, beta = _kda_gates(cfg, attn, h)
    with span("kda.recur"):
        o = kda_prefill(q, k, v, g, beta, state)
    return _kda_out(cfg, attn, o, h)


def _kda_decode(cfg: DeepseekV3Config, attn: KimiDeltaAttention,
                h: torch.Tensor, state: torch.Tensor, tail: torch.Tensor
                ) -> torch.Tensor:
    """One position h (B, 1, D) after the state and the tail, both updated
    in place."""
    b, n = h.shape[0], cfg.kda_dim
    window = torch.cat([tail, torch.cat([F.linear(h, proj.weight) for proj, _
                                         in _kda_parts(attn)], -1)], 1)
    tail.copy_(window[:, 1:])
    q, k, v = (_short_conv(window[..., i * n:(i + 1) * n], conv.weight).view(
        b, 1, cfg.kda_num_heads, cfg.kda_head_dim)
        for i, (_, conv) in enumerate(_kda_parts(attn)))
    g, beta = _kda_gates(cfg, attn, h)
    with span("kda.recur"):
        o = kda_decode(q, k, v, g, beta, state)
    return _kda_out(cfg, attn, o, h)


def _layer(cfg: DeepseekV3Config, layer: DeepseekV3DecoderLayer, index: int,
           x: torch.Tensor, attend: Callable, tap: Tap) -> torch.Tensor:
    """The pre-norm block: x + attention, then x + MLP or MoE."""
    name = "kda.attend" if cfg.is_kda(index) else "mla.attend"
    with span(name):
        x = x + attend(layer.self_attn, layer.input_layernorm(x))
    h = layer.post_attention_layernorm(x)
    if isinstance(layer.mlp, DeepseekV3MoE):
        return x + _moe(cfg, layer.mlp, h, index, tap)
    return x + _swiglu(layer.mlp, h)


def _head(model: DeepseekV3ForCausalLM, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the head in the model's type; float32 logits."""
    x = model.model.norm(x)
    return F.linear(x, model.lm_head.weight).float()


def _causal(s: int, device) -> torch.Tensor:
    pos = torch.arange(s, device=device)
    return torch.where(pos[None, :] <= pos[:, None], 0.0, float("-inf"))


def _prefill_layers(model: DeepseekV3ForCausalLM, cfg: DeepseekV3Config,
                    x: torch.Tensor, state: Optional["DeepseekV3DecodeState"],
                    tap: Tap) -> torch.Tensor:
    """Every layer over all S positions of x (B, S, D) under the causal
    mask, attending to the fresh latent rows (MLA) or running the
    recurrence from a zero state (KDA); with `state`, cache rows [0, S) are
    written (in the cache's type), and each KDA layer's final S and
    convolution tail."""
    b, s = x.shape[:2]
    cos, sin = rope_tables(cfg, torch.arange(s, device=x.device))
    mask = _causal(s, x.device)
    for li, layer in enumerate(model.model.layers):
        slot = cfg.slot(li)
        if cfg.is_kda(li):
            def attend(attn, h, slot=slot):
                if state is None:
                    kda = torch.empty((b, cfg.kda_num_heads, cfg.kda_head_dim,
                                       cfg.kda_head_dim), device=h.device)
                    return _kda_prefill(cfg, attn, h, kda, None)
                return _kda_prefill(cfg, attn, h, state.kda[slot],
                                    state.conv[slot])
        else:
            def attend(attn, h, slot=slot):
                q_nope, q_pe, latent = _mla_inputs(cfg, attn, h, cos, sin)
                if state is not None:
                    state.latent[slot, :, :s] = latent
                return _mla_decompressed(cfg, attn, q_nope, q_pe, latent,
                                         mask)
        x = _layer(cfg, layer, li, x, attend, tap)
    return x


# ---------------------------------------------------------------------------
# latent-cached incremental decoding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeepseekV3DecodeState:
    """latent (MLA layers, B, L, kv_lora_rank + qk_rope_head_dim): [c |
    k_pe] a token, in the cache type; w_k / w_v: each MLA layer's absorbed
    kv_b_proj halves in float32, taken once a generation; kda (KDA layers,
    B, H, d, d) float32: each KDA layer's state S; conv (KDA layers, B,
    K - 1, 3·H·d): its last K - 1 rows of q, k and v before the
    convolution, in the model's type. A layer's row is `cfg.slot(layer)`."""

    latent: torch.Tensor
    w_k: list
    w_v: list
    kda: Optional[torch.Tensor] = None
    conv: Optional[torch.Tensor] = None


def init_deepseek_state(model: DeepseekV3ForCausalLM, cfg: DeepseekV3Config,
                        batch: int, max_length: int, dtype=None, device=None
                        ) -> DeepseekV3DecodeState:
    """A zero latent cache (the model's type unless `dtype`, float32 or
    bfloat16; on the model's device unless `device`), the absorbed weights,
    and the KDA layers' states and tails (zeros; each prefill writes them
    whole)."""
    dtype = dtype or model.lm_head.weight.dtype
    device = device or model.lm_head.weight.device
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the latent cache holds float32 or bfloat16, not "
                         f"{dtype}")
    mla = cfg.mla_layers
    latent = torch.zeros((len(mla), batch, max_length, cfg.latent_dim),
                         dtype=dtype, device=device)
    halves = [absorbed_weights(cfg, model.model.layers[li].self_attn)
              for li in mla]
    state = DeepseekV3DecodeState(latent, [k for k, _ in halves],
                                  [v for _, v in halves])
    if cfg.kda_layers:
        n, d = len(cfg.kda_layers), cfg.kda_head_dim
        state.kda = torch.zeros((n, batch, cfg.kda_num_heads, d, d),
                                device=device)
        state.conv = torch.zeros((n, batch, cfg.kda_conv_size - 1,
                                  3 * cfg.kda_dim), device=device,
                                 dtype=model.lm_head.weight.dtype)
    return state


@torch.no_grad()
def deepseek_v3_prefill(model: DeepseekV3ForCausalLM, cfg: DeepseekV3Config,
                        state: DeepseekV3DecodeState, x: torch.Tensor, *,
                        tap: Tap = None
                        ) -> Tuple[torch.Tensor, DeepseekV3DecodeState]:
    """The whole prompt x (B, P, D) in one forward -> (last-position logits
    (B, vocab) float32, the state with cache rows [0, P) written)."""
    x = _prefill_layers(model, cfg, x.to(model.lm_head.weight.dtype), state,
                        tap)
    return _head(model, x[:, -1]), state


@torch.no_grad()
def deepseek_v3_decode_step(model: DeepseekV3ForCausalLM,
                            cfg: DeepseekV3Config,
                            state: DeepseekV3DecodeState, x: torch.Tensor,
                            pos, *, tap: Tap = None
                            ) -> Tuple[torch.Tensor, DeepseekV3DecodeState]:
    """One step: x (B, D) input embedding at cache position `pos` (a 0-d
    int64 tensor on x's device, or an int) -> (logits (B, vocab) float32,
    the state with row `pos` written and each KDA layer's state and tail
    advanced in place), the attention absorbed over every cache row with
    the rows above `pos` masked. Nothing reads `pos` on the host, so one
    capture serves every position."""
    if not torch.is_tensor(pos):
        pos = torch.full((), pos, dtype=torch.int64, device=x.device)
    at = pos.view(1)
    x = x.to(model.lm_head.weight.dtype)[:, None]
    cos, sin = rope_tables(cfg, at)
    rows = torch.arange(state.latent.shape[2], device=x.device)
    mask = torch.where(rows <= pos, 0.0, float("-inf"))
    for li, layer in enumerate(model.model.layers):
        slot = cfg.slot(li)
        if cfg.is_kda(li):
            def attend(attn, h, slot=slot):
                return _kda_decode(cfg, attn, h, state.kda[slot],
                                   state.conv[slot])
        else:
            def attend(attn, h, slot=slot):
                q_nope, q_pe, latent = _mla_inputs(cfg, attn, h, cos, sin)
                state.latent[slot].index_copy_(
                    1, at, latent.to(state.latent.dtype))
                return _mla_absorbed(cfg, attn, q_nope, q_pe,
                                     state.latent[slot], state.w_k[slot],
                                     state.w_v[slot], mask)
        x = _layer(cfg, layer, li, x, attend, tap)
    return _head(model, x[:, 0]), state


deepseek_v3_decode_step.eager_steps = 0
deepseek_v3_decode_step.captures = 0
deepseek_v3_decode_step.replays = 0


def _addresses(model: DeepseekV3ForCausalLM) -> Tuple[int, ...]:
    """Where every tensor a captured step reads in place lies: the
    parameters, the buffers and the stacked experts."""
    out = []
    for m in model.modules():
        tensors = itertools.chain(m._parameters.values(), m._buffers.values())
        if isinstance(m, DeepseekV3MoE):
            tensors = itertools.chain(tensors, (getattr(m, attr)
                                                for _, attr in _STACKED))
        out.extend(t.data_ptr() for t in tensors if t is not None)
    return tuple(out)


class DecodeGraph:
    """The decode step of one batch shape in a CUDA graph: static buffers
    for the input embedding, the position and the decode state (latent
    cache, absorbed weights, KDA states and tails), and the graph's own
    outputs, the logits and each MoE layer's top-k indices. `key` is
    (batch, cache rows, cache type, device).

    `begin` refreshes the absorbed weights for a generate call, whose
    prefill then writes cache rows [0, P) and every KDA state and tail
    whole; rows left by an earlier call lie above the position and are
    masked. `step` runs the first step of the
    graph's life eagerly (kernels loaded, the allocator and #14's
    statistics allocated), captures at the second, and from then on copies
    the embedding and the position in and replays. The weights are read at
    their addresses: an in-place update is seen by the next replay, and a
    call's first step drops the graph when a tensor has moved
    (`load_state_dict(..., assign=True)`, `p.data = ...`, a new
    `nn.Parameter`) and captures again."""

    def __init__(self, key, model: DeepseekV3ForCausalLM,
                 cfg: DeepseekV3Config):
        batch, length, dtype, device = key
        self.key = key
        # normal tensors, written in place under inference mode or not
        with torch.inference_mode(False):
            self.state = init_deepseek_state(model, cfg, batch, length,
                                             dtype=dtype, device=device)
            self.x = torch.zeros((batch, cfg.hidden_size), device=device,
                                 dtype=model.lm_head.weight.dtype)
            self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.warm = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.routes: list = []         # (layer, (B, 1, k) indices)
        self.launches: list = []       # the step's, counted at each replay
        self.addresses: Tuple[int, ...] = ()     # the model's, at capture
        self.fresh = False             # a call whose first step is to come

    def begin(self, model: DeepseekV3ForCausalLM, cfg: DeepseekV3Config
              ) -> DeepseekV3DecodeState:
        for slot, li in enumerate(cfg.mla_layers):
            w_k, w_v = absorbed_weights(cfg, model.model.layers[li].self_attn)
            self.state.w_k[slot].copy_(w_k)
            self.state.w_v[slot].copy_(w_v)
        self.fresh = True
        return self.state

    def drop_if_moved(self, model: DeepseekV3ForCausalLM) -> None:
        """Drop the graph if a tensor it reads has moved since capture. A
        call's first step runs it, not `begin`: the walk over Moonlight's
        ~5,400 tensors (15-21 ms of the host of an H100 machine) then
        overlaps the prefill's device work."""
        if self.graph is not None and self.addresses != _addresses(model):
            self.graph = None

    def step(self, model: DeepseekV3ForCausalLM, cfg: DeepseekV3Config,
             x: torch.Tensor, pos: int, tap: Tap) -> torch.Tensor:
        self.x.copy_(x)
        self.pos.fill_(pos)
        if not self.warm:
            self.warm = True
            deepseek_v3_decode_step.eager_steps += 1
            return deepseek_v3_decode_step(model, cfg, self.state, self.x,
                                           self.pos, tap=tap)[0]
        if self.fresh:
            self.fresh = False
            self.drop_if_moved(model)
        if self.graph is None:
            self._capture(model, cfg)
        self.graph.replay()
        replayed(self.launches)
        deepseek_v3_decode_step.replays += 1
        if tap is not None:
            for layer, idx in self.routes:
                tap("route", layer, idx)
        return self.logits

    def _capture(self, model: DeepseekV3ForCausalLM,
                 cfg: DeepseekV3Config) -> None:
        """Record the step (which runs nothing) and where the model's
        tensors lie."""
        routes = []
        graph = torch.cuda.CUDAGraph()
        with capturing() as launches, torch.cuda.graph(graph):
            logits = deepseek_v3_decode_step(
                model, cfg, self.state, self.x, self.pos,
                tap=lambda kind, layer, t: routes.append((layer, t)))[0]
        deepseek_v3_decode_step.captures += 1
        self.graph, self.logits, self.routes = graph, logits, routes
        self.launches = launches
        self.addresses = _addresses(model)


@torch.no_grad()
def deepseek_v3_generate(model: DeepseekV3ForCausalLM, cfg: DeepseekV3Config,
                         inputs_embeds: torch.Tensor, *, eos_id: int,
                         pad_id: int, max_new_tokens: int,
                         do_sample: bool = False, temperature: float = 1.0,
                         top_p: float = 1.0, cache_dtype=None,
                         generator: Optional[torch.Generator] = None,
                         tap: Tap = None) -> torch.Tensor:
    """Continuations of an embedded prompt (B, P, D) -> (B, max_new_tokens)
    ids, `pad_id` after EOS, through `generation.decode_loop` (the loop
    `llama_generate` runs too): one prefill, then max_new_tokens - 1 decode
    steps whatever EOS does. The cache holds P + max_new_tokens rows. On a
    CUDA device the steps replay the model's `DecodeGraph`. `tap` also
    receives each position's logits and token (`decode_loop`)."""
    dev = inputs_embeds.device
    batch, prompt_len, _ = inputs_embeds.shape
    length = prompt_len + max_new_tokens
    dtype = cache_dtype or model.lm_head.weight.dtype
    if dev.type == "cuda":
        key = (batch, length, dtype, dev)
        if model._decode_graph is None or model._decode_graph.key != key:
            model._decode_graph = None      # its cache and pool freed first
            model._decode_graph = DecodeGraph(key, model, cfg)
        graph = model._decode_graph
        state = graph.begin(model, cfg)

        def run(x, pos):
            return graph.step(model, cfg, x, pos, tap)
    else:
        state = init_deepseek_state(model, cfg, batch, length, dtype=dtype,
                                    device=dev)

        def run(x, pos):
            deepseek_v3_decode_step.eager_steps += 1
            return deepseek_v3_decode_step(model, cfg, state, x, pos,
                                           tap=tap)[0]
    if generator is None and do_sample:
        generator = torch.Generator(device=dev).manual_seed(0)
    table = model.model.embed_tokens.weight

    def prefill():
        return deepseek_v3_prefill(model, cfg, state, inputs_embeds,
                                   tap=tap)[0]

    def step(x, i):
        return run(x, prompt_len + i - 1)

    def sample(logits):
        return sample_logits(logits, do_sample=do_sample,
                             temperature=temperature, top_k=0, top_p=top_p,
                             generator=generator)

    return decode_loop(prefill, step, lambda tok: table[tok],
                       max_new_tokens=max_new_tokens, eos_id=eos_id,
                       pad_id=pad_id, sample=sample, tap=tap)
