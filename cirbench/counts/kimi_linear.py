"""Model FLOPs of the LLaVA captioner with Kimi-Linear's LM at the share of
the experts the configuration holds, and the bytes and operations of the
KDA recurrence kernel (#15), from the shapes alone (two FLOPs a
multiply-add). `cfg` is the configuration file: Kimi-Linear's keys at the
top level, KDA's under `linear_attn_config`, the tower under `vision`."""

from __future__ import annotations

from typing import Set, Tuple

from cirbench.counts.model import attention_pairs
from cirbench.counts.moonlight import tower
from cirbench.counts.peaks import bound_s

F32 = 4


def kda_shape(cfg: dict) -> Tuple[int, int, int]:
    """(heads, head size, convolution width) of the KDA layers."""
    lin = cfg["linear_attn_config"]
    return lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]


def kda_layers(cfg: dict) -> Set[int]:
    """The KDA layers, 0-based (the file counts from 1)."""
    return {i - 1 for i in cfg["linear_attn_config"]["kda_layers"]}


def recurrence_flops(tokens: int, heads: int, d: int) -> int:
    """#15 a head and token, per element of the d x d state: the decay (1),
    Sᵀk (2), the rank-1 update (2) and Sᵀq (2)."""
    return 7 * tokens * heads * d * d


def kda_bytes(rows: int, tokens: int, heads: int, d: int,
              state_read: bool) -> int:
    """#15 over `tokens` tokens of `rows` sequences: the float32 state read
    once (a decode step; a prefill starts from zero) and written once; q,
    k, g, v and β read and o written, float32."""
    state = rows * heads * d * d * F32
    tokens_io = rows * tokens * heads * (5 * d + 1) * F32
    return state * (2 if state_read else 1) + tokens_io


def kda_decode_s(rows: int, heads: int, d: int) -> float:
    """The least time of one decode launch: the larger of its bytes at
    3.35 TB/s and its FLOPs at 989 TFLOP/s, whatever the kernel's tiling."""
    return bound_s(kda_bytes(rows, 1, heads, d, True),
                   recurrence_flops(rows, heads, d), "bfloat16")


def kda_prefill_s(rows: int, tokens: int, heads: int, d: int) -> float:
    """The least time of one prefill launch over `tokens` prompt tokens."""
    return bound_s(kda_bytes(rows, tokens, heads, d, False),
                   recurrence_flops(rows * tokens, heads, d), "bfloat16")


def _kda_proj_macs(cfg: dict) -> int:
    """Multiply-adds a token of a KDA layer outside the recurrence: q, k,
    v, the two low-rank gates, β, o, and the width-K convolutions."""
    d = cfg["hidden_size"]
    heads, hd, conv = kda_shape(cfg)
    n = heads * hd
    return (3 * d * n + 2 * (d * hd + hd * n) + d * heads + n * d
            + 3 * n * conv)


def _heads(cfg: dict):
    return (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])


def _mlp_macs(cfg: dict, layer: int) -> float:
    """Multiply-adds a token of layer `layer`'s MLP or MoE block: the
    router over every published expert, the routed experts held here (k
    times the held share of the router's width, on average) and the
    shared ones."""
    d = cfg["hidden_size"]
    if layer < cfg["first_k_dense_replace"]:
        return 3 * d * cfg["intermediate_size"]
    routed = cfg.get("published", {}).get("num_experts", cfg["num_experts"])
    held = cfg["num_experts_per_token"] * cfg["num_experts"] / routed
    return (d * routed + 3 * d * cfg["moe_intermediate_size"]
            * (held + cfg["num_shared_experts"]))


def prefill(rows: int, prompt: int, cfg: dict) -> float:
    """Every layer over `prompt` positions of `rows` rows: KDA's
    projections and recurrence, or MLA decompressed (causal scores over
    nope + rope and values over v); the MLP; the head at the last
    position."""
    d = cfg["hidden_size"]
    h, nope, rope, v, r = _heads(cfg)
    heads, hd, _ = kda_shape(cfg)
    kda = kda_layers(cfg)
    mla_proj = (d * h * (nope + rope) + d * (r + rope) + r * h * (nope + v)
                + h * v * d)
    macs = 0.0
    for i in range(cfg["num_hidden_layers"]):
        macs += rows * prompt * _mlp_macs(cfg, i)
        if i in kda:
            macs += rows * prompt * _kda_proj_macs(cfg)
            macs += recurrence_flops(rows * prompt, heads, hd) / 2
        else:
            macs += rows * prompt * mla_proj
            macs += rows * attention_pairs(prompt, True) * h * (nope + rope + v)
    return 2.0 * (macs + rows * d * cfg["vocab_size"])


def decode(rows: int, prompt: int, steps: int, cfg: dict) -> float:
    """`steps` decode steps after a `prompt`-long prefill: KDA's
    projections and one recurrence step, or MLA absorbed (q, kv_a,
    q_nope·W_k, scores over the r + rope latent and values over r for
    every cached row, ctx·W_v, o); the MLP; the head at each step."""
    d = cfg["hidden_size"]
    h, nope, rope, v, r = _heads(cfg)
    heads, hd, _ = kda_shape(cfg)
    kda = kda_layers(cfg)
    mla_proj = (d * h * (nope + rope) + d * (r + rope) + h * nope * r
                + h * r * v + h * v * d)
    seen = sum(prompt + i for i in range(1, steps + 1))   # rows attended
    macs = 0.0
    for i in range(cfg["num_hidden_layers"]):
        macs += rows * steps * _mlp_macs(cfg, i)
        if i in kda:
            macs += rows * steps * _kda_proj_macs(cfg)
            macs += recurrence_flops(rows * steps, heads, hd) / 2
        else:
            macs += rows * steps * mla_proj + rows * seen * h * (r + rope + r)
    return 2.0 * (macs + rows * steps * d * cfg["vocab_size"])


def caption_batch(images: int, prompt: int, new_tokens: int, cfg: dict
                  ) -> float:
    """One `caption` call: the tower and projector, the prefill and
    new_tokens - 1 decode steps."""
    return (tower(images, cfg["vision"], cfg["hidden_size"])
            + prefill(images, prompt, cfg)
            + decode(images, prompt, new_tokens - 1, cfg))
