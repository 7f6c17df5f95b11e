"""Model FLOPs of the LLaVA captioner with a DeepSeek-V3 LM, and the bytes
and operations of the grouped expert kernel (#14), from the shapes alone
(two FLOPs a multiply-add). `cfg` is the configuration file: HF's
DeepSeek-V3 keys at the top level, the tower under `vision`."""

from __future__ import annotations

from typing import Dict, List

from cirbench.counts.model import attention_pairs, transformer_fwd
from cirbench.counts.peaks import bound_s


def tower(images: int, vision: dict, lm_hidden: int) -> float:
    """LLaVA's tower to its feature tap (`layers + select_layer + 1` blocks
    at 4x MLP) and the projector of the patch rows."""
    patches = (vision["image_size"] // vision["patch_size"]) ** 2
    tokens, width = patches + 1, vision["width"]
    blocks = vision["layers"] + vision["select_layer"] + 1
    flops = 2 * images * patches * 3 * vision["patch_size"] ** 2 * width
    flops += transformer_fwd(images * tokens, images, tokens, width, blocks,
                             4 * width, causal=False)
    return flops + 2 * images * patches * width * lm_hidden


def _mlp_macs(cfg: dict, layer: int) -> int:
    """Multiply-adds a token of layer `layer`'s MLP or MoE block: the
    router, the k routed experts and the shared ones."""
    d = cfg["hidden_size"]
    if layer < cfg["first_k_dense_replace"]:
        return 3 * d * cfg["intermediate_size"]
    width = cfg["moe_intermediate_size"]
    return (d * cfg["n_routed_experts"]
            + 3 * d * width * (cfg["num_experts_per_tok"]
                               + cfg["n_shared_experts"]))


def _heads(cfg: dict):
    return (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"])


def prefill(rows: int, prompt: int, cfg: dict) -> float:
    """Every layer over `prompt` positions of `rows` rows, attention
    decompressed (q, kv_a, kv_b, o; causal scores over 192 dimensions and
    values over 128), and the head at the last position."""
    d = cfg["hidden_size"]
    h, nope, rope, v, r = _heads(cfg)
    proj = d * h * (nope + rope) + d * (r + rope) + r * h * (nope + v) + h * v * d
    attn = attention_pairs(prompt, True) * h * (nope + rope + v)
    macs = sum(rows * prompt * (proj + _mlp_macs(cfg, i)) + rows * attn
               for i in range(cfg["num_hidden_layers"]))
    return 2.0 * (macs + rows * d * cfg["vocab_size"])


def decode(rows: int, prompt: int, steps: int, cfg: dict) -> float:
    """`steps` decode steps after a `prompt`-long prefill, attention
    absorbed: q, kv_a, q_nope·W_k, scores over the r + rope latent and
    values over r for every cached row, ctx·W_v, o; the head at each
    step."""
    d = cfg["hidden_size"]
    h, nope, rope, v, r = _heads(cfg)
    proj = d * h * (nope + rope) + d * (r + rope) + h * nope * r + h * r * v + h * v * d
    per_row = h * (r + rope + r)
    seen = sum(prompt + i for i in range(1, steps + 1))   # rows attended
    layers = cfg["num_hidden_layers"]
    macs = sum(rows * steps * (proj + _mlp_macs(cfg, i)) for i in range(layers))
    macs += layers * rows * seen * per_row
    return 2.0 * (macs + rows * steps * d * cfg["vocab_size"])


def caption_batch(images: int, prompt: int, new_tokens: int, cfg: dict) -> float:
    """One `caption` call: the tower and projector, the prefill and
    new_tokens - 1 decode steps."""
    return (tower(images, cfg["vision"], cfg["hidden_size"])
            + prefill(images, prompt, cfg)
            + decode(images, prompt, new_tokens - 1, cfg))


def moe_expert_bytes(rows: int, experts_hit: int, hidden: int, inter: int) -> int:
    """#14: the weights of the experts that received rows, each row's input
    read, its SwiGLU output written and read, its output written (bf16)."""
    return 2 * (experts_hit * 3 * inter * hidden
                + rows * (hidden + 2 * inter + hidden))


def moe_expert_flops(rows: int, hidden: int, inter: int) -> int:
    """#14: the gate and up products (2·inter wide) and the down product."""
    return 2 * rows * (hidden * 2 * inter + inter * hidden)


def moe_expert_s(stats: Dict[str, List[int]], hidden: int, inter: int) -> float:
    """The least time of #14's launches from its device sums by route
    ({route: [rows, experts hit, launches]}): within a route the launches
    share their shapes, so each route is bound on its sums as a whole."""
    return sum(bound_s(moe_expert_bytes(rows, hit, hidden, inter),
                       moe_expert_flops(rows, hidden, inter), "bfloat16")
               for rows, hit, _ in stats.values())
