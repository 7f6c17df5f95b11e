"""The LLaVA captioner with Moonlight-16B-A3B as its language model, in plain
PyTorch: LLaVA-v1's CLIP ViT-L/14 tower and linear projector (HF
`CLIPVisionModel`, `llava_arch.py`), and the DeepSeek-V3 decoder's full
forward (HF `DeepseekV3ForCausalLM`, transformers' `modeling_deepseek_v3.py`).

Weights arrive one at a time from `get(name)` under the HF LLaVA names
(`model.vision_tower.vision_tower.vision_model.*`, `model.mm_projector.*`,
and the LM's `model.*`, `lm_head.weight`), in the checkpoint's type, and
are widened to float32 as each layer needs them, so that on the card the
reference fits beside the program. Every product goes through
`Precision.mm`: float32 with TF32 off, or float8 for the control.

Departures from the published modeling code:
  - float32 everywhere (the checkpoint computes in bf16): a teacher-forced
    forward with no cache, no batching tricks and no kernels; attention is
    the decompressed form of every head, eager, causal;
  - RoPE as transformers' DeepSeek-V3 applies it with `rope_interleave`
    (the pairs de-interleaved, then rotate_half), tables in float32;
  - routing: the reference takes its own float32 sigmoid scores and its own
    top-k of score + e_score_correction_bias. Where a program's choice is
    given and its set differs, the route counts as flipped, and how wrong
    the program's choice is by the reference's scores is kept: its own
    k-th biased score less the lowest biased score among the program's
    experts. The layer then goes on with the program's experts (weighted
    by the reference's scores), so that one near tie does not spread
    through the later layers;
  - the routed sum is accumulated with `index_add_` over each expert's
    rows, in float32.
It imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cirbench.reference.common import Precision

Get = Callable[[str], torch.Tensor]

TOWER = "model.vision_tower.vision_tower.vision_model."
LN_EPS = 1e-5

# conv_llava_v1 and the captioner's message (LLaVA's conversation.py,
# zscir/captioner_llava.py)
SYSTEM = ("A chat between a curious human and an artificial intelligence "
          "assistant. The assistant gives helpful, detailed, and polite "
          "answers to the human's questions.")
CAPTION = "please briefly describe the {category} in {num_words} words"


def prompt_halves(category: str, num_words: int) -> Tuple[str, str]:
    """The llava_v1 prompt around the image token: (text before, after)."""
    msg = CAPTION.format(category=category, num_words=num_words)
    return SYSTEM + " USER: ", f"\nuser: {msg} ASSISTANT:"


# ---------------------------------------------------------------------------
# the tower and the projector
# ---------------------------------------------------------------------------

def tower(get: Get, pixels: torch.Tensor, vision: dict,
          prec: Precision) -> torch.Tensor:
    """(n, H, W, 3) -> (n, patches, width): the stride-p convolution, CLS
    and positions, pre-LN, `layers + select_layer + 1` blocks (pre-LN,
    QuickGELU), the CLS row dropped."""
    w = lambda name: get(TOWER + name).float()  # noqa: E731
    p, width, heads = vision["patch_size"], vision["width"], vision["heads"]
    x = F.conv2d(pixels.float().permute(0, 3, 1, 2),
                 w("embeddings.patch_embedding.weight"), stride=p)
    x = x.flatten(2).transpose(1, 2)
    n = x.shape[0]
    cls = w("embeddings.class_embedding").expand(n, 1, width)
    x = torch.cat([cls, x], dim=1) + w("embeddings.position_embedding.weight")
    x = F.layer_norm(x, (width,), w("pre_layrnorm.weight"),
                     w("pre_layrnorm.bias"), LN_EPS)
    hd = width // heads
    s = x.shape[1]
    for i in range(vision["layers"] + vision["select_layer"] + 1):
        b = f"encoder.layers.{i}."
        h = F.layer_norm(x, (width,), w(b + "layer_norm1.weight"),
                         w(b + "layer_norm1.bias"), LN_EPS)
        q, k, v = (prec.linear(h, w(f"{b}self_attn.{t}_proj.weight"),
                               w(f"{b}self_attn.{t}_proj.bias")
                               ).view(n, s, heads, hd).transpose(1, 2)
                   for t in "qkv")
        att = torch.softmax(prec.mm(q, k.transpose(-1, -2)) * hd ** -0.5, -1)
        att = prec.mm(att, v).transpose(1, 2).reshape(n, s, width)
        x = x + prec.linear(att, w(b + "self_attn.out_proj.weight"),
                            w(b + "self_attn.out_proj.bias"))
        h = F.layer_norm(x, (width,), w(b + "layer_norm2.weight"),
                         w(b + "layer_norm2.bias"), LN_EPS)
        h = prec.linear(h, w(b + "mlp.fc1.weight"), w(b + "mlp.fc1.bias"))
        h = h * torch.sigmoid(1.702 * h)
        x = x + prec.linear(h, w(b + "mlp.fc2.weight"), w(b + "mlp.fc2.bias"))
    return x[:, 1:]


def image_embeds(get: Get, pixels: torch.Tensor, vision: dict,
                 prec: Precision) -> torch.Tensor:
    """The projected patch features, (n, patches, LM hidden)."""
    return prec.linear(tower(get, pixels, vision, prec),
                       get("model.mm_projector.weight").float(),
                       get("model.mm_projector.bias").float())


# ---------------------------------------------------------------------------
# the DeepSeek-V3 decoder
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def attention(get: Get, p: str, x: torch.Tensor, cfg: dict,
              prec: Precision) -> torch.Tensor:
    """Multi-head latent attention over every position of x (B, S, D),
    causal, each head's keys and values decompressed from the latent."""
    b, s, _ = x.shape
    heads = cfg["num_attention_heads"]
    nope, rd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    w = lambda name: get(p + name).float()  # noqa: E731
    q = prec.linear(x, w("q_proj.weight")).view(b, s, heads, nope + rd)
    q_nope, q_pe = q.split([nope, rd], -1)
    c, k_pe = prec.linear(x, w("kv_a_proj_with_mqa.weight")).split([r, rd], -1)
    c = rms_norm(c, w("kv_a_layernorm.weight"), cfg["rms_norm_eps"])
    kv = prec.linear(c, w("kv_b_proj.weight")).view(b, s, heads, nope + vd)
    k_nope, v = kv.split([nope, vd], -1)
    inv = 1.0 / cfg["rope_theta"] ** (
        torch.arange(0, rd, 2, device=x.device, dtype=torch.float32) / rd)
    freqs = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cat([freqs, freqs], -1).cos(), torch.cat([freqs, freqs],
                                                             -1).sin()
    q_pe = rope(q_pe, cos[:, None], sin[:, None])
    k_pe = rope(k_pe, cos, sin)[:, :, None].expand(b, s, heads, rd)
    qh = torch.cat([q_nope, q_pe], -1).transpose(1, 2)
    kh = torch.cat([k_nope, k_pe], -1).transpose(1, 2)
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    att = torch.softmax(prec.mm(qh, kh.transpose(-1, -2))
                        * (nope + rd) ** -0.5 + mask, dim=-1)
    out = prec.mm(att, v.transpose(1, 2)).transpose(1, 2).reshape(b, s, -1)
    return prec.linear(out, w("o_proj.weight"))


def mlp(get: Get, p: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    gate = prec.linear(x, get(p + "gate_proj.weight").float())
    up = prec.linear(x, get(p + "up_proj.weight").float())
    return prec.linear(F.silu(gate) * up, get(p + "down_proj.weight").float())


def moe(get: Get, p: str, x: torch.Tensor, cfg: dict, prec: Precision,
        chosen: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """The MoE block over x (N, D). `chosen` (N, k): the program's experts,
    or None. Returns the output and {"flips": flipped routes, "gap": the
    largest, over them, of the reference's own k-th biased score less the
    lowest of its biased scores among the program's experts, "own": the
    reference's own choice}."""
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(prec.linear(x, get(p + "gate.weight").float()))
    biased = scores + get(p + "gate.e_score_correction_bias").float()
    top = torch.topk(biased, k, dim=-1)
    own = top.indices
    use, flips, gap = own, 0, 0.0
    if chosen is not None:
        differ = (own.sort(-1).values != chosen.sort(-1).values).any(-1)
        flips = int(differ.sum())
        if flips:
            gaps = (top.values[:, k - 1]
                    - biased.gather(1, chosen.long()).min(-1).values)
            gap = float(gaps[differ].max())
        use = chosen
    w = scores.gather(1, use)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in torch.unique(use).tolist():
        rows, slots = torch.nonzero(use == e, as_tuple=True)
        y = mlp(get, f"{p}experts.{e}.", x[rows], prec)
        out.index_add_(0, rows, y * w[rows, slots, None])
    out = out + mlp(get, p + "shared_experts.", x, prec)
    return out, {"flips": flips, "gap": gap, "own": own}


def decoder(get: Get, embeds: torch.Tensor, cfg: dict, out_positions:
            Sequence[int], prec: Precision,
            chosen: Optional[List[torch.Tensor]] = None,
            record: Optional[list] = None
            ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """The teacher-forced decoder over embeds (B, S, D) float32 -> (float32
    logits (B, len(out_positions), vocab), routing readings). `chosen`: per
    MoE layer the program's (B, S, k) experts; `record`, a list, receives
    the reference's own (B, S, k) choice of each MoE layer. The readings:
    `routes` (B·S a MoE layer), `flips`, `flip_gap` (the largest gap at a
    flip, 0 with none)."""
    b, s, d = embeds.shape
    x = embeds.float()
    eps = cfg["rms_norm_eps"]
    stats = {"routes": 0, "flips": 0, "flip_gap": 0.0}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        h = rms_norm(x, get(p + "input_layernorm.weight").float(), eps)
        x = x + attention(get, p + "self_attn.", h, cfg, prec)
        h = rms_norm(x, get(p + "post_attention_layernorm.weight").float(), eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + mlp(get, p + "mlp.", h, prec)
            continue
        mine = None
        if chosen is not None:
            mine = chosen[i - cfg["first_k_dense_replace"]].reshape(b * s, -1)
        y, st = moe(get, p + "mlp.", h.reshape(b * s, d), cfg, prec, mine)
        x = x + y.view(b, s, d)
        if record is not None:
            record.append(st["own"].view(b, s, -1))
        stats["routes"] += b * s
        stats["flips"] += st["flips"]
        stats["flip_gap"] = max(stats["flip_gap"], st["gap"])
    h = rms_norm(x[:, list(out_positions)], get("model.norm.weight").float(),
                 eps)
    return prec.linear(h, get("lm_head.weight").float()), stats


def caption_logits(get: Get, pixels: torch.Tensor, pre_ids: torch.Tensor,
                   post_ids: torch.Tensor, tokens: torch.Tensor, cfg: dict,
                   prec: Precision,
                   chosen: Optional[List[torch.Tensor]] = None,
                   record: Optional[list] = None
                   ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """The captioner's logits over the prompt and a continuation, teacher
    forced: pixels (B, H, W, 3), the prompt's ids before the image (with
    BOS) and after it, tokens (B, T) the continuation fed after the
    prompt. Returns the logits at the prompt's last position and at each
    continuation token, (B, T + 1, vocab), and the routing readings."""
    table = get("model.embed_tokens.weight")
    img = image_embeds(get, pixels, cfg["vision"], prec)
    n = img.shape[0]
    embeds = torch.cat([table[pre_ids].float()[None].expand(n, -1, -1), img,
                        table[post_ids].float()[None].expand(n, -1, -1),
                        table[tokens].float()], dim=1)
    prompt = pre_ids.numel() + img.shape[1] + post_ids.numel()
    positions = range(prompt - 1, prompt + tokens.shape[1])
    return decoder(get, embeds, cfg, positions, prec, chosen, record)
