"""The LLaVA captioner with Kimi-Linear-48B-A3B as its language model, in
plain PyTorch: LLaVA-v1's CLIP ViT-L/14 tower and linear projector (as in
`cirbench/reference/moonlight.py`, whose pieces it takes), and Kimi-Linear's
decoder (the Kimi Linear technical report, arXiv 2510.26692; HF
`modeling_kimi.py`; fla's `KimiDeltaAttention`): 27 layers, Kimi Delta
Attention (KDA) in the layers of `linear_attn_config.kda_layers` and latent
attention (MLA) in the others, a dense SwiGLU in the first
`first_k_dense_replace` layers and a mixture of experts after them.

KDA, per head (d = head_dim), for the token t with input x:
  q, k, v = SiLU(causal depthwise conv(W_{q,k,v} x)), the convolution of
  width `short_conv_kernel_size` with no bias; q and k L2-normalised per
  head (Σ x² + 1e-6), q scaled by d^-½; the decay per channel
  α = exp(−exp(A_log[h]) · softplus(f_proj(x) + dt_bias)), f_proj two
  factors; β = sigmoid(b_proj(x)) a head;
      S_t = Diag(α) S_{t−1};  S_t = S_t + β k (v − S_tᵀ k)ᵀ;  o_t = S_tᵀ q
  from S_0 = 0; out = o_proj(RMSNorm(o) · o_norm ⊙ sigmoid(g_proj(x))), the
  norm over each head's d, g_proj two factors.

Weights arrive one at a time from `get(name)` under the program's names
(HF LLaVA's `model.vision_tower.*`, `model.mm_projector.*`, and the LM's
`model.*`, `lm_head.weight`), and are widened to float32 as each layer
needs them. Every projection goes through `Precision.mm`.

Departures from the published modeling code:
  - float32 everywhere (the checkpoint computes in bf16, with the state in
    float32): a teacher-forced forward with no cache and no kernels;
  - KDA is the token recurrence itself, one token after another (the
    published kernels run the chunked WY form, equal in exact arithmetic);
    `recurrence(..., state_round="bf16")` rounds S to bfloat16 after every
    token (the control: a state held below the float32 the configuration
    states);
  - MLA is the decompressed form of every head, causal, with its 64 rope
    dimensions not rotated (`mla_use_nope`);
  - the MoE: the router scores every published expert (`published.
    num_experts` when the file holds a share) and takes its own top-k of
    score + e_score_correction_bias; the routed sum runs over the experts
    held (`num_experts` of them from `first_expert_held` on; every expert
    with `uncut`), each chosen expert weighted by its unbiased score over
    the sum of the k chosen, times routed_scaling_factor; then the shared
    expert in full. Where a program's choice is given and its set differs,
    the route counts as flipped and the layer goes on with the program's
    experts, as in `moonlight.py`. The routed experts' weights are read as
    `experts.{e − first_expert_held}`, the program's names;
  - the routed sum is accumulated with `index_add_` over each expert's
    rows, in float32.
It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cirbench.reference.common import Precision, bf16_round
from cirbench.reference.moonlight import (Get, image_embeds, mlp,
                                          prompt_halves, rms_norm)

__all__ = ["caption_logits", "decoder", "kda", "kda_inputs", "mla_nope",
           "moe", "prompt_halves", "recurrence"]

NORM_EPS = 1e-6


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(x.pow(2).sum(-1, keepdim=True) + NORM_EPS)


def kda_inputs(get: Get, p: str, x: torch.Tensor, cfg: dict,
               prec: Precision) -> Tuple[torch.Tensor, ...]:
    """q, k, v (B, S, H, d) after the convolution and SiLU (q and k not yet
    normalised), the log decay g (B, S, H, d) and β (B, S, H) of x."""
    b, s, _ = x.shape
    lin = cfg["linear_attn_config"]
    heads, d = lin["num_heads"], lin["head_dim"]
    n = heads * d
    w = lambda name: get(p + name).float()  # noqa: E731

    def branch(t: str) -> torch.Tensor:
        y = prec.linear(x, w(f"{t}_proj.weight")).transpose(1, 2)
        kernel = w(f"{t}_conv1d.weight")
        y = F.conv1d(y, kernel, padding=kernel.shape[-1] - 1, groups=n)
        return F.silu(y[..., :s]).transpose(1, 2).reshape(b, s, heads, d)

    f = prec.linear(prec.linear(x, w("f_proj.0.weight")), w("f_proj.1.weight"))
    g = (-torch.exp(w("A_log"))[:, None]
         * F.softplus(f + w("dt_bias")).view(b, s, heads, d))
    beta = torch.sigmoid(prec.linear(x, w("b_proj.weight")))
    return branch("q"), branch("k"), branch("v"), g, beta


def recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               g: torch.Tensor, beta: torch.Tensor,
               state: Optional[torch.Tensor] = None,
               state_round: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gated delta rule token by token in float32 from `state` (zeros
    if None): q and k L2-normalised, q scaled by d^-½; `state_round`
    "bf16" rounds S after every token. Returns o (B, T, H, d) and the
    final S (B, H, d, d)."""
    b, t, heads, d = q.shape
    q = l2_normalize(q.float()) * d ** -0.5
    k = l2_normalize(k.float())
    decay = torch.exp(g.float())
    s = (q.new_zeros((b, heads, d, d)) if state is None
         else state.float().clone())
    out = []
    for i in range(t):
        s = decay[:, i, :, :, None] * s
        ki = k[:, i]
        err = v[:, i].float() - torch.einsum("bhkv,bhk->bhv", s, ki)
        s = s + beta[:, i, :, None, None].float() * ki[..., None] * err[:, :, None]
        if state_round == "bf16":
            s = bf16_round(s)
        out.append(torch.einsum("bhkv,bhk->bhv", s, q[:, i]))
    return torch.stack(out, 1), s


def kda(get: Get, p: str, x: torch.Tensor, cfg: dict,
        prec: Precision) -> torch.Tensor:
    """Kimi Delta Attention over every position of x (B, S, D)."""
    b, s, _ = x.shape
    o, _ = recurrence(*kda_inputs(get, p, x, cfg, prec))
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + cfg["rms_norm_eps"])
    gate = prec.linear(prec.linear(x, get(p + "g_proj.0.weight").float()),
                       get(p + "g_proj.1.weight").float())
    o = o * get(p + "o_norm.weight").float() * torch.sigmoid(gate).view(o.shape)
    return prec.linear(o.reshape(b, s, -1), get(p + "o_proj.weight").float())


def mla_nope(get: Get, p: str, x: torch.Tensor, cfg: dict,
             prec: Precision) -> torch.Tensor:
    """Multi-head latent attention over every position of x (B, S, D),
    causal, each head's keys and values decompressed from the latent, the
    rope dimensions not rotated."""
    b, s, _ = x.shape
    heads = cfg["num_attention_heads"]
    nope, rd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    w = lambda name: get(p + name).float()  # noqa: E731
    q = prec.linear(x, w("q_proj.weight")).view(b, s, heads, nope + rd)
    c, k_pe = prec.linear(x, w("kv_a_proj_with_mqa.weight")).split([r, rd], -1)
    c = rms_norm(c, w("kv_a_layernorm.weight"), cfg["rms_norm_eps"])
    kv = prec.linear(c, w("kv_b_proj.weight")).view(b, s, heads, nope + vd)
    k_nope, v = kv.split([nope, vd], -1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(b, s, heads, rd)], -1)
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    att = torch.softmax(prec.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1))
                        * (nope + rd) ** -0.5 + mask, dim=-1)
    out = prec.mm(att, v.transpose(1, 2)).transpose(1, 2).reshape(b, s, -1)
    return prec.linear(out, w("o_proj.weight"))


def held_experts(cfg: dict, uncut: bool = False) -> Tuple[int, range]:
    """(the router's width, the experts whose part is computed)."""
    routed = cfg.get("published", {}).get("num_experts", cfg["num_experts"])
    if uncut:
        return routed, range(routed)
    first = cfg.get("first_expert_held", 0)
    return routed, range(first, first + cfg["num_experts"])


def moe(get: Get, p: str, x: torch.Tensor, cfg: dict, prec: Precision,
        chosen: Optional[torch.Tensor], uncut: bool = False
        ) -> Tuple[torch.Tensor, Dict]:
    """The MoE block over x (N, D): the held experts' part of the routed
    sum (every expert's with `uncut`) and the shared expert. `chosen` (N,
    k): the program's experts, or None. Returns the output and {"flips",
    "gap", "own"} as `moonlight.moe` does."""
    k = cfg["num_experts_per_token"]
    routed, held = held_experts(cfg, uncut)
    first = 0 if uncut else held.start
    scores = torch.sigmoid(prec.linear(x, get(p + "gate.weight").float()))
    assert scores.shape[-1] == routed, (scores.shape, routed)
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
        use = chosen.long()
    w = scores.gather(1, use)
    if cfg["moe_renormalize"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in torch.unique(use).tolist():
        if e not in held:
            continue
        rows, slots = torch.nonzero(use == e, as_tuple=True)
        y = mlp(get, f"{p}experts.{e - first}.", x[rows], prec)
        out.index_add_(0, rows, y * w[rows, slots, None])
    out = out + mlp(get, p + "shared_experts.", x, prec)
    return out, {"flips": flips, "gap": gap, "own": own}


def decoder(get: Get, embeds: torch.Tensor, cfg: dict,
            out_positions: Sequence[int], prec: Precision,
            chosen: Optional[List[torch.Tensor]] = None,
            record: Optional[list] = None, uncut: bool = False,
            inputs: Optional[list] = None
            ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """The teacher-forced decoder over embeds (B, S, D) float32 -> (float32
    logits (B, len(out_positions), vocab), routing readings), one layer at
    a time; `chosen`, `record` and the readings as in `moonlight.decoder`.
    `inputs`, a list, receives the first KDA layer's `kda_inputs` (q, k, v,
    g, β of every position)."""
    b, s, d = embeds.shape
    x = embeds.float()
    eps = cfg["rms_norm_eps"]
    kda_layers = {i - 1 for i in cfg["linear_attn_config"]["kda_layers"]}
    stats = {"routes": 0, "flips": 0, "flip_gap": 0.0}
    dense = cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        h = rms_norm(x, get(p + "input_layernorm.weight").float(), eps)
        if i in kda_layers:
            if inputs is not None and not inputs:
                inputs.append(kda_inputs(get, p + "self_attn.", h, cfg, prec))
            x = x + kda(get, p + "self_attn.", h, cfg, prec)
        else:
            x = x + mla_nope(get, p + "self_attn.", h, cfg, prec)
        h = rms_norm(x, get(p + "post_attention_layernorm.weight").float(), eps)
        if i < dense:
            x = x + mlp(get, p + "mlp.", h, prec)
            continue
        mine = None if chosen is None else chosen[i - dense].reshape(b * s, -1)
        y, st = moe(get, p + "mlp.", h.reshape(b * s, d), cfg, prec, mine,
                    uncut)
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
                   record: Optional[list] = None,
                   inputs: Optional[list] = None
                   ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """The captioner's logits over the prompt and a continuation, teacher
    forced, as `moonlight.caption_logits`: (B, T + 1, vocab) at the
    prompt's last position and at each continuation token, and the routing
    readings; `inputs` as in `decoder`."""
    table = get("model.embed_tokens.weight")
    img = image_embeds(get, pixels, cfg["vision"], prec)
    n = img.shape[0]
    embeds = torch.cat([table[pre_ids].float()[None].expand(n, -1, -1), img,
                        table[post_ids].float()[None].expand(n, -1, -1),
                        table[tokens].float()], dim=1)
    prompt = pre_ids.numel() + img.shape[1] + post_ids.numel()
    positions = range(prompt - 1, prompt + tokens.shape[1])
    return decoder(get, embeds, cfg, positions, prec, chosen, record,
                   inputs=inputs)
