"""Model FLOPs of the timed work, from the shapes (two per multiply-add).
Attention counts the score pairs the mask keeps; a backward pass counts
twice its forward's products (input and weight gradients)."""

from __future__ import annotations


def attention_pairs(s: int, causal: bool) -> int:
    return s * (s + 1) // 2 if causal else s * s


def transformer_fwd(tokens: int, seqs: int, s: int, width: int,
                    layers: int, mlp: int, causal: bool, kv_tokens: int = 0,
                    kv_width: int = 0, cross_layers: int = 0,
                    cross_rows: int = 0) -> float:
    """A stack of pre- or post-LN blocks over `tokens` = seqs * s rows:
    qkv, out projection and the two MLP matrices, the score and value
    products; optionally `cross_layers` cross-attentions from `cross_rows`
    rows per sequence to `kv_tokens` tokens of width `kv_width`."""
    dense = 2 * tokens * (4 * width * width + 2 * width * mlp)
    attn = 2 * 2 * seqs * attention_pairs(s, causal) * width
    per_layer = dense + attn
    cross = 0.0
    if cross_layers:
        q_rows = seqs * cross_rows
        cross = (2 * q_rows * 2 * width * width            # q and out
                 + 2 * seqs * kv_tokens * 2 * kv_width * width  # k and v
                 + 2 * 2 * q_rows * kv_tokens * width)     # scores, values
    return layers * per_layer + cross_layers * cross


def clip_text_step(batch: int, context: int, width: int, layers: int,
                   embed: int, bank_rows: int, dim: int) -> float:
    """clip4cir's stage-2 step: the text tower forward and backward (every
    text leaf trains), the projection of the pooled rows, the bank logits
    once and the query gradient through them."""
    fwd = transformer_fwd(batch * context, batch, context, width, layers,
                          4 * width, causal=True)
    fwd += 2 * batch * width * embed
    return 3 * fwd + 2 * 2 * batch * bank_rows * dim


def blip2_bank_features(images: int, vision: dict, qformer: dict,
                        text_tokens: int, embed: int) -> float:
    """blip24cir's caption-aware bank encode of `images` (what the bank
    extractors call): the patch matmul and the EVA blocks; the fusion pass
    of (queries + text) with a cross-attention from the query rows to the
    image tokens every `cross_attention_freq` layers; the query-only read;
    `vision_proj` of the query rows."""
    tokens = (vision["image_size"] // vision["patch_size"]) ** 2 + 1
    width = vision["width"]
    mlp = int(width * vision["mlp_ratio"])
    patch_in = 3 * vision["patch_size"] ** 2
    vit = 2 * images * (tokens - 1) * patch_in * width
    vit += transformer_fwd(images * tokens, images, tokens, width,
                           vision["layers"], mlp, causal=False)
    hidden, nq = qformer["hidden_size"], qformer["num_query_tokens"]
    layers, inter = qformer["num_layers"], qformer["intermediate_size"]
    cross = -(-layers // qformer["cross_attention_freq"])
    q = 0.0
    for s in (nq + text_tokens, nq):
        q += transformer_fwd(images * s, images, s, hidden, layers, inter,
                             causal=False, kv_tokens=tokens, kv_width=width,
                             cross_layers=cross, cross_rows=nq)
    return vit + q + 2 * images * nq * hidden * embed
