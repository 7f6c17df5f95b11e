"""clip4cir's stage-2 step in plain PyTorch, from OpenAI CLIP's published
text transformer (`clip/model.py`) and clip4cir's element-wise-sum
combiner with its full-bank InfoNCE (`clip4cir/models.py`).

Weights arrive under OpenAI CLIP's state-dict names. Text: token plus
position embeddings, pre-LN blocks (causal attention, QuickGELU MLP, LN eps
1e-5), the final LN, the state at the `<|endoftext|>` position (the largest
id) times `text_projection`. Query: normalize(refer + text). Loss: the mean
cross-entropy of query . bank / tau against the target row.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from cirbench.reference.common import Precision, l2_normalize, layer_norm


def encode_text(w: Dict[str, torch.Tensor], ids: torch.Tensor, layers: int,
                heads: int, prec: Precision) -> torch.Tensor:
    b, n = ids.shape
    x = w["token_embedding.weight"][ids] + w["positional_embedding"][:n]
    mask = torch.full((n, n), float("-inf"), device=ids.device).triu(1)
    for i in range(layers):
        p = f"transformer.resblocks.{i}."
        h = layer_norm(x, w[p + "ln_1.weight"], w[p + "ln_1.bias"], 1e-5)
        qkv = prec.linear(h, w[p + "attn.in_proj_weight"],
                          w[p + "attn.in_proj_bias"])
        width = qkv.shape[-1] // 3
        hd = width // heads
        q, k, v = (t.reshape(b, n, heads, hd).transpose(1, 2)
                   for t in qkv.split(width, dim=-1))
        logits = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(hd) + mask
        att = prec.mm(torch.softmax(logits, dim=-1), v)
        att = att.transpose(1, 2).reshape(b, n, width)
        x = x + prec.linear(att, w[p + "attn.out_proj.weight"],
                            w[p + "attn.out_proj.bias"])
        h = layer_norm(x, w[p + "ln_2.weight"], w[p + "ln_2.bias"], 1e-5)
        h = prec.linear(h, w[p + "mlp.c_fc.weight"], w[p + "mlp.c_fc.bias"])
        h = h * torch.sigmoid(1.702 * h)
        x = x + prec.linear(h, w[p + "mlp.c_proj.weight"],
                            w[p + "mlp.c_proj.bias"])
    x = layer_norm(x, w["ln_final.weight"], w["ln_final.bias"], 1e-5)
    pooled = x[torch.arange(b, device=ids.device), ids.argmax(dim=-1)]
    return prec.mm(pooled, w["text_projection"])


def stage2_loss(w: Dict[str, torch.Tensor], ids: torch.Tensor,
                refer: torch.Tensor, bank: torch.Tensor, labels: torch.Tensor,
                cfg: dict, prec: Precision) -> torch.Tensor:
    text = encode_text(w, ids, cfg["transformer_layers"],
                       cfg["transformer_heads"], prec)
    query = l2_normalize(refer.float() + text)
    logits = query @ bank.float().t() / cfg["tau"]
    return torch.nn.functional.cross_entropy(logits, labels)


def trainable(name: str) -> bool:
    """The text side trains; the image tower and `logit_scale` do not."""
    return not name.startswith("visual.") and name != "logit_scale"


def tokenizer(cfg: dict):
    from cirbench.assets import synthetic_merges
    from cirbench.reference.bpe import ReferenceBpe

    return ReferenceBpe(synthetic_merges())


def text_inputs(tok, captions, cfg: dict, device) -> torch.Tensor:
    return torch.from_numpy(tok.tokenize(captions, cfg["context_length"])).to(
        device)


def alter_token(ids: torch.Tensor) -> torch.Tensor:
    """A fault: the first caption token of every row replaced by another."""
    ids = ids.clone()
    ids[:, 1] = torch.where(ids[:, 1] == 300, 301, 300)
    return ids


#: the batch key the refer rows are gathered by
REFER_KEY = "refer_image_id"
