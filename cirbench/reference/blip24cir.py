"""blip24cir in plain PyTorch, from LAVIS's published BLIP-2 modules
(`eva_vit.py`, `Qformer.py`, `blip2_qformer_cir_align_prompt.py`) and
BERT's WordPiece tokenizer.

Weights arrive under LAVIS's state-dict names. EVA ViT-g: a 14-pixel patch
convolution, a class token and positions, pre-LN blocks (LN eps 1e-6,
a qkv product whose bias is [q_bias; 0; v_bias], exact GELU), no final LN;
`ln_vision` after it (LAVIS's LayerNorm, eps 1e-5). Q-Former: BERT-base,
post-LN (eps 1e-12), [queries ; text embeddings] under one embeddings LN,
a cross-attention from the query rows to the image tokens in every
`cross_attention_freq`-th layer, the query rows through
`intermediate_query` / `output_query` whenever image tokens are present.

Stage 2 re-reads the text with `Qformer_query` over the cached fused query
states, takes the first text position through `text_proj_q`, and scores
each bank image by its best query: the loss is the mean cross-entropy of
those scores over the learnable `temp`.
"""

from __future__ import annotations

import math
import re
import unicodedata
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cirbench.reference.common import Precision, l2_normalize, layer_norm

#: the batch key the refer rows are gathered by: fused states per triplet
REFER_KEY = "triplet_idx"


# ---- text -------------------------------------------------------------

def pre_caption(caption: str, max_words: int = 50) -> str:
    """LAVIS's `blip_caption` text processor."""
    caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
    caption = re.sub(r"\s{2,}", " ", caption).rstrip("\n").strip(" ")
    return " ".join(caption.split(" ")[:max_words])


class ReferenceWordPiece:
    """BERT's uncased basic tokenizer and greedy longest-match WordPiece;
    BLIP appends `[DEC]` and `[ENC]` to the vocabulary."""

    def __init__(self, vocab: List[str]):
        vocab = list(vocab) + [t for t in ("[DEC]", "[ENC]") if t not in vocab]
        self.ids = {t: i for i, t in enumerate(vocab)}

    @staticmethod
    def basic(text: str) -> List[str]:
        chars = []
        for ch in text:
            if ch in "\t\n\r":
                chars.append(" ")
            elif not (ord(ch) in (0, 0xFFFD)
                      or unicodedata.category(ch) in ("Cc", "Cf")):
                chars.append(ch)
        text = "".join(chars)
        out = []
        for tok in text.lower().split():
            tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                          if unicodedata.category(c) != "Mn")
            word = ""
            for ch in tok:
                cp = ord(ch)
                punct = ((33 <= cp <= 47) or (58 <= cp <= 64)
                         or (91 <= cp <= 96) or (123 <= cp <= 126)
                         or unicodedata.category(ch).startswith("P"))
                if punct:
                    if word:
                        out.append(word)
                    out.append(ch)
                    word = ""
                else:
                    word += ch
            if word:
                out.append(word)
        return out

    def wordpiece(self, word: str) -> List[int]:
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = ("##" if start else "") + word[start:end]
                if piece in self.ids:
                    pieces.append(self.ids[piece])
                    break
                end -= 1
            else:
                return [self.ids["[UNK]"]]
            start = end
        return pieces

    def __call__(self, texts: List[str], max_length: int):
        ids = np.full((len(texts), max_length), self.ids["[PAD]"], np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            row = [p for w in self.basic(text) for p in self.wordpiece(w)]
            row = [self.ids["[CLS]"]] + row[:max_length - 2] + [
                self.ids["[SEP]"]]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask


def tokenizer(cfg: dict):
    from cirbench.assets import synthetic_bert_vocab

    return ReferenceWordPiece(synthetic_bert_vocab(cfg["bert_vocab"]))


def text_inputs(tok, captions, cfg: dict, device):
    ids, mask = tok([pre_caption(c) for c in captions], cfg["max_text_tokens"])
    return (torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device))


def alter_token(inputs):
    """A fault: the first caption token of every row replaced by another."""
    ids, mask = inputs
    ids = ids.clone()
    ids[:, 1] = torch.where(ids[:, 1] == 300, 301, 300)
    return ids, mask


# ---- EVA ViT-g -----------------------------------------------------------

def eva(w: Dict[str, torch.Tensor], images: torch.Tensor, cfg: dict,
        prec: Precision) -> torch.Tensor:
    """(B, H, W, 3) -> (B, 1 + P, width) after ln_vision."""
    v = cfg["vision"]
    p, width, heads = v["patch_size"], v["width"], v["heads"]
    b = images.shape[0]
    cols = F.unfold(images.permute(0, 3, 1, 2).float(), p, stride=p)
    x = prec.linear(cols.transpose(1, 2),
                    w["visual_encoder.patch_embed.proj.weight"].reshape(width, -1),
                    w["visual_encoder.patch_embed.proj.bias"])
    cls = w["visual_encoder.cls_token"].expand(b, 1, width)
    x = torch.cat([cls, x], dim=1) + w["visual_encoder.pos_embed"]
    hd = width // heads
    for i in range(v["layers"]):
        k = f"visual_encoder.blocks.{i}."
        h = layer_norm(x, w[k + "norm1.weight"], w[k + "norm1.bias"], 1e-6)
        bias = torch.cat([w[k + "attn.q_bias"],
                          torch.zeros_like(w[k + "attn.q_bias"]),
                          w[k + "attn.v_bias"]])
        qkv = prec.linear(h, w[k + "attn.qkv.weight"], bias)
        q, kk, vv = (t.reshape(b, -1, heads, hd).transpose(1, 2)
                     for t in qkv.split(width, dim=-1))
        att = torch.softmax(prec.mm(q, kk.transpose(-1, -2)) / math.sqrt(hd),
                            dim=-1)
        att = prec.mm(att, vv).transpose(1, 2).reshape(b, -1, width)
        x = x + prec.linear(att, w[k + "attn.proj.weight"],
                            w[k + "attn.proj.bias"])
        h = layer_norm(x, w[k + "norm2.weight"], w[k + "norm2.bias"], 1e-6)
        h = F.gelu(prec.linear(h, w[k + "mlp.fc1.weight"], w[k + "mlp.fc1.bias"]))
        x = x + prec.linear(h, w[k + "mlp.fc2.weight"], w[k + "mlp.fc2.bias"])
    return layer_norm(x, w["ln_vision.weight"], w["ln_vision.bias"], 1e-5)


# ---- Q-Former -------------------------------------------------------------

def _attention(w, k, x, kv, mask, heads, prec):
    """BERT attention with its output block: LN(x + dense(attend))."""
    b, n, hidden = x.shape
    hd = hidden // heads
    q = prec.linear(x, w[k + "self.query.weight"], w[k + "self.query.bias"])
    key = prec.linear(kv, w[k + "self.key.weight"], w[k + "self.key.bias"])
    val = prec.linear(kv, w[k + "self.value.weight"], w[k + "self.value.bias"])
    q, key, val = (t.reshape(b, -1, heads, hd).transpose(1, 2)
                   for t in (q, key, val))
    logits = prec.mm(q, key.transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        logits = logits + mask
    att = prec.mm(torch.softmax(logits, dim=-1), val)
    att = att.transpose(1, 2).reshape(b, n, hidden)
    out = prec.linear(att, w[k + "output.dense.weight"],
                      w[k + "output.dense.bias"])
    return layer_norm(x + out, w[k + "output.LayerNorm.weight"],
                      w[k + "output.LayerNorm.bias"], 1e-12)


def _ffn(w, inter, outp, x, prec):
    h = F.gelu(prec.linear(x, w[inter + "dense.weight"], w[inter + "dense.bias"]))
    out = prec.linear(h, w[outp + "dense.weight"], w[outp + "dense.bias"])
    return layer_norm(x + out, w[outp + "LayerNorm.weight"],
                      w[outp + "LayerNorm.bias"], 1e-12)


def qformer(w, prefix: str, cfg: dict, queries: torch.Tensor,
            ids: Optional[torch.Tensor] = None,
            mask: Optional[torch.Tensor] = None,
            image: Optional[torch.Tensor] = None,
            prec: Precision = Precision()) -> torch.Tensor:
    q = cfg["qformer"]
    e = prefix + "bert.embeddings."
    nq = queries.shape[1]
    parts = [queries.float()]
    additive = None
    if ids is not None:
        parts.append(w[e + "word_embeddings.weight"][ids]
                     + w[e + "position_embeddings.weight"][:ids.shape[1]])
        full = torch.cat([torch.ones(ids.shape[0], nq, device=ids.device),
                          mask.float()], dim=1)
        additive = ((1.0 - full) * -1e9)[:, None, None, :]
    x = layer_norm(torch.cat(parts, dim=1), w[e + "LayerNorm.weight"],
                   w[e + "LayerNorm.bias"], 1e-12)
    for i in range(q["num_layers"]):
        k = f"{prefix}bert.encoder.layer.{i}."
        x = _attention(w, k + "attention.", x, x, additive, q["num_heads"], prec)
        if image is not None and i % q["cross_attention_freq"] == 0:
            qx = _attention(w, k + "crossattention.", x[:, :nq], image, None,
                            q["num_heads"], prec)
            x = torch.cat([qx, x[:, nq:]], dim=1)
        if image is None:
            x = _ffn(w, k + "intermediate.", k + "output.", x, prec)
        else:
            parts = [_ffn(w, k + "intermediate_query.", k + "output_query.",
                          x[:, :nq], prec)]
            if x.shape[1] > nq:
                parts.append(_ffn(w, k + "intermediate.", k + "output.",
                                  x[:, nq:], prec))
            x = torch.cat(parts, dim=1)
    return x


# ---- the paths ------------------------------------------------------------

def bank_features(w, images, ids, mask, cfg, prec: Precision = Precision()):
    """(fused query states (B, 32, 768), target query features (B, 32,
    256)): the caption-aware bank forms of (image, caption)."""
    image = eva(w, images, cfg, prec)
    queries = w["query_tokens"].expand(images.shape[0], -1, -1)
    fused = qformer(w, "Qformer.", cfg, queries, ids, mask, image, prec)
    target = qformer(w, "Qformer.", cfg, queries, image=image, prec=prec)
    feats = l2_normalize(prec.linear(target, w["vision_proj.weight"],
                                     w["vision_proj.bias"]))
    return fused[:, :queries.shape[1]], feats


def stage2_loss(w, inputs, refer, bank, labels, cfg, prec: Precision):
    ids, mask = inputs
    nq = refer.shape[1]
    hidden = qformer(w, "Qformer_query.", cfg, refer, ids, mask, prec=prec)
    feats = l2_normalize(prec.linear(hidden[:, nq], w["text_proj_q.weight"],
                                     w["text_proj_q.bias"]))
    sims = torch.einsum("bd,mqd->bmq", feats, bank.float()).amax(dim=-1)
    return F.cross_entropy(sims / w["temp"], labels)


def trainable(name: str) -> bool:
    """`init_stage2`: the re-read's Q-Former copy, its projection and the
    temperature train."""
    return name.split(".")[0] in ("Qformer_query", "text_proj_q", "temp")
