"""Q-Former (BLIP-2's querying transformer) in PyTorch.

Counterpart of `QFormerConfig` and `QFormer` in `spn4cir_tpu/models/qformer.py`
(parity target: LAVIS `Qformer.py` as built by `Blip2Base.init_Qformer`):
BERT-base (768/12/12, post-LN eps 1e-12) where
  - the input is [learned query tokens ; text embeddings], the embeddings
    LayerNorm applied over the concatenation (the queries get no position
    embedding; the text's positions start at 0);
  - every second layer (the even ones) has a cross-attention to the frozen
    image tokens, and it attends from the query positions only;
  - the feed-forward is split: with encoder states present, query positions
    use `intermediate_query` / `output_query` and text positions
    `intermediate` / `output`, in EVERY layer; without them (the stage-2
    text re-read) the whole sequence uses the plain feed-forward.

Parameter names are LAVIS's / HF BERT's (`bert.embeddings.word_embeddings`,
`bert.encoder.layer.{i}.attention.self.query`, `.crossattention.`,
`.intermediate.dense`, `.output.LayerNorm`, `.intermediate_query.dense`,
`.output_query.dense`), so the `Qformer.*` entries of a BLIP-2 checkpoint
load with `load_state_dict` directly. The attention pieces are MED's
(`models/med.py`), as the JAX module builds from `med._BertAttention`; their
padding masks keep them plain tensor code.

Dropout (`dropout_rate`, 0 by default) is live only in `train()` mode, drawn
from the `generator` given to `forward` (`med.Dropout`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from spn4cir_tpu_torch.models.med import (BertAttention, BertEmbeddings,
                                          BertIntermediate, BertOutput,
                                          Dropout, MedConfig, additive_mask)


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    vocab_size: int = 30523
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    encoder_width: int = 1408  # EVA ViT-g feature width
    num_query_tokens: int = 32
    cross_attention_freq: int = 2
    dropout_rate: float = 0.0  # HF BERT train-mode dropout (0.0 = parity)

    @classmethod
    def tiny(cls, vocab_size: int = 128, **kw) -> "QFormerConfig":
        return cls(vocab_size=vocab_size, hidden_size=32, num_layers=2,
                   num_heads=2, intermediate_size=64, encoder_width=32,
                   num_query_tokens=8, **kw)

    def as_med(self) -> MedConfig:
        return MedConfig(vocab_size=self.vocab_size,
                         hidden_size=self.hidden_size,
                         num_layers=self.num_layers, num_heads=self.num_heads,
                         intermediate_size=self.intermediate_size,
                         max_position_embeddings=self.max_position_embeddings,
                         encoder_width=self.encoder_width,
                         dropout_rate=self.dropout_rate)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross: bool):
        super().__init__()
        med = cfg.as_med()
        self.attention = BertAttention(med)
        if has_cross:
            self.crossattention = BertAttention(med, cross=True)
        self.intermediate = BertIntermediate(med)
        self.output = BertOutput(med)
        self.intermediate_query = BertIntermediate(med)
        self.output_query = BertOutput(med)

    def forward(self, hidden, enc_states, self_mask, cross_mask,
                query_length: int, drop: Dropout) -> torch.Tensor:
        hidden = self.attention(hidden, None, self_mask, drop)
        if hasattr(self, "crossattention") and enc_states is not None:
            q_part = self.crossattention(hidden[:, :query_length], enc_states,
                                         cross_mask, drop)
            hidden = torch.cat([q_part, hidden[:, query_length:]], dim=1)
        if enc_states is None:
            return self.output(self.intermediate(hidden), hidden, drop)
        queries = hidden[:, :query_length]
        out = self.output_query(self.intermediate_query(queries), queries, drop)
        if hidden.shape[1] > query_length:
            text = hidden[:, query_length:]
            out = torch.cat([out, self.output(self.intermediate(text), text,
                                              drop)], dim=1)
        return out


class QFormerEncoder(nn.Module):
    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            QFormerLayer(cfg, i % cfg.cross_attention_freq == 0)
            for i in range(cfg.num_layers))


class QFormerBert(nn.Module):
    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg.as_med())
        self.encoder = QFormerEncoder(cfg)


class QFormer(nn.Module):
    """`Qformer.bert`. Modes (all used by the CIR model):
      - query-only image encode: (query_embeds, encoder_hidden_states)
      - fusion: (input_ids, query_embeds, attention_mask, encoder_*)
      - text re-read: (input_ids, query_embeds=cached states, attention_mask)
    Returns the hidden states (B, Lq [+ L], hidden) in `dtype`."""

    def __init__(self, cfg: QFormerConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.bert = QFormerBert(cfg)

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                query_embeds: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if query_embeds is None:
            raise ValueError("the Q-Former needs its query embeddings")
        query_length = query_embeds.shape[1]
        emb = self.bert.embeddings
        parts = [query_embeds.float()]
        if input_ids is not None:
            parts.append(F.embedding(input_ids, emb.word_embeddings.weight)
                         + emb.position_embeddings.weight[: input_ids.shape[1]])
        drop = Dropout(self.cfg.dropout_rate, self.training, generator)
        # the LayerNorm runs over the concatenation, queries included
        x = drop(emb.LayerNorm(torch.cat(parts, dim=1)).to(self.dtype))
        self_mask = (additive_mask(attention_mask)
                     if attention_mask is not None else None)
        cross_mask = (additive_mask(encoder_attention_mask)
                      if encoder_attention_mask is not None else None)
        if encoder_hidden_states is not None:
            encoder_hidden_states = encoder_hidden_states.to(self.dtype)
        for layer in self.bert.encoder.layer:
            x = layer(x, encoder_hidden_states, self_mask, cross_mask,
                      query_length, drop)
        return x
