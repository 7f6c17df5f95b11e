"""MED: BERT mixture encoder with per-layer cross-attention, in PyTorch.

Counterpart of `MedConfig`, `MedBert` and the mask helpers of
`spn4cir_tpu/models/med.py`, as configured by BLIP's `med_config.json`:
hidden 768, 12 layers, 12 heads, intermediate 3072, exact GELU, post-LN with
eps 1e-12, cross-attention to the image tokens in every layer, vocabulary
30522 + BLIP's two special tokens. `BertLMHeadModel` is the captioner's
text decoder (JAX `MedLMModel`): the causal trunk under `bert.*` and
`BertLMPredictionHead` (JAX `MedLMHead`) under `cls.predictions.*`.

Parameter names are HF BERT's / MED's (`embeddings.word_embeddings`,
`encoder.layer.{i}.attention.self.query`, `.attention.output.dense`,
`.attention.output.LayerNorm`, `.crossattention.`, `.intermediate.dense`,
`.output.dense`, `.output.LayerNorm`), so the `text_encoder.*` entries of a
BLIP checkpoint load with `load_state_dict` directly, and so do the
`text_decoder.*` entries of a LAVIS captioner (`bert.*`,
`cls.predictions.transform.dense`, `cls.predictions.transform.LayerNorm`,
`cls.predictions.decoder`, `cls.predictions.bias`).

What differs from the CLIP block (`models/layers.py`): post-LN over
`(hidden + out)` in float32; the scale multiplies the float32 logits after
the q·k product; masks are additive -1e9, not -inf; word + position
embeddings only (no token-type table unless `type_vocab_size`); separate
q / k / v projections, the cross-attention's k and v reading
`encoder_width`; `cross_attention=False` (`MedConfig.bge_base`, the SRM
matcher's BGE text encoder) builds the layers of a plain HF `BertModel`,
with no `crossattention` module. The attention carries data-dependent
padding masks: it is plain tensor code here, as it runs outside any Pallas
kernel in the JAX package.

Dropout (`dropout_rate`, 0 by default) is live only in `train()` mode, at
HF's four places (embeddings, attention probabilities, attention output,
feed-forward output); its noise comes from the `generator` given to
`forward` (a generator of the activations' device), or from the device's
default generator when none is given.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spn4cir_tpu_torch.models.layers import gelu, linear

LN_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class MedConfig:
    vocab_size: int = 30524
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    encoder_width: int = 768  # cross-attention k/v input width (= ViT width)
    # 0 = MED semantics (BLIP's BertEmbeddings has no token_type table);
    # 2 = standard HF BERT
    type_vocab_size: int = 0
    # HF BERT trains with hidden/attention dropout 0.1 (med_config.json);
    # 0.0 reproduces eval numerics
    dropout_rate: float = 0.0
    # False = a plain HF BertModel: no `crossattention` module in any layer
    # (BGE; the JAX package builds its cross-attention only when it is
    # called with encoder states, so a text-only tree has none)
    cross_attention: bool = True

    @classmethod
    def tiny(cls, vocab_size: int = 128, **kw) -> "MedConfig":
        return cls(vocab_size=vocab_size, hidden_size=32, num_layers=2,
                   num_heads=2, intermediate_size=64, encoder_width=32, **kw)

    @classmethod
    def bge_base(cls, vocab_size: int = 30522) -> "MedConfig":
        """BAAI/bge-base-en: a standard bert-base-uncased BertModel (token
        types, no cross-attention)."""
        return cls(vocab_size=vocab_size, type_vocab_size=2,
                   cross_attention=False)


def additive_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, L) {0,1} -> (B, 1, 1, L) additive float32 bias."""
    return (1.0 - attention_mask[:, None, None, :].float()) * -1e9


def causal_additive_mask(length: int, device=None) -> torch.Tensor:
    """(1, 1, L, L) additive causal bias (upper triangle -1e9)."""
    tri = torch.ones(length, length, device=device).tril()
    return (1.0 - tri)[None, None] * -1e9


class GlobalNoise(NamedTuple):
    """A dropout noise source for a rank that holds rows [offset, offset +
    B_loc) of a global batch of `rows` (`parallel/train.py`): the noise is
    drawn at the global batch's shape from `generator`, seeded alike on
    every rank, and the rank keeps its rows, so a data-parallel step drops
    what one process would drop for the same seed."""

    generator: Optional[torch.Generator]
    offset: int
    rows: int


class Dropout:
    """Inverted dropout with an explicit noise source: `rate`, whether it is
    live, and the generator the uniform noise is drawn from (or a
    `GlobalNoise`)."""

    def __init__(self, rate: float, live: bool, generator=None):
        self.rate = rate if live else 0.0
        self.generator = generator

    def __call__(self, x: torch.Tensor, heads: Optional[Tuple[int, int]] = None
                 ) -> torch.Tensor:
        """`heads` (offset, total): x's axis 1 holds heads [offset, offset +
        H_loc) of `total` (tensor-parallel attention weights); the noise is
        drawn for all of them."""
        if not self.rate:
            return x
        shape, index = list(x.shape), [slice(None)] * x.dim()
        gen = self.generator
        if isinstance(gen, GlobalNoise):
            shape[0] = gen.rows
            index[0] = slice(gen.offset, gen.offset + x.shape[0])
            gen = gen.generator
        if heads is not None:
            shape[1] = heads[1]
            index[1] = slice(heads[0], heads[0] + x.shape[1])
        keep = torch.rand(shape, generator=gen,
                          device=x.device)[tuple(index)] >= self.rate
        return x * keep.to(x.dtype) / (1.0 - self.rate)


def _float_ln(ln: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    return ln(x.float()).to(dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: MedConfig, cross: bool):
        super().__init__()
        kv_width = cfg.encoder_width if cross else cfg.hidden_size
        self.num_heads = cfg.num_heads
        # (offset, total) of this rank's heads under tensor parallelism
        self.head_slice: Optional[Tuple[int, int]] = None
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(kv_width, cfg.hidden_size)
        self.value = nn.Linear(kv_width, cfg.hidden_size)

    def forward(self, hidden, kv, mask, drop: Dropout) -> torch.Tensor:
        b, lq, _ = hidden.shape
        q = linear(hidden, self.query)
        # the projections' width, not the stream's: under tensor
        # parallelism a rank holds num_heads of the heads
        h = self.num_heads
        hd = q.shape[-1] // h
        q = q.view(b, lq, h, hd)
        k = linear(kv, self.key).view(b, -1, h, hd)
        v = linear(kv, self.value).view(b, -1, h, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * hd ** -0.5
        if mask is not None:
            logits = logits + mask
        weights = drop(torch.softmax(logits, dim=-1).to(hidden.dtype),
                       self.head_slice)
        return torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, lq,
                                                                   h * hd)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)

    def forward(self, out, hidden, drop: Dropout) -> torch.Tensor:
        out = drop(linear(out, self.dense))
        return _float_ln(self.LayerNorm, hidden + out, hidden.dtype)


class BertAttention(nn.Module):
    def __init__(self, cfg: MedConfig, cross: bool = False):
        super().__init__()
        self.self = BertSelfAttention(cfg, cross)
        self.output = BertSelfOutput(cfg)

    def forward(self, hidden, kv, mask, drop: Dropout) -> torch.Tensor:
        kv = hidden if kv is None else kv
        return self.output(self.self(hidden, kv, mask, drop), hidden, drop)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, hidden) -> torch.Tensor:
        return gelu(linear(hidden, self.dense))


class BertOutput(nn.Module):
    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)

    def forward(self, inter, hidden, drop: Dropout) -> torch.Tensor:
        out = drop(linear(inter, self.dense))
        return _float_ln(self.LayerNorm, hidden + out, hidden.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.crossattention = (BertAttention(cfg, cross=True)
                               if cfg.cross_attention else None)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, hidden, enc_states, self_mask, cross_mask,
                drop: Dropout) -> torch.Tensor:
        hidden = self.attention(hidden, None, self_mask, drop)
        if enc_states is not None:
            if self.crossattention is None:
                raise ValueError("encoder states given to a MED built "
                                 "without cross-attention")
            hidden = self.crossattention(hidden, enc_states, cross_mask, drop)
        return self.output(self.intermediate(hidden), hidden, drop)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        if cfg.type_vocab_size:
            self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                      cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = (F.embedding(input_ids, self.word_embeddings.weight)
             + self.position_embeddings.weight[: input_ids.shape[1]])
        if hasattr(self, "token_type_embeddings"):
            # single-sentence inputs use type 0 everywhere
            x = x + self.token_type_embeddings.weight[0]
        return self.LayerNorm(x)


class BertEncoder(nn.Module):
    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_layers))


class MedBert(nn.Module):
    """BertModel(add_pooling_layer=False): token ids (+ mask, + optional
    encoder states for the cross-attention) -> last hidden states.
    `causal=True` gives the decoder mode."""

    def __init__(self, cfg: MedConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None,
                causal: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = Dropout(self.cfg.dropout_rate, self.training, generator)
        x = drop(self.embeddings(input_ids).to(self.dtype))
        self_mask = (additive_mask(attention_mask)
                     if attention_mask is not None else None)
        if causal:
            cmask = causal_additive_mask(input_ids.shape[1], x.device)
            self_mask = cmask if self_mask is None else self_mask + cmask
        cross_mask = (additive_mask(encoder_attention_mask)
                      if encoder_attention_mask is not None else None)
        if encoder_hidden_states is not None:
            encoder_hidden_states = encoder_hidden_states.to(self.dtype)
        for layer in self.encoder.layer:
            x = layer(x, encoder_hidden_states, self_mask, cross_mask, drop)
        return x

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` (a CPU generator): 0.02 for the
        embedding tables, fan-in normal for the matrices, zero biases, unit
        LayerNorms."""
        for name, p in self.named_parameters():
            if "embeddings" in name and "LayerNorm" not in name:
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
            elif p.dim() >= 2:
                std = p.shape[1] ** -0.5
                p.copy_(torch.randn(p.shape, generator=generator) * std)
            elif "LayerNorm" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()


class BertPredictionHeadTransform(nn.Module):
    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        h = gelu(linear(hidden, self.dense))
        return _float_ln(self.LayerNorm, h, hidden.dtype)


class BertLMPredictionHead(nn.Module):
    """dense -> exact GELU -> LayerNorm (eps 1e-12, float32) -> the vocabulary
    projection plus its bias, which HF keeps as a parameter of its own
    (`cls.predictions.bias`; a checkpoint's `decoder.bias` is the same tensor
    tied)."""

    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.transform = BertPredictionHeadTransform(cfg)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        h = self.transform(hidden)
        return F.linear(h, self.decoder.weight.to(h.dtype),
                        self.bias.to(h.dtype))


class BertOnlyMLMHead(nn.Module):
    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.predictions = BertLMPredictionHead(cfg)


class BertLMHeadModel(nn.Module):
    """The causal MED trunk plus the LM head -> (B, L, vocab) logits in the
    activation dtype: teacher-forced LM logits, and the weights that the
    cached decoder of `models/generation.py` reads."""

    def __init__(self, cfg: MedConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.bert = MedBert(cfg, dtype)
        self.cls = BertOnlyMLMHead(cfg)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        hidden = self.bert(input_ids, attention_mask, encoder_hidden_states,
                           encoder_attention_mask, causal=True)
        return self.cls.predictions(hidden)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """`MedBert.init_weights` over the whole decoder: the head's
        matrices fan-in normal, its biases zero, its LayerNorm unit."""
        MedBert.init_weights(self, generator)
