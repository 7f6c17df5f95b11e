"""How the benchmark builds each model family of the program, and which plain
reference follows it. A configuration file names its `family`.

The program side imports the port; the reference side imports only
`cirbench.reference`. Both read the widths from the configuration file, and
the program's own record of them is checked against it, so the file holds
the configuration as it is run.
"""

from __future__ import annotations

from typing import Any, Dict

from cirbench.assets import synthetic_bert_vocab, synthetic_merges


def _dtype(torch, cfg):
    return getattr(torch, cfg["dtype"])


def build_program(cfg: Dict[str, Any], device):
    """The port's backbone for `cfg`, its parameters still empty."""
    import torch

    family = cfg["family"]
    if family == "clip":
        from spn4cir_tpu_torch.models.clip4cir import ClipCIR
        from spn4cir_tpu_torch.tokenizer.bpe import ClipTokenizer

        backbone = ClipCIR(clip_model_name=cfg["model_name"], tau=cfg["tau"],
                           dtype=_dtype(torch, cfg), device=device,
                           tokenizer=ClipTokenizer(merges=synthetic_merges()))
        got = backbone.cfg
        want = dict(embed_dim=got.embed_dim,
                    transformer_width=got.transformer_width,
                    transformer_heads=got.transformer_heads,
                    transformer_layers=got.transformer_layers,
                    context_length=got.context_length,
                    vocab_size=got.vocab_size)
    elif family == "blip2":
        from spn4cir_tpu_torch.models.blip24cir import Blip2CIR
        from spn4cir_tpu_torch.models.eva_vit import EvaViTConfig
        from spn4cir_tpu_torch.models.qformer import QFormerConfig
        from spn4cir_tpu_torch.tokenizer.wordpiece import BertTokenizer

        tok = BertTokenizer(vocab=synthetic_bert_vocab(cfg["bert_vocab"]))
        vit = EvaViTConfig(**cfg["vision"])
        q = QFormerConfig(vocab_size=tok.vocab_size, **cfg["qformer"])
        backbone = Blip2CIR("pretrain", tau=cfg["tau"],
                            dtype=_dtype(torch, cfg), device=device,
                            vit_cfg=vit, q_cfg=q, tokenizer=tok)
        got = backbone.q_cfg
        want = dict(qformer_vocab=got.vocab_size,
                    embed_dim=backbone.embed_dim)
    else:
        raise ValueError(f"unknown family {family!r}")
    for key, value in want.items():
        if cfg.get(key) != value:
            raise SystemExit(f"the program runs {key}={value}, the "
                             f"configuration file says {cfg.get(key)}")
    return backbone


def reference(cfg: Dict[str, Any]):
    """The plain reference module of the family."""
    family = cfg["family"]
    if family == "clip":
        from cirbench.reference import clip4cir as ref
    elif family == "blip2":
        from cirbench.reference import blip24cir as ref
    else:
        raise ValueError(f"unknown family {family!r}")
    return ref
