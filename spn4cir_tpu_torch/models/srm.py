"""The SRM dual encoder in PyTorch: Unicom ViT-L/14 images + BGE-base texts.

Counterpart of `spn4cir_tpu/models/srm.py` (parity target:
`zscir/srm_utils.py:35-69`, `SRMCMRModel`), the secondary retrieval model
whose intra-modal similarities score the (reference, target) pairs of the
scaling-positives pipeline and pick its hard negatives:
  - `encode_image`: Unicom's embedding, L2-normalised (`:52-57`);
  - `encode_text`: BGE's (`BAAI/bge-base-en`, an HF `BertModel`) CLS hidden
    state at float32, L2-normalised (`:59-68`).

`.visual` is `models.unicom.UnicomViT` under timm's names and `.text` a
`models.med.MedBert` built without cross-attention under HF BERT's, so the
reference's two checkpoints load with strict `load_state_dict` after
`models.convert.load_unicom_checkpoint` / `load_bge_checkpoint`. The text
goes through the plain WordPiece vocabulary of bert-base-uncased (no BLIP
tokens), 64 tokens at most. BGE's attention carries a padding mask, so it
is plain tensor code, as in the JAX package; Unicom's runs through kernel
#3 in float32 on the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from spn4cir_tpu_torch.models.med import MedBert, MedConfig
from spn4cir_tpu_torch.models.unicom import UnicomConfig, UnicomViT
from spn4cir_tpu_torch.tokenizer.wordpiece import BertTokenizer, tiny_test_vocab
from spn4cir_tpu_torch.utils.logging import span


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


class SRMModel(nn.Module):
    """`tiny=True`: the test geometries (`UnicomConfig.tiny`, a two-layer
    BGE over `tiny_test_vocab`); otherwise Unicom ViT-L/14 and BGE-base
    over the vocabulary at `bert_vocab_path` (or `SPN4CIR_BERT_VOCAB`).
    The weights are float32 on `device`; fill them with `init_params` or a
    checkpoint."""

    def __init__(self, tiny: bool = False,
                 bert_vocab_path: Optional[str] = None,
                 unicom_cfg: Optional[UnicomConfig] = None,
                 bge_cfg: Optional[MedConfig] = None,
                 text_max_len: int = 64, device="cpu"):
        super().__init__()
        if tiny:
            self.tokenizer = BertTokenizer(vocab=tiny_test_vocab(),
                                           add_blip_tokens=False)
            unicom_cfg = unicom_cfg or UnicomConfig.tiny()
            bge_cfg = bge_cfg or MedConfig.tiny(
                self.tokenizer.vocab_size, type_vocab_size=2,
                cross_attention=False)
        else:
            self.tokenizer = BertTokenizer(vocab_path=bert_vocab_path,
                                           add_blip_tokens=False)
            unicom_cfg = unicom_cfg or UnicomConfig.vit_l14()
            bge_cfg = bge_cfg or MedConfig.bge_base(self.tokenizer.vocab_size)
        self.unicom_cfg = unicom_cfg
        self.bge_cfg = bge_cfg
        self.text_max_len = text_max_len
        with torch.device(device):
            self.visual = UnicomViT(unicom_cfg)
            self.text = MedBert(bge_cfg)
        self.input_dim = unicom_cfg.input_size
        self.visual_dim = unicom_cfg.embedding_size
        self.text_dim = bge_cfg.hidden_size

    @property
    def device(self) -> torch.device:
        return self.visual.pos_embed.device

    def init_params(self, generator: torch.Generator) -> None:
        """Random weights from `generator`, a CPU generator: Unicom's, then
        BGE's."""
        self.visual.init_weights(generator)
        self.text.init_weights(generator)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, visual_dim) unit rows, float32."""
        return _l2(self.visual(images))

    def encode_text_ids(self, input_ids: torch.Tensor,
                        attention_mask: torch.Tensor) -> torch.Tensor:
        """The CLS hidden state at float32, L2-normalised."""
        hidden = self.text(input_ids, attention_mask)
        return _l2(hidden[:, 0].float())

    def tokenize(self, texts: Sequence[str]):
        """(input_ids, attention_mask), int32 numpy arrays of width
        `text_max_len`."""
        with span("text.tokenize"):
            return self.tokenizer(list(texts), max_length=self.text_max_len)

    def encode_text(self, texts: List[str]) -> torch.Tensor:
        ids, mask = self.tokenize(texts)
        dev = self.device
        return self.encode_text_ids(torch.from_numpy(ids).long().to(dev),
                                    torch.from_numpy(mask).to(dev))
