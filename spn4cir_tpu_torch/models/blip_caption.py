"""BLIP captioner: the ViT encoder plus the MED LM decoder, with prompted
generation.

Counterpart of `spn4cir_tpu/models/blip_caption.py` (LAVIS `BlipCaption`,
"blip_caption" / base_coco, the model the reference's captioning stage
loads, `zscir/captioner_blip.py:35-37`):
  * the prompt "a picture of " tokenized, CLS swapped for BOS ([DEC]), the
    final SEP dropped (`blip_caption.py:183-186`);
  * generation by `models/generation.py`: beam search with num_beams=3 by
    default, or nucleus sampling at top_p=0.9 with the repetition penalty
    forced to 1.1; max_length 30, min_length 10, SEP as EOS;
  * decode with special tokens skipped, then strip the prompt by character
    count (`blip_caption.py:202-205`).

Parameter names are LAVIS's (`visual_encoder.*` timm-style,
`text_decoder.bert.*`, `text_decoder.cls.predictions.*`), so a captioner
checkpoint loads with `models.convert.load_blip_caption_checkpoint` and
`load_state_dict`. Base = ViT-B/16 at 384 (577 tokens, kernel #3 through
`models/layers.SelfAttention`) + a 12-layer MED LM over 30,524 words.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from spn4cir_tpu_torch.models.blip_vit import BlipViT, BlipViTConfig
from spn4cir_tpu_torch.models.generation import beam_generate, generate
from spn4cir_tpu_torch.models.med import BertLMHeadModel, MedConfig
from spn4cir_tpu_torch.tokenizer.wordpiece import BertTokenizer, tiny_test_vocab
from spn4cir_tpu_torch.utils.tensors import as_tensor

CAPTION_PROMPT = "a picture of "  # blip_caption_base_coco.yaml "prompt"


class BlipCaption(nn.Module):
    """visual_encoder + text_decoder, LAVIS BlipCaption's parameters."""

    def __init__(self, vit_cfg: BlipViTConfig, med_cfg: MedConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.visual_encoder = BlipViT(vit_cfg, dtype)
        self.text_decoder = BertLMHeadModel(med_cfg, dtype)

    def img_embed(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual_encoder(images)

    def lm_logits(self, input_ids: torch.Tensor,
                  attention_mask: torch.Tensor,
                  image_embeds: torch.Tensor) -> torch.Tensor:
        """Teacher-forced LM logits (LAVIS forward_decoder)."""
        enc_mask = torch.ones(image_embeds.shape[:2], dtype=torch.long,
                              device=image_embeds.device)
        return self.text_decoder(input_ids, attention_mask, image_embeds,
                                 enc_mask)

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        return self.lm_logits(input_ids, attention_mask,
                              self.img_embed(images))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` (a CPU generator), each tower
        by its own rule."""
        self.visual_encoder.init_weights(generator)
        self.text_decoder.init_weights(generator)


class BlipCaptioner:
    """`caption(images)` returns prompt-stripped caption strings, as
    LAVIS `BlipCaption.generate` does. The weights live in `self.model` (a
    `BlipCaption` on `device`), random until a state dict is loaded."""

    def __init__(self, blip_size: str = "base",
                 bert_vocab_path: Optional[str] = None,
                 med_cfg: Optional[MedConfig] = None,
                 vit_cfg: Optional[BlipViTConfig] = None,
                 prompt: str = CAPTION_PROMPT,
                 dtype: torch.dtype = torch.float32, device="cpu"):
        if vit_cfg is None:
            vit_cfg = (BlipViTConfig.tiny() if blip_size == "test-tiny"
                       else BlipViTConfig.large() if blip_size == "large"
                       else BlipViTConfig.base())
        if blip_size == "test-tiny":
            self.tokenizer = BertTokenizer(vocab=tiny_test_vocab())
            med_cfg = med_cfg or MedConfig.tiny(self.tokenizer.vocab_size)
        else:
            self.tokenizer = BertTokenizer(vocab_path=bert_vocab_path)
            med_cfg = med_cfg or MedConfig(
                vocab_size=self.tokenizer.vocab_size,
                encoder_width=vit_cfg.width)
        self.vit_cfg = vit_cfg
        self.med_cfg = med_cfg
        self.prompt = prompt
        self.input_dim = vit_cfg.image_size
        self.device = torch.device(device)
        with torch.device(self.device):
            self.model = BlipCaption(vit_cfg, med_cfg, dtype).eval()

    def init_params(self, generator: torch.Generator) -> None:
        self.model.init_weights(generator)

    def prompt_ids(self, batch: int) -> np.ndarray:
        """The tokenized prompt with the BOS swap and SEP dropped."""
        ids = [self.tokenizer.dec_token_id] + self.tokenizer.encode(
            self.prompt)
        return np.tile(np.asarray(ids, np.int64)[None], (batch, 1))

    @torch.inference_mode()
    def encode(self, images) -> torch.Tensor:
        """(B, H, W, 3) preprocessed images -> (B, 1+P, width) tokens."""
        return self.model.img_embed(as_tensor(images).to(self.device))

    @torch.inference_mode()
    def generate_ids(self, image_embeds: torch.Tensor,
                     prompt_ids: torch.Tensor, *,
                     use_nucleus_sampling: bool = False, num_beams: int = 3,
                     max_length: int = 30, min_length: int = 10,
                     top_p: float = 0.9, repetition_penalty: float = 1.0,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        dec = self.model.text_decoder
        kw = dict(eos_id=self.tokenizer.sep_id, pad_id=self.tokenizer.pad_id,
                  max_length=max_length, min_length=min_length)
        if use_nucleus_sampling:
            # ref med.py:1352-1363: sampling forces repetition_penalty=1.1
            return generate(dec, self.med_cfg, image_embeds, prompt_ids,
                            do_sample=True, top_p=top_p,
                            repetition_penalty=1.1, generator=generator,
                            **kw)
        if num_beams == 1:
            return generate(dec, self.med_cfg, image_embeds, prompt_ids,
                            repetition_penalty=repetition_penalty, **kw)
        return beam_generate(dec, self.med_cfg, image_embeds, prompt_ids,
                             num_beams=num_beams,
                             repetition_penalty=repetition_penalty, **kw)

    def caption(self, images, *, use_nucleus_sampling: bool = False,
                num_beams: int = 3, max_length: int = 30,
                min_length: int = 10, top_p: float = 0.9,
                repetition_penalty: float = 1.0,
                generator: Optional[torch.Generator] = None) -> List[str]:
        """images: (B, H, W, 3) preprocessed. Returns B caption strings
        with the prompt stripped by character count."""
        embeds = self.encode(images)
        prompt = torch.from_numpy(self.prompt_ids(embeds.shape[0]))
        ids = self.generate_ids(
            embeds, prompt.to(self.device),
            use_nucleus_sampling=use_nucleus_sampling, num_beams=num_beams,
            max_length=max_length, min_length=min_length, top_p=top_p,
            repetition_penalty=repetition_penalty, generator=generator)
        texts = self.tokenizer.batch_decode(ids.cpu().numpy())
        return [t[len(self.prompt):] for t in texts]
