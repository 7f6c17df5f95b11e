"""Modification-text templates for the positive-generation pipeline.

Counterpart of `spn4cir_tpu/datagen/templates.py` (parity target:
`zscir/get_cir_data.py:12-26`): prompt templates applied to a (reference
caption, target caption) pair, with the CLIP-context overflow fallback to
the target caption alone, over the port's own CLIP tokenizer."""

from __future__ import annotations

from typing import List, Sequence

from spn4cir_tpu_torch.tokenizer import fits_context

PROMPT_TEMPLATES = (
    "{1} instead of {0}",
    "Unlike {0}, I want {1}",
    "{1}",
)


def get_captions(caption1: str, caption2: str,
                 prompt_ids: Sequence[int] = (0,),
                 context_length: int = 77) -> List[str]:
    """Template-compose modification texts; overlong ones fall back to
    caption2 (ref get_cir_data.py:21-24)."""
    captions = []
    for pid in prompt_ids:
        caption = PROMPT_TEMPLATES[pid].format(caption1, caption2)
        try:
            ok = fits_context(caption, context_length)
        except FileNotFoundError:  # no merges file available: keep template
            ok = True
        captions.append(caption if ok else caption2)
    return captions
