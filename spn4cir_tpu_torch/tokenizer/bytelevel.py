"""A minimal byte-level tokenizer with the LLaMA tokenizer's protocol
(encode / decode / bos_token_id / eos_token_id).

Counterpart of `spn4cir_tpu/tokenizer/bytelevel.py`. It runs the LLaMA
rewriter without sentencepiece assets (the repository ships none). It is
NOT LLaMA's sentencepiece segmentation: a prompt is about 3.5x as many
tokens, and token parity with the reference needs the real tokenizer."""

from __future__ import annotations

from typing import List


class ByteTokenizer:
    """bytes 0..255 are themselves; 256 = BOS, 257 = EOS."""

    vocab_size = 258
    bos_token_id = 256
    eos_token_id = 257

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        data = bytes(t for t in ids if 0 <= t < 256)
        return data.decode("utf-8", errors="replace")
