"""A word-level synthetic tokenizer over a language model's whole vocabulary.

Moonlight-16B-A3B's tiktoken vocabulary (163,840 entries) is not in the
repository. The benchmark gives the program and the plain reference this
one instead: `<unk>`, `<s>`, `</s>`, then every word and punctuation mark
of the llava_v1 caption prompt and of the caption corpus, then filler
entries up to the model's vocabulary size, so that any id a model samples
decodes. Text splits into words, numbers and single punctuation marks, and
a word longer than `PIECE` characters into pieces of at most `PIECE`, each
after the first marked `##`, as a subword tokenizer splits rare words:
the llava_v1 caption prompt is then 60 text tokens (44 before the image,
16 after it), about what LLaMA's tokenizer makes of it; whitespace is
dropped.
"""

from __future__ import annotations

import re
from typing import List

from cirbench.assets import WORDS
from cirbench.reference.moonlight import CAPTION, SYSTEM

_TOKEN = re.compile(r"[A-Za-z]+|[0-9]+|[^\sA-Za-z0-9]")
#: characters a piece holds at most
PIECE = 5
CATEGORIES = ("image", "dress", "shirt", "toptee")
_TEXT = " ".join([SYSTEM, "USER: ASSISTANT: user:", *WORDS,
                  *(CAPTION.format(category=c, num_words=n)
                    for c in CATEGORIES for n in range(1, 33))])


def pieces(text: str) -> List[str]:
    """The tokens of `text`: words, numbers and marks, long words in
    pieces."""
    out = []
    for word in _TOKEN.findall(text):
        out.append(word[:PIECE])
        out.extend("##" + word[i:i + PIECE]
                   for i in range(PIECE, len(word), PIECE))
    return out


class WordTokenizer:
    """encode(text) -> [BOS] + ids; decode(ids) -> words joined by spaces,
    a word's pieces joined again (the LLaMA tokenizer's protocol, as the
    captioner reads it)."""

    unk_token_id, bos_token_id, eos_token_id = 0, 1, 2

    def __init__(self, vocab_size: int):
        words = ["<unk>", "<s>", "</s>"] + sorted(set(pieces(_TEXT)))
        if vocab_size < len(words):
            raise ValueError(f"the word tokenizer needs {len(words)} ids, "
                             f"the vocabulary has {vocab_size}")
        self.words = words + [f"<w{i}>" for i in range(len(words),
                                                        vocab_size)]
        self.ids = {w: i for i, w in enumerate(words)}
        self.vocab_size = vocab_size

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [self.ids.get(w, self.unk_token_id) for w in pieces(text)]
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        return " ".join(self.words[i] for i in ids).replace(" ##", "")
