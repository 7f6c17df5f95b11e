"""CLIP's byte-pair tokenizer, written plainly from OpenAI's
`simple_tokenizer.py`: bytes mapped to printable characters, each word
merged by the lowest-ranked pair first, `<|startoftext|>` and
`<|endoftext|>` around the ids, rows of 77 padded with 0 and cut to end
in `<|endoftext|>`."""

from __future__ import annotations

import html
from typing import List, Sequence, Tuple

import numpy as np

try:
    import regex as re
    _PAT = re.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m"""
                      r"""|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
                      re.IGNORECASE)
except ImportError:  # ASCII captions split alike without `regex`
    import re
    _PAT = re.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m"""
                      r"""|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
                      re.IGNORECASE)


def bytes_to_unicode() -> dict:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ReferenceBpe:
    def __init__(self, merges: Sequence[Tuple[str, str]]):
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.ranks = dict(zip([tuple(m) for m in merges], range(len(merges))))

    def bpe(self, token: str) -> List[str]:
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            first, second = best
            new, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new.extend(word[i:])
                    break
                new.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new.append(first + second)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
        return list(word)

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text))
        text = " ".join(text.split()).strip().lower()
        ids = []
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token))
        return ids

    def tokenize(self, texts: Sequence[str], context_length: int = 77
                 ) -> np.ndarray:
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), context_length), np.int64)
        for i, text in enumerate(texts):
            ids = [sot] + self.encode(text) + [eot]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = eot
            out[i, :len(ids)] = ids
        return out
