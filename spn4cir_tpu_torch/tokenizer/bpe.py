"""CLIP byte-pair-encoding tokenizer (clean-room implementation).

Behavioral parity target: the vendored OpenAI tokenizer in the reference
(`clip4cir/clip/simple_tokenizer.py`, `clip4cir/clip/clip.py:206` `tokenize`).
The merges table is a *data asset* (`bpe_simple_vocab_16e6.txt.gz`); we load it
from a user-supplied path, from `SPN4CIR_BPE_VOCAB` or from beside this
module at runtime rather than vendoring it.

A copy of `spn4cir_tpu/tokenizer/bpe.py`, the pure-Python BPE only: the
native C++ fast path of the JAX package is not ported yet.

Token-id layout (must match CLIP checkpoints, vocab size 49408):
  [0, 256)            : byte-level unicode symbols
  [256, 512)          : the same symbols with an end-of-word marker
  [512, 512 + 48894)  : merged tokens, in merge-rank order
  49406, 49407        : <|startoftext|>, <|endoftext|>
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Iterable, List, Sequence, Union

import numpy as np

try:  # `regex` supports \p{L}/\p{N} unicode classes needed for CLIP's split.
    import regex as _re
except ImportError:  # pragma: no cover
    import re as _re  # type: ignore

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
CONTEXT_LENGTH = 77
_NUM_MERGES = 49152 - 256 - 2  # 48894, per CLIP's released merges file usage

_PACKAGED_VOCAB = os.path.join(os.path.dirname(__file__),
                               "bpe_simple_vocab_16e6.txt.gz")

_WORD_END = "</w>"

_SPLIT_PATTERN = _re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    _re.IGNORECASE,
)


def byte_unicode_table() -> dict:
    """Reversible byte -> printable-unicode map (GPT-2/CLIP convention).

    Printable bytes map to themselves; the rest are shifted into the 256+
    private range, in increasing order.
    """
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    table = {b: chr(b) for b in keep}
    bump = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + bump)
            bump += 1
    return table


def _clean(text: str) -> str:
    # The reference runs ftfy.fix_text; we unescape HTML entities (twice, as
    # the reference effectively does via fix_text+unescape) and normalize
    # whitespace + lowercase.
    text = html.unescape(html.unescape(text))
    text = _re.sub(r"\s+", " ", text)
    return text.strip().lower()


def _resolve_vocab(path: str | None) -> str:
    # the environment is read here, not at import: setting the variable
    # after the module is loaded still takes effect
    candidates = [path, os.environ.get("SPN4CIR_BPE_VOCAB", ""),
                  _PACKAGED_VOCAB]
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        "CLIP BPE merges file not found. Set SPN4CIR_BPE_VOCAB or pass "
        f"vocab_path. Tried: {candidates}"
    )


class ClipTokenizer:
    """Byte-level BPE with end-of-word markers, matching CLIP's vocabulary."""

    def __init__(self, vocab_path: str | None = None, merges: Sequence[tuple] | None = None):
        self._byte_encoder = byte_unicode_table()
        self._byte_decoder = {v: k for k, v in self._byte_encoder.items()}
        if merges is None:
            resolved = _resolve_vocab(vocab_path)
            with gzip.open(resolved, "rt", encoding="utf-8") as fh:
                lines = fh.read().split("\n")
            # Line 0 is a version header; merges follow.
            merges = [tuple(line.split()) for line in lines[1 : _NUM_MERGES + 1]]
        symbols = list(self._byte_encoder.values())
        vocab = symbols + [s + _WORD_END for s in symbols]
        vocab += ["".join(pair) for pair in merges]
        vocab += [SOT_TOKEN, EOT_TOKEN]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self._rank = {pair: i for i, pair in enumerate(merges)}
        self._cache = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self.vocab_size = len(vocab)
        self.sot_id = self.encoder[SOT_TOKEN]
        self.eot_id = self.encoder[EOT_TOKEN]

    # -- BPE core ----------------------------------------------------------
    def _merge_word(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts: List[str] = list(token[:-1]) + [token[-1] + _WORD_END]
        if len(parts) == 1:
            merged = token + _WORD_END
            self._cache[token] = merged
            return merged
        while len(parts) > 1:
            best = min(
                zip(parts[:-1], parts[1:]),
                key=lambda p: self._rank.get(p, float("inf")),
            )
            if best not in self._rank:
                break
            out: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == best:
                    out.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        merged = " ".join(parts)
        self._cache[token] = merged
        return merged

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk in _SPLIT_PATTERN.findall(_clean(text)):
            mapped = "".join(self._byte_encoder[b] for b in chunk.encode("utf-8"))
            ids.extend(self.encoder[tok] for tok in self._merge_word(mapped).split(" "))
        return ids

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        return [self.encode(t) for t in texts]

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self._byte_decoder[ch] for ch in text if ch in self._byte_decoder)
        return raw.decode("utf-8", errors="replace").replace(_WORD_END, " ")


@functools.lru_cache(maxsize=4)
def get_tokenizer(vocab_path: str | None = None) -> ClipTokenizer:
    return ClipTokenizer(vocab_path)


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = False,
    tokenizer: ClipTokenizer | None = None,
) -> np.ndarray:
    """Tokenize into a fixed `(len(texts), context_length)` int32 array.

    Parity with `clip4cir/clip/clip.py:206`: SOT + bpe + EOT, zero-padded;
    overlong sequences raise unless `truncate`, in which case the last token
    is forced to EOT.
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = tokenizer or get_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for row, (text, enc) in enumerate(zip(texts, tok.encode_batch(texts))):
        ids = [tok.sot_id] + enc + [tok.eot_id]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
            ids = ids[:context_length]
            ids[-1] = tok.eot_id
        out[row, : len(ids)] = ids
    return out


def fits_context(text: str, context_length: int = CONTEXT_LENGTH,
                 tokenizer: ClipTokenizer | None = None) -> bool:
    """True iff `text` tokenizes to <= context_length with SOT/EOT.

    Used by the datagen pipeline's overflow fallback
    (ref `zscir/get_cir_data.py:21-24`).
    """
    tok = tokenizer or get_tokenizer()
    return len(tok.encode(text)) + 2 <= context_length
