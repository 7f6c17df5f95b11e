"""Synthetic tokenizer assets, made the same way in every run.

The published CLIP merges file and BERT vocabulary are not in the
repository, so the benchmark learns a small merges table from a fixed
caption corpus and builds a WordPiece vocabulary of BERT's real size. The
program and the plain reference receive the same table. Copied from the
port's test helpers (`tests/torch_fixtures.py`), which may change.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import List, Sequence, Tuple

CORPUS = (
    "make it like number 7 but red",
    "is darker and has longer sleeves",
    "the dress is shorter with a floral print",
    "change the dog to a cat sitting on the grass",
    "same shirt in blue with a white collar",
    "remove the people and show the beach at sunset",
    "a red dress with thin straps",
    "make the car black and add a second one",
    "cap a cap b more colorful and less formal",
    "show two birds on a branch instead of one",
)

#: the caption words: every word of the corpus, so that each one encodes
#: through merges the table holds
WORDS = tuple(sorted({w for text in CORPUS for w in text.split()}))

_WORD = re.compile(r"[a-z]+|[0-9]|[^\sa-z0-9]+")

BERT_VOCAB_SIZE = 30522


def byte_unicode_table() -> dict:
    """CLIP's reversible byte -> printable-unicode map."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {b: chr(b) for b in keep}
    bump = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + bump)
            bump += 1
    return table


def synthetic_merges(corpus: Sequence[str] = CORPUS, n_merges: int = 300
                     ) -> List[Tuple[str, str]]:
    """Up to `n_merges` BPE merges learned from `corpus` (greedy, most
    frequent pair first, ties broken by the pair itself)."""
    table = byte_unicode_table()
    words: Counter = Counter()
    for text in corpus:
        for w in _WORD.findall(text.lower()):
            sym = [table[b] for b in w.encode("utf-8")]
            words[tuple(sym[:-1] + [sym[-1] + "</w>"])] += 1
    merges: List[Tuple[str, str]] = []
    while len(merges) < n_merges:
        pairs: Counter = Counter()
        for sym, count in words.items():
            for pair in zip(sym, sym[1:]):
                pairs[pair] += count
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged: Counter = Counter()
        for sym, count in words.items():
            out, i = [], 0
            while i < len(sym):
                if i + 1 < len(sym) and (sym[i], sym[i + 1]) == best:
                    out.append(sym[i] + sym[i + 1])
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            merged[tuple(out)] += count
        words = merged
    return merges


def synthetic_bert_vocab(n: int = BERT_VOCAB_SIZE) -> List[str]:
    """A WordPiece vocabulary of `n` entries: BERT's specials, characters,
    their `##` pieces, the corpus words, suffix pieces and `[unusedN]`
    filler."""
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789") + list(
        "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
    words = sorted({w for text in CORPUS for w in text.split()}
                   | {"cap", "ext", "cirr", "llm", "rewrite", "v1", "v2",
                      "make", "it", "like", "number"})
    pieces = ["##" + c for c in chars[:36]] + [
        "##s", "##er", "##ing", "##ed", "##ly", "##es", "##est"]
    out: List[str] = []
    seen = set()
    for tok in (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars
                + pieces + words):
        if tok not in seen:
            seen.add(tok)
            out.append(tok)
    out += [f"[unused{i}]" for i in range(n - len(out))]
    return out
