"""Synthetic tokenizer assets: a CLIP BPE merges table and a BERT WordPiece
vocabulary.

The real merges file (`bpe_simple_vocab_16e6.txt.gz`) is not in the
repository, so the port's tests and `chip_smoke.py` learn a small merges
table from a fixed caption corpus and build `ClipTokenizer(merges=...)`
from it. Token ids keep CLIP's layout (bytes, bytes + '</w>', merges,
SOT, EOT); only the number of merges differs.

The BERT vocabulary (`bert-base-uncased/vocab.txt`) is not there either:
`synthetic_bert_vocab` builds one of the real size (30,522 entries, to which
the tokenizer appends BLIP's `[DEC]` and `[ENC]`: 30,524, the size of MED's
embedding table) from the specials, single characters, `##` pieces, the
words of the fixture captions and filler entries.
"""

from __future__ import annotations

import gzip
import re
from collections import Counter
from typing import List, Sequence, Tuple

from spn4cir_tpu_torch.tokenizer.bpe import ClipTokenizer, byte_unicode_table

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

_WORD = re.compile(r"[a-z]+|[0-9]|[^\sa-z0-9]+")


def synthetic_merges(corpus: Sequence[str] = CORPUS, n_merges: int = 300
                     ) -> List[Tuple[str, str]]:
    """Learn up to `n_merges` BPE merges from `corpus` (greedy, most
    frequent pair first, ties broken by the pair itself: deterministic)."""
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


def synthetic_tokenizer() -> ClipTokenizer:
    return ClipTokenizer(merges=synthetic_merges())


def write_merges_file(path: str) -> str:
    """Write the synthetic table in the merges-file format (a header line,
    then one 'a b' merge per line, gzipped); returns `path`."""
    lines = ["#version: synthetic"] + [f"{a} {b}" for a, b in synthetic_merges()]
    with gzip.open(path, "wt", encoding="utf-8") as fh:
        fh.write("\n".join(lines))  # a trailing newline would read as an empty merge
    return path


BERT_VOCAB_SIZE = 30522
# captions of tests/fixtures.py (make_cirr, make_fiq) beside the corpus
_FIXTURE_WORDS = ("cap", "ext", "cirr", "llm", "rewrite", "v1", "v2", "make",
                  "it", "like", "number")


def synthetic_bert_vocab(n: int = BERT_VOCAB_SIZE) -> List[str]:
    """A WordPiece vocabulary of `n` distinct entries: BERT's specials,
    letters, digits and punctuation, their `##` continuation pieces, the
    words of `CORPUS` and of the fixture captions (so that those encode to
    whole words), some suffix pieces, and `[unusedN]` filler up to `n`."""
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789") + list(
        "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
    words = sorted({w for text in CORPUS for w in text.split()}
                   | set(_FIXTURE_WORDS))
    pieces = ["##" + c for c in chars[:36]] + [
        "##s", "##er", "##ing", "##ed", "##ly", "##es", "##est"]
    out: List[str] = []
    seen = set()
    for tok in (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars
                + pieces + words):
        if tok not in seen:
            seen.add(tok)
            out.append(tok)
    if len(out) > n:
        raise ValueError(f"the fixed part alone has {len(out)} entries")
    out += [f"[unused{i}]" for i in range(n - len(out))]
    return out


def write_bert_vocab(path: str, n: int = BERT_VOCAB_SIZE) -> str:
    """Write `synthetic_bert_vocab(n)` in the vocab.txt format (one token a
    line, id = line number); returns `path`."""
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(synthetic_bert_vocab(n)) + "\n")
    return path
