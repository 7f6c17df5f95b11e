"""BERT WordPiece tokenizer (clean-room), for the BLIP text side.

The port's own copy of `spn4cir_tpu/tokenizer/wordpiece.py` (pure Python,
no array library but numpy): the port imports nothing of the JAX package.

Behavioral parity target: HF `BertTokenizer('bert-base-uncased')` as used by
BLIP's `init_tokenizer` (ref `blip4cir/blip.py`), including BLIP's two extra
special tokens: '[DEC]' (bos) and '[ENC]' appended after the base vocab, and
the CIR trick of overwriting position 0 with `enc_token_id`
(`blip4cir/blip_cir.py:100`).

The vocab file is a data asset (one token per line, id = line number); it is
loaded from `SPN4CIR_BERT_VOCAB` or a supplied path — never vendored. Tests
use a miniature vocab.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
DEC_TOKEN, ENC_TOKEN = "[DEC]", "[ENC]"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_chinese_char(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """BERT BasicTokenizer semantics: clean, CJK spacing, lowercase + strip
    accents, punctuation splitting."""
    out = []
    buf = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
            if ch in ("\t", "\n", "\r"):
                buf.append(" ")
            continue
        if _is_chinese_char(cp):
            buf.append(f" {ch} ")
        else:
            buf.append(ch)
    text = "".join(buf)
    for token in text.split():
        if lowercase:
            token = token.lower()
            token = "".join(c for c in unicodedata.normalize("NFD", token)
                            if unicodedata.category(c) != "Mn")
        current = []
        for ch in token:
            if _is_punctuation(ch):
                if current:
                    out.append("".join(current))
                    current = []
                out.append(ch)
            else:
                current.append(ch)
        if current:
            out.append("".join(current))
    return out


class BertTokenizer:
    def __init__(self, vocab_path: Optional[str] = None,
                 vocab: Optional[Sequence[str]] = None,
                 add_blip_tokens: bool = True,
                 max_wordpiece_chars: int = 100):
        if vocab is None:
            path = vocab_path or os.environ.get("SPN4CIR_BERT_VOCAB", "")
            if not path or not os.path.exists(path):
                raise FileNotFoundError(
                    "BERT vocab not found; set SPN4CIR_BERT_VOCAB or pass "
                    "vocab_path/vocab")
            with open(path, encoding="utf-8") as f:
                vocab = [line.rstrip("\n") for line in f if line.strip("\n") != ""]
        vocab = list(vocab)
        if add_blip_tokens:
            # BLIP appends [DEC] then [ENC] (ref blip4cir/blip.py init_tokenizer)
            for tok in (DEC_TOKEN, ENC_TOKEN):
                if tok not in vocab:
                    vocab.append(tok)
        self.vocab: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.max_wordpiece_chars = max_wordpiece_chars
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]
        self.dec_token_id = self.vocab.get(DEC_TOKEN)
        self.enc_token_id = self.vocab.get(ENC_TOKEN)
        self.vocab_size = len(vocab)

    def wordpiece(self, token: str) -> List[int]:
        if len(token) > self.max_wordpiece_chars:
            return [self.unk_id]
        ids = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                piece = token[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        ids = []
        for token in basic_tokenize(text):
            ids.extend(self.wordpiece(token))
        return ids

    def __call__(self, texts, max_length: int = 35, pad_to_max: bool = True,
                 replace_cls_with_enc: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """HF-style batch encode: [CLS] tokens [SEP], truncated + padded.
        Returns (input_ids (B, L) int32, attention_mask (B, L) int32).
        `replace_cls_with_enc` applies the CIR enc-token swap
        (ref blip4cir/blip_cir.py:100)."""
        if isinstance(texts, str):
            texts = [texts]
        batch = np.full((len(texts), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.cls_id] + self.encode(text)[: max_length - 2] + [self.sep_id]
            if replace_cls_with_enc:
                ids[0] = self.enc_token_id
            batch[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        return batch, mask


    # HF PreTrainedTokenizer.clean_up_tokenization replacements, in order
    _CLEANUP = [(" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"),
                (" 've", "'ve"), (" 're", "'re")]

    def decode(self, ids, skip_special_tokens: bool = True,
               clean_up_tokenization_spaces: bool = True) -> str:
        """HF BertTokenizer.decode semantics: drop special tokens, join with
        spaces, merge '##' pieces, apply HF's clean_up_tokenization. Used by
        the captioner to turn generated ids back into text
        (ref blip_caption.py:202 batch_decode(skip_special_tokens=True))."""
        special = {self.pad_id, self.unk_id, self.cls_id, self.sep_id,
                   self.vocab.get(MASK), self.dec_token_id, self.enc_token_id}
        pieces: List[str] = []
        for i in [int(x) for x in ids]:
            if skip_special_tokens and i in special:
                continue
            pieces.append(self.inv_vocab.get(i, UNK))
        text = " ".join(pieces).replace(" ##", "")
        if clean_up_tokenization_spaces:
            for a, b in self._CLEANUP:
                text = text.replace(a, b)
        return text

    def batch_decode(self, batch_ids, **kw) -> List[str]:
        return [self.decode(row, **kw) for row in batch_ids]


def tiny_test_vocab(extra_words: Sequence[str] = ()) -> List[str]:
    """A miniature WordPiece vocab for tests. Entries are deduped (a
    duplicate line would shadow an id: the id->token map loses the earlier
    index and generated ids could decode to nothing)."""
    base = [PAD, UNK, CLS, SEP, MASK]
    letters = list("abcdefghijklmnopqrstuvwxyz")
    pieces = ["##" + c for c in letters]
    words = ["the", "a", "dress", "shirt", "blue", "red", "make", "it",
             "more", "less", "with", "print", "sleeve", "##s", "##ing",
             "short", "long"]
    out: List[str] = []
    for tok in base + letters + pieces + words + list(extra_words):
        if tok not in out:
            out.append(tok)
    return out
