"""The one generator every traffic mix is drawn by: captions, row ids,
pixel batches, unit rows and arrival times, each from its own stream of the
run's seed. A mix is a data file of parameters for these functions."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from cirbench.assets import WORDS
from cirbench.harness import sub_seed

# stream tags: one stream of the seed per kind of input
WEIGHTS, BANK, REFER, BATCHES, PIXELS, ARRIVALS, GALLERY, SAMPLE = range(8)


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream, *more))


def captions(r: np.random.Generator, n: int, words: Sequence[int],
             vocab: Sequence[str] = WORDS) -> List[str]:
    """`n` captions of `words[0]`..`words[1]` words drawn from `vocab`."""
    lengths = r.integers(words[0], words[1] + 1, size=n)
    return [" ".join(vocab[i] for i in r.integers(0, len(vocab), size=k))
            for k in lengths]


def stage2_batches(seed: int, n_batches: int, batch: int, bank_rows: int,
                   refer_rows: int, words: Sequence[int]) -> List[Dict]:
    """`iter_train_bank`-shaped batches. Within the pool every batch's target
    rows, refer images and refer triplets are distinct, as far as the bank
    and the refer pool hold them: each id stream walks a permutation."""
    r = rng(seed, BATCHES)
    need = n_batches * batch

    def walk(rows: int) -> np.ndarray:
        reps = -(-need // rows)
        return np.concatenate([r.permutation(rows) for _ in range(reps)])[
            :need].reshape(n_batches, batch)

    target, refer, triplet = walk(bank_rows), walk(bank_rows), walk(refer_rows)
    return [{"captions": captions(r, batch, words),
             "refer_image_id": refer[i], "target_image_id": target[i],
             "triplet_idx": triplet[i]} for i in range(n_batches)]
