"""Extended-triplet generation (the "scaling positives" data factory).

Counterpart of `spn4cir_tpu/datagen/generate.py`, over the port's datasets
and templates. Parity target: `zscir/get_cir_data.py` — for each (deduplicated) train image,
sample k partner images either uniformly or from an i2i-similarity rank
window [i2i_rank, i2i_rank_max), compose a modification text from the two
MLLM captions via templates (optionally LLM-rewritten), and emit extended
triplets in the dataset's native JSON schema:
  FIQ : {candidate, target, captions[...], caption1, caption2[, llm_caption]}
        -> captions/cap.extend_{model}[_llm].train.json
  CIRR: {reference, target_hard, caption[...], pairid=0,
         img_set={members:["xxx"]}, ...}  (placeholders, quirk SURVEY.md §8.13)
        -> cirr/captions/cap.rc2.train.extend_{model}[_llm].json
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from spn4cir_tpu_torch.datagen.templates import get_captions


def load_it_list(path: str) -> Dict[str, str]:
    """MLLM caption file -> {image_id: caption} (ref get_cir_data.py:36-42)."""
    with open(path) as f:
        it_list = json.load(f)
    return {it["image_id"]: it["caption"] for it in it_list}


def sample_partners(
    i: int,
    n: int,
    k: int,
    rng: random.Random,
    i2i_ranks: Optional[np.ndarray] = None,
    rank_lo: int = -1,
    rank_hi: int = -1,
) -> List[int]:
    """Partner sampling (ref get_cir_data.py:58-68): a rank window over the
    i2i similarity order when rank_lo >= 0, else uniform over others."""
    if i2i_ranks is not None and rank_lo >= 0:
        row = i2i_ranks[i].tolist()
        pool = row[rank_lo:rank_hi] if rank_hi > rank_lo else row[rank_lo:]
    else:
        pool = list(range(n))
        pool.remove(i)
    return rng.sample(pool, k)


def generate_extended_triplets(
    dataset,
    name2caption: Dict[str, str],
    *,
    k: int = 1,
    prompt_ids: Sequence[int] = (0,),
    refer_only: bool = False,
    total_cap: int = 0,
    i2i_ranks: Optional[np.ndarray] = None,
    rank_lo: int = -1,
    rank_hi: int = -1,
    llm_rewrite: Optional[Callable[[str, str], str]] = None,
    seed: Optional[int] = None,
) -> List[dict]:
    """Core generation loop (ref get_fiq/get_cirr). `dataset` is a train
    'relative' CIRDataset; `refer_only` restricts anchors to images that are
    references in some original triplet (`--refer`)."""
    rng = random.Random(seed)
    refer_names = {t["reference_name"] for t in dataset.triplets}
    names = dataset.imagenames
    n = len(names)
    out: List[dict] = []
    for i, name1 in enumerate(names):
        if refer_only and name1 not in refer_names:
            continue
        if name1 not in name2caption:
            continue
        for j in sample_partners(i, n, k, rng, i2i_ranks, rank_lo, rank_hi):
            name2 = names[j]
            if name2 not in name2caption:
                continue
            caption1, caption2 = name2caption[name1], name2caption[name2]
            captions = get_captions(caption1, caption2, prompt_ids)
            if dataset.data_name == "fiq":
                out.append({
                    "candidate": name1,
                    "target": name2,
                    "captions": captions,
                    "caption1": caption1,
                    "caption2": caption2,
                })
            else:
                out.append({
                    "reference": name1,
                    "target_hard": name2,
                    "caption": captions,
                    "pairid": 0,
                    "img_set": {"members": ["xxx"]},
                    "caption1": caption1,
                    "caption2": caption2,
                })
    if total_cap > 0 and len(out) > total_cap:
        out = rng.sample(out, total_cap)
    _apply_llm_rewrite(out, llm_rewrite)
    return out


def _apply_llm_rewrite(triplets: List[dict], llm_rewrite) -> None:
    """Attach `llm_caption` to every triplet. A rewriter exposing
    `.rewrite_batch` (the batched LM path) gets the whole list at once
    so prompts amortize into large left-padded device batches; a plain
    callable is invoked per triplet (the reference's one-prompt-per-
    generate loop, zscir/llama_generate.py:64)."""
    if llm_rewrite is None or not triplets:
        return
    batch_fn = getattr(llm_rewrite, "rewrite_batch", None)
    if batch_fn is not None:
        caps = batch_fn([(t["caption1"], t["caption2"]) for t in triplets])
        for t, cap in zip(triplets, caps):
            t["llm_caption"] = cap
    else:
        for t in triplets:
            t["llm_caption"] = llm_rewrite(t["caption1"], t["caption2"])


def write_extended_triplets(dataset, triplets: List[dict], model_tag: str,
                            llm: bool = False) -> str:
    """Write with the reference's exact filenames (quirk SURVEY.md §8.1)."""
    suffix = "_llm" if llm else ""
    if dataset.data_name == "fiq":
        path = os.path.join(dataset.data_path, "captions",
                            f"cap.extend_{model_tag}{suffix}.train.json")
    else:
        path = os.path.join(dataset.data_path, "cirr", "captions",
                            f"cap.rc2.train.extend_{model_tag}{suffix}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps(triplets))
    return path


def generate_cc_triplets(
    cc_items,
    data_name: str = "fiq",
    *,
    k: int = 1,
    prompt_ids: Sequence[int] = (0,),
    total_cap: int = 0,
    llm_rewrite: Optional[Callable[[str, str], str]] = None,
    seed: Optional[int] = None,
) -> List[dict]:
    """Out-of-domain (CC3M-style) triplet generation (ref get_cir_data.get_cc
    :180-223): partners sampled uniformly among the external captioned
    images.

    `cc_items`: captioned it-list entries ({"image_id", "image_path",
    "caption"} — the captioner's CC output), or a {name: caption} dict
    (ids double as paths). Output triplets carry the reference's CC schema —
    full image PATHS in reference/target plus reference_name/target_name
    (get_cir_data.py:205-213): CC images live outside the dataset image
    dirs, so the loader consumes these paths verbatim instead of joining
    names (zscir/data_utils.py:159 `if not use_cc` gate). One schema for
    both datasets."""
    rng = random.Random(seed)
    if isinstance(cc_items, dict):
        cc_items = [{"image_id": k_, "image_path": k_, "caption": v}
                    for k_, v in cc_items.items()]
    n = len(cc_items)
    out: List[dict] = []
    for i, it in enumerate(cc_items):
        for j in sample_partners(i, n, k, rng):
            jt = cc_items[j]
            caption1, caption2 = it["caption"], jt["caption"]
            out.append({
                "reference": it["image_path"],
                "reference_name": it["image_id"],
                "target": jt["image_path"],
                "target_name": jt["image_id"],
                "captions": get_captions(caption1, caption2, prompt_ids),
                "caption1": caption1,
                "caption2": caption2,
            })
    if total_cap > 0 and len(out) > total_cap:
        out = rng.sample(out, total_cap)
    _apply_llm_rewrite(out, llm_rewrite)
    return out


def write_cc_triplets(data_path: str, data_name: str, triplets: List[dict]) -> str:
    """Reference filenames: `get_cir_data.py:216-220` — fiq
    cap.cc.train.json, cirr cap.rc2.train.cc.json (consumed back by
    zscir/data_utils.py:153,190)."""
    if data_name == "fiq":
        path = os.path.join(data_path, "captions", "cap.cc.train.json")
    else:
        path = os.path.join(data_path, "cirr", "captions",
                            "cap.rc2.train.cc.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps(triplets))
    return path
