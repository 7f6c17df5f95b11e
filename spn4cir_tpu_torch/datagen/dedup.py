"""Image de-duplication -> the `optimized_images.json` dedup map.

The port's own copy of `spn4cir_tpu/datagen/dedup.py` (host code: PIL,
numpy and hashlib, no tensor library). Parity target:
`zscir/deduplicate_images.py`, whose O(N^2) scan compares decoded pixels;
here each image's decoded RGB pixels are hashed once, which finds the same
groups in O(N). Both files come out byte for byte as the JAX package
writes them:
  same_image_list.json : the duplicate groups (lists of image names);
  optimized_images.json: [names, paths, name2id], the canonical image list
      and a map sending every name (duplicates included) to its canonical
      id, which every `CIRDataset` reads (`clip4cir/data_utils.py:243-247`).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image


def image_digest(path: str) -> str:
    """sha256 of the decoded RGB pixels and their shape (not of the file's
    bytes): two encodings of the same pixels hash alike, as the reference's
    pixel-equality test finds them equal."""
    with Image.open(path) as img:
        arr = np.asarray(img.convert("RGB"))
    h = hashlib.sha256()
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def find_duplicate_groups(names: Sequence[str], paths: Sequence[str]
                          ) -> List[List[str]]:
    """The groups of names whose images have equal pixels, each in the
    order of `names`, groups in the order of their first member."""
    by_digest: Dict[str, List[str]] = {}
    for name, path in zip(names, paths):
        by_digest.setdefault(image_digest(path), []).append(name)
    return [group for group in by_digest.values() if len(group) > 1]


def build_optimized_images(
    names: Sequence[str],
    paths: Sequence[str],
    groups: List[List[str]],
) -> Tuple[List[str], List[str], Dict[str, int]]:
    """Keep the first member of each duplicate group and send every member
    to its id (ref deduplicate_images.py check():51-73)."""
    canonical_of: Dict[str, str] = {}
    for group in groups:
        head = group[0]
        for member in group[1:]:
            canonical_of[member] = head
    out_names: List[str] = []
    out_paths: List[str] = []
    name2id: Dict[str, int] = {}
    for name, path in zip(names, paths):
        if name in canonical_of:
            continue
        name2id[name] = len(out_names)
        out_names.append(name)
        out_paths.append(path)
    for dup, head in canonical_of.items():
        name2id[dup] = name2id[head]
    return out_names, out_paths, name2id


def deduplicate(dataset, output_dir: str) -> str:
    """Dedup a train `CIRDataset`'s unique images: writes both JSON files
    into `output_dir` and returns the path of optimized_images.json."""
    groups = find_duplicate_groups(dataset.imagenames, dataset.imagepaths)
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "same_image_list.json"), "w") as f:
        json.dump(groups, f)
    names, paths, name2id = build_optimized_images(
        dataset.imagenames, dataset.imagepaths, groups)
    out = os.path.join(output_dir, "optimized_images.json")
    with open(out, "w") as f:
        json.dump([names, paths, name2id], f)
    return out
