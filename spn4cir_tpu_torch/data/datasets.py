"""CIR datasets: FashionIQ + CIRR triplet/gallery loading (host side).

Parity target: the reference's `CIRDataset` (`clip4cir/data_utils.py:122-327`
and its five near-identical copies — implemented once here, SURVEY.md §1).
Covered semantics:
  - FIQ `cap.{dress}.{split}.json` + `split.{dress}.{split}.json`; CIRR
    `cirr/captions/cap.rc2.{split}.json` + `cirr/image_splits/split.rc2.*`.
  - `plus`/`llmcap` extended triplets with the per-backbone filename infix
    (`cap.extend_{suffix}[_llm].train.json`, quirk SURVEY.md §8.1).
  - train-time id maps `targetname2id` / `imagename2id` built in triplet
    order (refs before targets), and the `optimized_images.json` dedup map
    override (`data_utils.py:220-247`).
  - modes: 'relative' (triplets; indices-only when `use_bank`), 'classic'
    (gallery), 'test1' (pairid + query), plus the negplus 'unlabeled' mode.
  - FIQ caption randomization only for original triplets (`index < N`,
    quirk §8.7); extended triplets use random.choice.
  - Knowingly fixed (quirk §8.6): CIRR classic-mode images resolve under
    `data_path` instead of the reference's hardcoded repo-relative path.

No torch DataLoader: the batch iterators below yield fixed-shape numpy
batches (padded, with id -1 sentinels), and image decode runs on a thread
pool.

A copy of `spn4cir_tpu/data/datasets.py`, name for name, with the PIL /
thread-pool decode only: the native C++ loader, the multi-process loader
and the raw staging for a device preprocess are not ported yet. The same
paths and seeds give the same batches as the JAX package's module.
"""

from __future__ import annotations

import json
import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from spn4cir_tpu_torch.data.transforms import (
    ImageTransform,
    deterministic_fiq_caption,
    generate_randomized_fiq_caption,
)

DRESS_TYPES = ("dress", "shirt", "toptee")


class CIRDataset:
    def __init__(
        self,
        data_name: str,
        split: str,
        mode: str,
        preprocess,
        data_path: str = "./",
        dress_types: Optional[Sequence[str]] = None,
        plus: bool = False,
        llmcap: bool = False,
        extend_suffix: str = "clip",
        use_cc: bool = False,
        fiq_val_type: int = 0,
        val_ret_train: bool = False,
        seed: Optional[int] = None,
        replace_extended: bool = False,
    ):
        """`replace_extended` reproduces the zscir loaders' zero-shot train
        semantics: the generated triplets (cap.extend_zs / cap.cc) REPLACE
        the human train triplets instead of extending them, and load
        unconditionally on the train split — the reference has no flag gate
        (`zscir/data_utils.py:151-157`, `data_utils_bank.py:152-158`
        assign, where `clip4cir/data_utils.py:152-162` appends). Without
        it, "zero-shot" training would silently see human CIR labels."""
        if dress_types is None:
            dress_types = list(DRESS_TYPES)
        for dt in dress_types:
            assert dt in DRESS_TYPES, dt
        assert data_name in ("fiq", "cirr"), data_name
        assert mode in ("relative", "classic", "unlabeled"), mode
        self.data_name = data_name
        self.split = split
        self.mode = mode
        self.preprocess = preprocess
        self.data_path = data_path
        self.dress_types = list(dress_types)
        self.use_bank = False
        self.fiq_val_type = fiq_val_type
        self.val_ret_train = val_ret_train
        self._rng = random.Random(seed)
        self.seed = seed

        self.triplets: List[dict] = []
        self.targetname2id: Dict[str, int] = {}
        self.imagename2id: Dict[str, int] = {}
        self.imagenames: List[str] = []
        self.imagepaths: List[str] = []

        self._replace_extended = replace_extended
        self._cc_name2path: Dict[str, str] = {}
        if data_name == "fiq":
            self._load_fiq(plus, llmcap, extend_suffix, use_cc)
        else:
            self._load_cirr(plus, llmcap, extend_suffix, use_cc)

        if split == "train":
            self._build_id_maps()
        if mode == "unlabeled":
            self._build_unlabeled()

    # ------------------------------------------------------------------
    def _load_fiq(self, plus, llmcap, extend_suffix, use_cc):
        cap_dir = os.path.join(self.data_path, "captions")
        self.image_path = os.path.join(self.data_path, "images")
        raw: List[dict] = []
        for dt in self.dress_types:
            with open(os.path.join(cap_dir, f"cap.{dt}.{self.split}.json")) as f:
                raw.extend(json.load(f))
        self.N = len(raw)
        cc_internal = None
        if self.split == "train" and (plus or self._replace_extended):
            if use_cc:
                # reference CC schema: triplets carry full external image
                # PATHS (zscir/data_utils.py:159 skips the name join)
                cc_internal = self._cc_triplets(
                    self._load_extend_file(
                        os.path.join(cap_dir, "cap.cc.train.json")), llmcap)
                if self._replace_extended:
                    raw = []
                    self.N = 0  # cc captions pick by random.choice (:267)
            else:
                name = (f"cap.extend_{extend_suffix}"
                        f"{'_llm' if llmcap else ''}.train.json")
                extend = self._load_extend_file(os.path.join(cap_dir, name))
                if llmcap:
                    for t in extend:
                        t["captions"] = [t["llm_caption"]]
                if self._replace_extended:
                    # zscir: generated triplets ARE the train set. The fiq
                    # two-caption randomization applies to the generated
                    # template variants (zscir getitem :252-254) — N spans
                    # them.
                    raw = extend
                    self.N = len(raw)
                else:
                    raw.extend(extend)
        self.triplets = [
            {
                "reference": os.path.join(self.image_path, f"{t['candidate']}.png"),
                "reference_name": t["candidate"],
                "target": os.path.join(self.image_path, f"{t['target']}.png"),
                "target_name": t["target"],
                "captions": t["captions"],
            }
            for t in raw
        ]
        if cc_internal is not None:
            self.triplets.extend(cc_internal)
        self.image_names: List[str] = []
        for dt in self.dress_types:
            with open(os.path.join(self.data_path, "image_splits",
                                   f"split.{dt}.{self.split}.json")) as f:
                self.image_names.extend(json.load(f))
        if self.fiq_val_type == 1 and self.split == "val":
            # VAL-set gallery: only images appearing in val triplets
            # (ref data_utils.py:178-183, fiq_val_type=1)
            seen = []
            seen_set = set()
            for t in self.triplets:
                for n in (t["reference_name"], t["target_name"]):
                    if n not in seen_set:
                        seen_set.add(n)
                        seen.append(n)
            self._gallery_names = seen
        else:
            self._gallery_names = self.image_names
        self._gallery_paths = [
            os.path.join(self.image_path, f"{n}.png") for n in self._gallery_names
        ]

    def _cc_triplets(self, entries: List[dict],
                     llmcap: bool = False) -> List[dict]:
        """CC triplets to the internal form. They already carry full image
        paths (ref get_cir_data.py:205-213) — record a name→path map so
        bank extraction resolves CC images without the dataset-dir join.
        `llmcap` substitutes the LLaMA-rewritten caption, same as the
        in-domain extended files."""
        for t in entries:
            self._cc_name2path[t["reference_name"]] = t["reference"]
            self._cc_name2path[t["target_name"]] = t["target"]

        def caps(t):
            if llmcap:
                return [t["llm_caption"]]
            return (t["captions"] if isinstance(t["captions"], list)
                    else [t["captions"]])

        return [{
            "reference": t["reference"],
            "reference_name": t["reference_name"],
            "target": t["target"],
            "target_name": t["target_name"],
            "captions": caps(t),
            "pairid": t.get("pairid", 0),
            "group_members": ["xxx"],
        } for t in entries]

    def _load_extend_file(self, path: str) -> List[dict]:
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            if self._replace_extended:
                # the reference crashes the same way here, just less
                # helpfully: zs training has no human-triplet fallback
                raise FileNotFoundError(
                    f"{path} not found — zero-shot training runs on "
                    "GENERATED triplets only (reference "
                    "zscir/data_utils.py:151-157); run the datagen "
                    "pipeline (captioner -> srm -> get_cir_data) first")
            raise

    def _load_cirr(self, plus, llmcap, extend_suffix, use_cc):
        cap_dir = os.path.join(self.data_path, "cirr", "captions")
        splits_dir = os.path.join(self.data_path, "cirr", "image_splits")
        self.image_path = self.data_path
        with open(os.path.join(cap_dir, f"cap.rc2.{self.split}.json")) as f:
            raw = json.load(f)
        with open(os.path.join(splits_dir, f"split.rc2.{self.split}.json")) as f:
            self.name_to_relpath: Dict[str, str] = json.load(f)
        self.N = len(raw)
        cc_internal = None
        if self.split == "train" and (plus or self._replace_extended):
            if use_cc:
                cc_internal = self._cc_triplets(
                    self._load_extend_file(
                        os.path.join(cap_dir, "cap.rc2.train.cc.json")),
                    llmcap)
                if self._replace_extended:
                    raw = []
                    self.N = 0
            else:
                name = (f"cap.rc2.train.extend_{extend_suffix}"
                        f"{'_llm' if llmcap else ''}.json")
                extend = self._load_extend_file(os.path.join(cap_dir, name))
                if llmcap:
                    for t in extend:
                        t["caption"] = [t["llm_caption"]]
                if self._replace_extended:
                    # zscir cirr: generated-only train set (data_utils.py:
                    # 184-193 assignment)
                    raw = extend
                    self.N = len(raw)
                else:
                    raw.extend(extend)
        self.triplets = [
            {
                "reference": os.path.join(self.image_path, self.name_to_relpath[t["reference"]]),
                "reference_name": t["reference"],
                "target": (os.path.join(self.image_path, self.name_to_relpath[t["target_hard"]])
                           if "target_hard" in t else ""),
                "target_name": t.get("target_hard", ""),
                "captions": [t["caption"]] if isinstance(t["caption"], str) else t["caption"],
                "pairid": t["pairid"],
                "group_members": t["img_set"]["members"],
            }
            for t in raw
        ]
        if cc_internal is not None:
            self.triplets.extend(cc_internal)
        self._gallery_names = list(self.name_to_relpath.keys())
        self._gallery_paths = [
            os.path.join(self.image_path, self.name_to_relpath[n])
            for n in self._gallery_names
        ]

    def _build_id_maps(self):
        """Insertion-ordered id maps (ref data_utils.py:220-242) and the
        optional dedup override from optimized_images.json (:243-247)."""
        tid = 0
        iid = 0
        for t in self.triplets:
            rn, tn = t["reference_name"], t["target_name"]
            if tn not in self.targetname2id:
                self.targetname2id[tn] = tid
                tid += 1
            if rn not in self.imagename2id:
                self.imagename2id[rn] = iid
                iid += 1
                self.imagenames.append(rn)
            if tn not in self.imagename2id:
                self.imagename2id[tn] = iid
                iid += 1
                self.imagenames.append(tn)
        def _path_for(n: str) -> str:
            # CC images carry their own (external) paths
            if n in self._cc_name2path:
                return self._cc_name2path[n]
            if self.data_name == "fiq":
                return os.path.join(self.image_path, f"{n}.png")
            return os.path.join(self.image_path, self.name_to_relpath[n])

        self.imagepaths = [_path_for(n) for n in self.imagenames]
        opt = os.path.join(self.data_path, "optimized_images.json")
        if os.path.exists(opt):
            with open(opt) as f:
                self.imagenames, self.imagepaths, self.imagename2id = json.load(f)
            # the dedup map covers only DATASET images; re-append CC names
            # (external paths) or the first --use_cc batch KeyErrors on its
            # imagename2id lookup
            for n, p in self._cc_name2path.items():
                if n not in self.imagename2id:
                    self.imagename2id[n] = len(self.imagenames)
                    self.imagenames.append(n)
                    self.imagepaths.append(p)

    def _build_unlabeled(self):
        """Unlabeled negative pool (negplus ablation,
        ref clip4cir/data_utils_negplus.py:231-245): FIQ = split images not in
        any triplet; CIRR = split images not in triplets + external images
        listed in coco_image.json (paths)."""
        self.unlabeled_imagepaths: List[str] = []
        if self.data_name == "fiq":
            for name in self.image_names:
                if name not in self.imagename2id:
                    self.unlabeled_imagepaths.append(
                        os.path.join(self.image_path, f"{name}.png"))
        else:
            known = set(self.imagenames)
            for name, rel in self.name_to_relpath.items():
                if name not in known:
                    self.unlabeled_imagepaths.append(
                        os.path.join(self.image_path, rel))
            coco = os.path.join(self.data_path, "coco_image.json")
            if os.path.exists(coco):
                with open(coco) as f:
                    self.unlabeled_imagepaths.extend(json.load(f))

    # ------------------------------------------------------------------
    @property
    def num_unique_images(self) -> int:
        return len(self.imagenames)

    @property
    def gallery_names(self) -> List[str]:
        return self._gallery_names

    @property
    def gallery_paths(self) -> List[str]:
        return self._gallery_paths

    def load_image(self, path: str) -> np.ndarray:
        return self.preprocess(Image.open(path))

    def caption_for(self, index: int, train: bool,
                    epoch_seed: Optional[int] = None) -> str:
        """Caption selection incl. the original-vs-extended boundary
        (ref data_utils.py:262-268 and quirk §8.7).

        With `epoch_seed`, the draw is a STATELESS function of
        (dataset seed, epoch_seed, index) — a mid-epoch resume that skips
        batches reproduces exactly the captions the uninterrupted run saw
        (a sequential rng stream would shift every later draw). Without it
        (the __getitem__ reference-parity path) the sequential stream is
        used, matching the reference's torch-DataLoader behavior."""
        captions = self.triplets[index]["captions"]
        if len(captions) <= 1:
            return captions[0]
        if not train:
            return deterministic_fiq_caption(captions)
        rng = (random.Random(((self.seed or 0) * 1_000_003
                              + int(epoch_seed) * 8191 + index)
                             ) if epoch_seed is not None else self._rng)
        if self.data_name == "fiq" and index < self.N:
            return generate_randomized_fiq_caption(captions, rng=rng)
        return rng.choice(captions)

    def __len__(self) -> int:
        if self.mode == "relative":
            return len(self.triplets)
        return len(self._gallery_names)

    def __getitem__(self, index: int):
        """Reference-parity item access (useful for tests; the training and
        eval paths use the batch iterators below)."""
        if self.mode == "relative":
            t = self.triplets[index]
            if self.split == "train":
                caption = self.caption_for(index, train=True)
                row = (
                    caption,
                    index,
                    self.targetname2id[t["target_name"]],
                    self.imagename2id[t["target_name"]],
                    self.imagename2id[t["reference_name"]],
                )
                if self.use_bank:
                    return row
                return (self.load_image(t["reference"]), caption,
                        self.load_image(t["target"]), *row[1:])
            if self.split == "val" and self.val_ret_train:
                # retrieval-training on the val split: images + the pinned
                # deterministic caption branch (ref data_utils.py:276-285,
                # generate_randomized_fiq_caption(type=0))
                caption = (generate_randomized_fiq_caption(t["captions"], type=0)
                           if len(t["captions"]) > 1 else t["captions"][0])
                return (self.load_image(t["reference"]), caption,
                        self.load_image(t["target"]))
            if self.split == "val":
                if self.data_name == "fiq":
                    return t["reference_name"], t["target_name"], t["captions"]
                return (t["reference_name"], t["target_name"], t["captions"][0],
                        t["group_members"])
            if self.split == "test1":
                return (t["pairid"], t["reference_name"], t["captions"][0],
                        t["group_members"])
            raise ValueError(self.split)
        # classic / unlabeled
        name = self._gallery_names[index]
        return name, self.load_image(self._gallery_paths[index])


# ---------------------------------------------------------------------------
# Batch iterators (fixed shapes, -1 id padding)
# ---------------------------------------------------------------------------

def _decode_batch(dataset: CIRDataset, paths: Sequence[str],
                  pool: Optional[ThreadPoolExecutor]):
    if pool is not None:
        return np.stack(list(pool.map(dataset.load_image, paths)))
    return np.stack([dataset.load_image(p) for p in paths])


def _iter_image_paths(dataset: CIRDataset, paths: Sequence[str],
                      batch_size: int, num_workers: int
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shared (ids, images) scan over a path list; the final batch is padded
    by repeating the last image with id -1 (keep-all eval with fixed
    shapes)."""
    pool = ThreadPoolExecutor(num_workers) if num_workers else None
    try:
        for start in range(0, len(paths), batch_size):
            chunk = paths[start : start + batch_size]
            ids = np.arange(start, start + len(chunk))
            pad = batch_size - len(chunk)
            if pad:
                chunk = list(chunk) + [chunk[-1]] * pad
                ids = np.concatenate([ids, np.full(pad, -1, np.int64)])
            yield ids, _decode_batch(dataset, chunk, pool)
    finally:
        if pool:
            pool.shutdown()


def iter_gallery(dataset: CIRDataset, batch_size: int, num_workers: int = 4
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(ids, images) over the gallery."""
    yield from _iter_image_paths(dataset, dataset.gallery_paths, batch_size,
                                 num_workers)


def iter_unique_images(dataset: CIRDataset, batch_size: int, num_workers: int = 4
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(image_ids, images) over the deduplicated unique train images — the
    bank-extraction scan (SURVEY.md §7: one pass replaces the reference's
    three)."""
    yield from _iter_image_paths(dataset, dataset.imagepaths, batch_size,
                                 num_workers)


def iter_train_bank(dataset: CIRDataset, batch_size: int, *,
                    shuffle: bool = True, drop_last: bool = True,
                    epoch_seed: int = 0, start_step: int = 0
                    ) -> Iterator[dict]:
    """Bank-mode training batches: no image decode in the epoch loop
    (ref data_utils.py:269-275 + train.py:101). Yields dicts with captions
    (list of str) and int64 arrays triplet_idx / target_id / target_image_id
    / refer_image_id. `start_step` skips the first batches of the epoch
    (mid-epoch resume: same epoch_seed reconstructs the shuffle, the skip
    restarts exactly where the checkpoint left off)."""
    order = np.arange(len(dataset.triplets))
    if shuffle:
        np.random.RandomState(epoch_seed).shuffle(order)
    n = len(order)
    stop = n - (n % batch_size) if drop_last else n
    for start in range(start_step * batch_size, stop, batch_size):
        idxs = order[start : start + batch_size]
        rows = [dataset.triplets[i] for i in idxs]
        yield {
            "captions": [dataset.caption_for(int(i), train=True,
                                             epoch_seed=epoch_seed)
                         for i in idxs],
            "triplet_idx": idxs.astype(np.int64),
            "target_id": np.array(
                [dataset.targetname2id[r["target_name"]] for r in rows], np.int64),
            "target_image_id": np.array(
                [dataset.imagename2id[r["target_name"]] for r in rows], np.int64),
            "refer_image_id": np.array(
                [dataset.imagename2id[r["reference_name"]] for r in rows], np.int64),
        }


def iter_relative_eval(dataset: CIRDataset, batch_size: int,
                       gallery_names: Optional[Sequence[str]] = None
                       ) -> Iterator[dict]:
    """Validation/test query batches: reference/target names resolved to
    gallery ids on host (replacing the reference's name_to_feat string dict,
    `clip4cir/validate.py:64`). Yields captions + refer_gid/target_gid (+
    member_gids & pairid for CIRR).

    `gallery_names` must be the name list of the index the gids will be
    used against — e.g. the VAL-subset gallery under --fiq_val_type 1 —
    defaulting to this dataset's own gallery list."""
    if gallery_names is None:
        gallery_names = dataset.gallery_names
    name2gid = {n: i for i, n in enumerate(gallery_names)}
    n = len(dataset.triplets)
    for start in range(0, n, batch_size):
        rows = dataset.triplets[start : start + batch_size]
        batch = {
            "captions": [
                dataset.caption_for(start + j, train=False) for j in range(len(rows))
            ],
            "refer_gid": np.array([name2gid[r["reference_name"]] for r in rows], np.int64),
            "target_gid": np.array(
                [name2gid.get(r["target_name"], -1) for r in rows], np.int64),
        }
        if dataset.data_name == "cirr":
            batch["member_gids"] = np.array(
                [[name2gid[m] for m in r["group_members"]] for r in rows], np.int64)
            batch["pairid"] = np.array([r.get("pairid", 0) for r in rows], np.int64)
        yield batch


def iter_train_images(dataset: CIRDataset, batch_size: int, *,
                      num_workers: int = 4, shuffle: bool = False,
                      epoch_seed: int = 0, start_step: int = 0
                      ) -> Iterator[dict]:
    """Image-mode relative train batches (reference-mode __getitem__ without
    use_bank, ref data_utils.py:276-283): decoded refer/target images +
    caption + all id columns. Used by stage-1 training and the blip2
    caption-aware bank extraction. The final batch is padded (ids -1).
    `start_step` skips whole batches WITHOUT decoding their images —
    mid-epoch resume for the live-encode stage-1 epochs."""
    n = len(dataset.triplets)
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(epoch_seed).shuffle(order)

    def step_meta(start):
        """(captions, refer_paths, target_paths, id columns) for one step —
        host-side metadata, shared by both decode routes."""
        idxs = order[start : start + batch_size]
        rows = [dataset.triplets[i] for i in idxs]
        pad = batch_size - len(rows)
        captions = [dataset.caption_for(int(i), train=True,
                                        epoch_seed=epoch_seed)
                    for i in idxs]
        refer_paths = [r["reference"] for r in rows]
        target_paths = [r["target"] for r in rows]
        ids = {
            "triplet_idx": idxs.astype(np.int64),
            "target_id": np.array(
                [dataset.targetname2id[r["target_name"]] for r in rows], np.int64),
            "target_image_id": np.array(
                [dataset.imagename2id[r["target_name"]] for r in rows], np.int64),
            "refer_image_id": np.array(
                [dataset.imagename2id[r["reference_name"]] for r in rows], np.int64),
        }
        if pad:
            captions += [captions[-1]] * pad
            refer_paths += [refer_paths[-1]] * pad
            target_paths += [target_paths[-1]] * pad
            ids = {k: np.concatenate([v, np.full(pad, -1, np.int64)])
                   for k, v in ids.items()}
        return captions, refer_paths, target_paths, ids

    starts = list(range(start_step * batch_size, n, batch_size))

    pool = ThreadPoolExecutor(num_workers) if num_workers else None
    try:
        for start in starts:
            captions, refer_paths, target_paths, ids = step_meta(start)
            yield {
                "captions": captions,
                "refer_images": _decode_batch(dataset, refer_paths, pool),
                "target_images": _decode_batch(dataset, target_paths, pool),
                **ids,
            }
    finally:
        if pool:
            pool.shutdown()


def iter_unlabeled(dataset: CIRDataset, batch_size: int, num_workers: int = 4
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(ids, images) over the unlabeled negative pool (ids are positions in
    `unlabeled_imagepaths`; padded tail ids are -1)."""
    yield from _iter_image_paths(dataset, dataset.unlabeled_imagepaths,
                                 batch_size, num_workers)
