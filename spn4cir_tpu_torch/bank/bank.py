"""Feature memory banks: the core of "scaling negatives".

Counterpart of `Bank` / `extract_banks` in `spn4cir_tpu/bank/bank.py`
(parity target of both: `extract_bank_features` /
`extract_refer_bank_features`, `clip4cir/models.py:65-107`).

  - One pass of the frozen encoder over the deduplicated unique train
    images yields every bank: the image-keyed refer bank (refer-form
    features), the target bank (normalized features), and the
    triplet-keyed view as `refer[triplet.refer_image_id]`.
  - The target bank lives on the device (it takes part in every step's
    loss); the refer bank stays in host memory as numpy and is gathered per
    batch.
  - The cache is an `.npz` with the keys `refer`, `target`, `refer_key`,
    the same as the JAX package writes: a bank cache written by either
    package loads in the other. It is recomputed only if missing or on
    `reload`. A bfloat16 target is stored widened to float32. The port
    writes it uncompressed (`np.load` reads either): float features do not
    compress (7% in float32), and deflate takes ~0.2 s per MB on a bfloat16
    tower's widened values, minutes for a token-shaped blip4cir refer bank
    (577 x 768 float32 per image).

`extract_fusion_banks` is the caption-aware extraction of blip24cir, whose
refer entries are the fused query states of an (image, caption) pair: keyed
by triplet (`refer_key="triplet"`), or under `--plus` by image, written for
the refer and the target image of each triplet with that triplet's caption.
Its target bank, (M, 32, 256) on the device, covers the refer images too.

Under `--device_preprocess` the image batches are `RawBatch` canvases: they
go to the device as they are, and the caller's encoder, wrapped by
`ops.preprocess.absorb_raw`, runs the resize, crop and normalize there.

`extract_unlabeled_features` / `extend_target_bank` (`--unlabeled`) append
the normalized features of an unlabeled image pool to the target bank as
extra negatives; the pool's cache is an `.npz` with the key `unlabeled`, as
the JAX package writes it.

Spans (`utils.logging.span`, recorded only under the profiler): in each
extractor a batch's ids and pixels going to the device are
`bank.to_device`, its rows coming back into the host buffers
`bank.to_host`; the backbone's encode between them is `bank.encode`.

The JAX package also caches a "prepared" relayout of the target bank (rows
padded to its kernel's block multiple) as a sidecar file. The Hopper
bank-InfoNCE kernels mask the ragged tail themselves, so the port has no
prepared layout and reads or writes no sidecar.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from spn4cir_tpu_torch.ops.preprocess import batch_to_device
from spn4cir_tpu_torch.utils.logging import span
from spn4cir_tpu_torch.utils.tensors import to_host


@dataclasses.dataclass
class Bank:
    """refer: (N, *refer_shape) host array; target: (M, *target_shape)
    device tensor, L2-normalized.

    refer_key: 'image' when refer rows are keyed by unique image id (clip),
    'triplet' when keyed by triplet index."""

    refer: np.ndarray
    target: torch.Tensor
    refer_key: str = "image"

    @property
    def num_images(self) -> int:
        return self.target.shape[0]

    @staticmethod
    def cache_file(path: str) -> str:
        """np.savez appends '.npz' to extensionless paths; the
        exists-check and load must use the same resolved name or the cache
        never hits and the whole train set re-encodes every run."""
        return path if path.endswith(".npz") else path + ".npz"

    def gather_refer(self, batch: dict) -> np.ndarray:
        """Per-batch host gather of refer rows; accepts an iter_train_bank
        batch dict and picks the right key."""
        ids = (batch["refer_image_id"] if self.refer_key == "image"
               else batch["triplet_idx"])
        return self.refer[ids]

    def save(self, path: str) -> None:
        path = Bank.cache_file(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, refer=self.refer, target=to_host(self.target),
                 refer_key=np.asarray(self.refer_key))

    @classmethod
    def load(cls, path: str, device="cpu") -> "Bank":
        data = np.load(cls.cache_file(path))
        key = str(data["refer_key"]) if "refer_key" in data else "image"
        return cls(refer=data["refer"],
                   target=torch.from_numpy(data["target"]).to(device),
                   refer_key=key)


@torch.no_grad()  # not inference_mode: the bank is later saved for backward
def extract_banks(
    bank_features_fn: Callable,
    image_batches: Iterator[Tuple[np.ndarray, np.ndarray]],
    num_images: int,
    cache_path: Optional[str] = None,
    reload: bool = False,
    device="cpu",
) -> Bank:
    """One frozen-encoder pass over unique train images -> Bank.

    bank_features_fn: (images tensor on `device`) -> (refer_feats,
        target_feats) for one batch; target_feats already L2-normalized.
    image_batches: yields (image_ids (B,), images (B, H, W, 3)) as numpy,
        or a RawBatch in place of the images (moved to `device` as one);
        the last batch may be padded — ids < 0 are ignored.
    num_images: M, the unique (deduplicated) train image count.

    Loads `cache_path` unless it is missing or `reload` is set."""
    if cache_path and os.path.exists(Bank.cache_file(cache_path)) and not reload:
        return Bank.load(cache_path, device=device)

    refer_buf = None
    target_buf = None
    for image_ids, images in image_batches:
        with span("bank.to_device"):
            images = batch_to_device(images, device)
        refer, target = bank_features_fn(images)
        with span("bank.to_host"):
            refer, target = to_host(refer), to_host(target)
            if refer_buf is None:
                refer_buf = np.zeros((num_images, *refer.shape[1:]),
                                     refer.dtype)
                target_buf = np.zeros((num_images, *target.shape[1:]),
                                      target.dtype)
            valid = image_ids >= 0
            refer_buf[image_ids[valid]] = refer[valid]
            target_buf[image_ids[valid]] = target[valid]
    if refer_buf is None:
        raise ValueError("no image batches supplied")

    bank = Bank(refer=refer_buf, target=torch.from_numpy(target_buf).to(device),
                refer_key="image")
    if cache_path:
        bank.save(cache_path)
    return bank


@torch.no_grad()
def extract_fusion_banks(
    fusion_features_fn: Callable,
    triplet_batches: Iterator[dict],
    num_triplets: int,
    num_images: int,
    tokenize: Callable,
    cache_path: Optional[str] = None,
    reload: bool = False,
    by_image: bool = False,
    device="cpu",
) -> Bank:
    """Caption-aware bank extraction (the counterpart of the JAX package's
    `extract_fusion_banks`).

    fusion_features_fn: (images, text_ids) tensors on `device` ->
        (refer_form, target_form) for one batch; for blip2 the fusion hidden
        states and the target query features.
    triplet_batches: `iter_train_images` output (the last batch padded, ids
        -1 ignored).
    by_image: False -> refer bank keyed by triplet index; True -> keyed by
        image id, written for both images of each triplet with its caption
        (the --plus path)."""
    if cache_path and os.path.exists(Bank.cache_file(cache_path)) and not reload:
        return Bank.load(cache_path, device=device)

    refer_buf = None
    target_buf = None
    refer_rows = num_images if by_image else num_triplets
    for batch in triplet_batches:
        text_ids = tokenize(batch["captions"])
        with span("bank.to_device"):
            text_ids = torch.from_numpy(text_ids).to(device)
            refer_images = batch_to_device(batch["refer_images"], device)
        refer, target = fusion_features_fn(refer_images, text_ids)
        with span("bank.to_device"):
            target_images = batch_to_device(batch["target_images"], device)
        refer_t, target_t = fusion_features_fn(target_images, text_ids)
        with span("bank.to_host"):
            refer, target = to_host(refer), to_host(target)
            target_t = to_host(target_t)
            if refer_buf is None:
                refer_buf = np.zeros((refer_rows, *refer.shape[1:]),
                                     refer.dtype)
                target_buf = np.zeros((num_images, *target.shape[1:]),
                                      target.dtype)
            valid = batch["triplet_idx"] >= 0
            if by_image:
                refer_buf[batch["refer_image_id"][valid]] = refer[valid]
                refer_buf[batch["target_image_id"][valid]] = to_host(
                    refer_t)[valid]
            else:
                refer_buf[batch["triplet_idx"][valid]] = refer[valid]
            # the target bank covers the refer images too
            target_buf[batch["refer_image_id"][valid]] = target[valid]
            target_buf[batch["target_image_id"][valid]] = target_t[valid]
    if refer_buf is None:
        raise ValueError("no batches supplied")

    bank = Bank(refer=refer_buf, target=torch.from_numpy(target_buf).to(device),
                refer_key="image" if by_image else "triplet")
    if cache_path:
        bank.save(cache_path)
    return bank


@torch.no_grad()
def extract_unlabeled_features(encode_fn: Callable,
                               batches: Iterator[Tuple[np.ndarray, np.ndarray]],
                               num_images: int,
                               cache_path: Optional[str] = None,
                               reload: bool = False,
                               device="cpu") -> np.ndarray:
    """Encode the unlabeled pool -> normalized (U, D) features on the host.
    `encode_fn`: images tensor on `device` -> features; `batches` as in
    `extract_banks`. Cached like the main banks, under the key
    `unlabeled`."""
    if cache_path and os.path.exists(Bank.cache_file(cache_path)) and not reload:
        return np.load(Bank.cache_file(cache_path))["unlabeled"]
    buf = None
    for ids, images in batches:
        with span("bank.to_device"):
            images = batch_to_device(images, device)
        feats = encode_fn(images)
        with span("bank.to_host"):
            feats = to_host(feats)
            if buf is None:
                buf = np.zeros((num_images, *feats.shape[1:]), feats.dtype)
            valid = ids >= 0
            buf[ids[valid]] = feats[valid]
    if buf is None:
        raise ValueError("no unlabeled batches")
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        np.savez_compressed(cache_path, unlabeled=buf)
    return buf


def extend_target_bank(bank: Bank, unlabeled: np.ndarray,
                       neg_num: int = 0) -> Bank:
    """Append unlabeled negatives to the target bank; the positives keep
    their ids in the first rows. `neg_num` > 0 keeps only the first
    `neg_num` unlabeled rows, as the reference does."""
    extra = unlabeled[:neg_num] if neg_num and neg_num > 0 else unlabeled
    extra = torch.from_numpy(np.ascontiguousarray(extra)).to(
        device=bank.target.device, dtype=bank.target.dtype)
    return Bank(refer=bank.refer, target=torch.cat([bank.target, extra]),
                refer_key=bank.refer_key)
