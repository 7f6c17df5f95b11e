"""Host-side image transforms with reference-parity geometry.

Parity targets (see SURVEY.md §2.1): `SquarePad` / `TargetPad` /
`squarepad_transform` / `targetpad_transform` / `generate_randomized_fiq_caption`
in `clip4cir/data_utils.py:20-119`. These run on host (PIL) and emit float32
HWC arrays. A copy of `spn4cir_tpu/data/transforms.py` (numpy + PIL only), kept
name for name; the port imports nothing of the JAX package. The raw-staging
half (`RawStageTransform`) feeds the device preprocess of
`ops/preprocess.py` (`--device_preprocess`).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple

import numpy as np
from PIL import Image

# OpenAI-CLIP normalization constants; BLIP/LAVIS processors use the same.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
DEFAULT_TARGET_RATIO = 1.25


def square_pad(image: Image.Image) -> Image.Image:
    """Zero-pad to a square of side max(w, h), centered (ref data_utils.py:20-39)."""
    w, h = image.size
    side = max(w, h)
    hp = int((side - w) / 2)
    vp = int((side - h) / 2)
    return _pad(image, hp, vp)


def target_pad(image: Image.Image, target_ratio: float = DEFAULT_TARGET_RATIO) -> Image.Image:
    """Pad only when aspect ratio >= target_ratio, down to that ratio
    (ref data_utils.py:42-65, including the int-floor and `< ratio` boundary)."""
    w, h = image.size
    actual_ratio = max(w, h) / min(w, h)
    if actual_ratio < target_ratio:
        return image
    scaled_max_wh = max(w, h) / target_ratio
    hp = max(int((scaled_max_wh - w) / 2), 0)
    vp = max(int((scaled_max_wh - h) / 2), 0)
    return _pad(image, hp, vp)


def _pad(image: Image.Image, hp: int, vp: int) -> Image.Image:
    if hp == 0 and vp == 0:
        return image
    mode = image.mode
    canvas = Image.new(mode, (image.size[0] + 2 * hp, image.size[1] + 2 * vp), 0)
    canvas.paste(image, (hp, vp))
    return canvas


def resize_shortest(image: Image.Image, dim: int) -> Image.Image:
    """torchvision `Resize(dim)` semantics: shortest side -> dim, keep aspect
    (long side uses int() truncation, matching torchvision's PIL backend)."""
    w, h = image.size
    if w <= h:
        new_w, new_h = dim, max(1, int(dim * h / w))
    else:
        new_w, new_h = max(1, int(dim * w / h)), dim
    return image.resize((new_w, new_h), Image.BICUBIC)


def center_crop(image: Image.Image, dim: int) -> Image.Image:
    w, h = image.size
    if w < dim or h < dim:  # torchvision pads when smaller than crop
        hp = max((dim - w + 1) // 2, 0)
        vp = max((dim - h + 1) // 2, 0)
        image = _pad(image, hp, vp)
        w, h = image.size
    left = int(round((w - dim) / 2.0))
    top = int(round((h - dim) / 2.0))
    return image.crop((left, top, left + dim, top + dim))


def normalize_to_array(
    image: Image.Image,
    mean: Sequence[float] = CLIP_MEAN,
    std: Sequence[float] = CLIP_STD,
) -> np.ndarray:
    """RGB-convert + [0,1] scale + normalize -> float32 HWC."""
    arr = np.asarray(image.convert("RGB"), dtype=np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


@dataclass(frozen=True)
class ImageTransform:
    """A picklable preprocess pipeline: pad -> resize -> crop -> normalize.

    kind: 'clip' (no pad), 'squarepad', or 'targetpad'
    (ref `clip4cir/train.py` `--transform` flag semantics), or 'blip_eval'
    (direct square bicubic resize, the LAVIS BlipImageEvalProcessor used by
    the reference captioner, lavis/processors/blip_processors.py:167-179).
    """

    kind: str
    dim: int
    target_ratio: float = DEFAULT_TARGET_RATIO
    mean: Tuple[float, ...] = CLIP_MEAN
    std: Tuple[float, ...] = CLIP_STD

    def __call__(self, image: Image.Image) -> np.ndarray:
        if self.kind == "blip_eval":
            image = image.convert("RGB").resize((self.dim, self.dim),
                                                Image.BICUBIC)
            return normalize_to_array(image, self.mean, self.std)
        if self.kind == "squarepad":
            image = square_pad(image)
        elif self.kind == "targetpad":
            image = target_pad(image, self.target_ratio)
        elif self.kind != "clip":
            raise ValueError(f"unknown transform kind {self.kind!r}")
        image = resize_shortest(image, self.dim)
        image = center_crop(image, self.dim)
        return normalize_to_array(image, self.mean, self.std)


# ---------------------------------------------------------------------------
# Raw staging for the device preprocess: the host only decodes and pastes
# the padded image into a fixed uint8 canvas; resize+crop+normalize run on
# the device (ops/preprocess.py).
# ---------------------------------------------------------------------------


def pad_geometry(h: int, w: int, kind: str,
                 target_ratio: float = DEFAULT_TARGET_RATIO):
    """Host-side pad offsets (vp, hp) for pasting a decoded (h, w) image
    into the canvas — the same int-floor arithmetic as square_pad/target_pad
    (ref data_utils.py:20-39 / :42-65)."""
    if kind == "squarepad":
        side = max(w, h)
        return int((side - h) / 2), int((side - w) / 2)
    if kind == "targetpad":
        mx, mn = max(w, h), min(w, h)
        if mx / mn >= target_ratio:
            scaled = mx / target_ratio
            return max(int((scaled - h) / 2), 0), max(int((scaled - w) / 2), 0)
    return 0, 0


def stage_raw_image(img_u8: np.ndarray, canvas: int, kind: str,
                    target_ratio: float = DEFAULT_TARGET_RATIO):
    """Host (PIL/numpy) raw staging: decoded uint8 HWC image ->
    (canvas, canvas, 3) uint8 + (H, W) padded extents. Oversized images
    (padded extent > canvas) are PIL-bicubic pre-downscaled so the padded
    extent fits — a documented two-stage-resize numeric delta for those
    images only."""
    h, w = img_u8.shape[:2]
    vp, hp = pad_geometry(h, w, kind, target_ratio)
    ph, pw = h + 2 * vp, w + 2 * hp
    if max(ph, pw) > canvas:
        scale = canvas / max(ph, pw)
        nh = max(1, int(h * scale))
        nw = max(1, int(w * scale))
        img = Image.fromarray(img_u8).resize((nw, nh), Image.BICUBIC)
        img_u8 = np.asarray(img, np.uint8)
        h, w = nh, nw
        vp, hp = pad_geometry(h, w, kind, target_ratio)
        vp, hp = min(vp, (canvas - h) // 2), min(hp, (canvas - w) // 2)
        ph, pw = h + 2 * vp, w + 2 * hp
    out = np.zeros((canvas, canvas, 3), np.uint8)
    out[vp: vp + h, hp: hp + w] = img_u8
    return out, (ph, pw)


class RawBatch(NamedTuple):
    """A staged uint8 batch for the on-device preprocess: (B, C, C, 3)
    canvases + (B, 2) int32 padded extents. Iterators yield this in place
    of the (B, dim, dim, 3) float32 array when the dataset's preprocess is
    a RawStageTransform; consumers dispatch on the type."""

    canvas: np.ndarray
    extents: np.ndarray


@dataclass(frozen=True)
class RawStageTransform:
    """Host half of the device-preprocess split: decode + pad-paste into a
    uint8 canvas; the resize/crop/normalize half runs on the device
    (ops/preprocess.py:preprocess_batch_dynamic). Carries the
    full geometry so the device side can be derived from the transform
    alone. `canvas` must be >= dim; images whose padded extent exceeds it
    are host-downscaled first (see stage_raw_image)."""

    kind: str
    dim: int
    canvas: int
    target_ratio: float = DEFAULT_TARGET_RATIO
    mean: Tuple[float, ...] = CLIP_MEAN
    std: Tuple[float, ...] = CLIP_STD

    def __post_init__(self):
        if self.kind not in ("clip", "squarepad", "targetpad", "blip_eval"):
            raise ValueError(f"unknown transform kind {self.kind!r}")
        if self.canvas < self.dim:
            raise ValueError(f"canvas {self.canvas} < dim {self.dim}")

    def __call__(self, image: Image.Image):
        arr = np.asarray(image.convert("RGB"), np.uint8)
        return stage_raw_image(arr, self.canvas, self.kind, self.target_ratio)

    def host_equivalent(self) -> "ImageTransform":
        """The all-host pipeline this splits (for parity checks/fallbacks)."""
        return ImageTransform(self.kind, self.dim, self.target_ratio,
                              self.mean, self.std)


def targetpad_transform(target_ratio: float, dim: int, **kw) -> ImageTransform:
    return ImageTransform("targetpad", dim, target_ratio, **kw)


def squarepad_transform(dim: int, **kw) -> ImageTransform:
    return ImageTransform("squarepad", dim, **kw)


def clip_transform(dim: int, **kw) -> ImageTransform:
    return ImageTransform("clip", dim, **kw)


_STRIP_CHARS = ".?, "


def generate_randomized_fiq_caption(captions: Sequence[str], rng: random.Random | None = None,
                                    type: int = -1) -> str:
    """FashionIQ two-caption randomization (ref data_utils.py:101-119).

    Draw in [0,1): <0.25 -> "a and b"; <0.5 -> "b and a"; <0.75 -> a; else b.
    `type` pins the branch deterministically (0..3), as in the reference.
    """
    draw = {0: 0.12, 1: 0.37, 2: 0.62, 3: 0.88}.get(type)
    if draw is None:
        draw = (rng or random).random()
    a, b = captions[0].strip(_STRIP_CHARS), captions[1].strip(_STRIP_CHARS)
    if draw < 0.25:
        return f"{a} and {b}"
    if draw < 0.5:
        return f"{b} and {a}"
    if draw < 0.75:
        return a
    return b


def deterministic_fiq_caption(captions: Sequence[str]) -> str:
    """Validation-time concat (ref `clip4cir/validate.py:73-79`)."""
    return f"{captions[0].strip(_STRIP_CHARS)} and {captions[1].strip(_STRIP_CHARS)}"
