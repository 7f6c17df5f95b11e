"""Device image preprocess (pad -> resize -> crop -> normalize) on tensors.

Counterpart of `spn4cir_tpu/ops/preprocess.py`. The host pipeline
(`data/transforms.py`, PIL; `native/`, C++) decodes and resizes on the CPU;
under `--device_preprocess` the host only decodes and pastes each padded
image into a fixed uint8 canvas (`RawStageTransform`, `NativeRawStager`)
and the resize, crop and normalize run here, on the tensors' device, ahead
of the encoder. It moves the resize off the host CPU; it saves no PCIe
bytes (a 448^2 x 3 uint8 canvas is the size of the 224^2 x 3 float32 image
it replaces).

The resampler is Keys' cubic with a = -0.5, antialiased on a downscale (the
kernel widened by the scale), as `jax.image.resize` and PIL have it, written
as explicit per-image (C, dim) weight matrices: one product over the rows
and one over the columns, in float32 with TF32 off (a TF32 product would
move values across the uint8 rounding), then PIL's uint8 intermediate
(round half to even, clip). `torch.nn.functional.interpolate(mode=
"bicubic")` is another kernel (a = -0.75, no antialias) and is not used.
The two products hold no Pallas kernel in the JAX package and are plain
`torch.einsum` here too.

`preprocess_batch` takes one source size for the batch and mirrors
`jax.image.resize`'s weights; `preprocess_batch_dynamic` takes per-image
padded extents on a common canvas, taps past an image's extent masked and
its rows renormalized (the production path). For a uniform batch the two
agree up to float32 noise.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from spn4cir_tpu_torch.data.transforms import (  # noqa: F401 (re-export)
    CLIP_MEAN,
    CLIP_STD,
    RawBatch,
    RawStageTransform,
    pad_geometry,
    stage_raw_image,
)
from spn4cir_tpu_torch.utils.tensors import ieee_fp32


def _normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x / 255.0 - mean_t) / std_t


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) float32 weights of `jax.image.resize`'s cubic
    with antialias (`jax._src.image.scale.compute_weight_mat`, translation
    0): output j samples input position (j + 0.5) / scale - 0.5."""
    scale = torch.tensor(out_size / in_size, dtype=torch.float32)
    inv_scale = (1.0 / scale).to(device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    x = x / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, 0.0, w)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    valid = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(valid[None, :], w, 0.0)


def preprocess_batch(images_u8: torch.Tensor, dim: int,
                     kind: str = "targetpad", target_ratio: float = 1.25,
                     mean: Sequence[float] = CLIP_MEAN,
                     std: Sequence[float] = CLIP_STD) -> torch.Tensor:
    """(B, H, W, 3) uint8 of one source size -> (B, dim, dim, 3) float32
    normalized, on the tensor's device. The pad geometry is that of the
    host pipeline for this source size."""
    b, h, w, c = images_u8.shape
    x = images_u8.float()
    vp = hp = 0
    if kind == "squarepad":
        side = max(w, h)
        hp, vp = (side - w) // 2, (side - h) // 2
    elif kind == "targetpad" and max(w, h) / min(w, h) >= target_ratio:
        scaled = max(w, h) / target_ratio
        hp = max(int((scaled - w) / 2), 0)
        vp = max(int((scaled - h) / 2), 0)
    if hp or vp:
        x = torch.nn.functional.pad(x, (0, 0, hp, hp, vp, vp))
        h, w = h + 2 * vp, w + 2 * hp
    if w <= h:
        rw, rh = dim, max(1, int(dim * h / w))
    else:
        rw, rh = max(1, int(dim * w / h)), dim
    top = max(int(round((rh - dim) / 2.0)), 0)
    left = max(int(round((rw - dim) / 2.0)), 0)
    wy = _resize_weights(h, rh, x.device)[:, top: top + dim]
    wx = _resize_weights(w, rw, x.device)[:, left: left + dim]
    with ieee_fp32():
        x = torch.einsum("bhwk,hd->bdwk", x, wy)
        x = torch.einsum("bywk,wd->bydk", x, wx)
    return _normalize(torch.clamp(torch.round(x), 0.0, 255.0), mean, std)


# ---------------------------------------------------------------------------
# Per-image geometry on a common canvas: the production device path. The
# host pastes each padded image at the canvas origin and ships its padded
# extent; each image's separable weights come from that extent, with the
# taps past it masked and the rows renormalized: `jax.image.resize`'s
# boundary handling (a plain resize of the canvas would blend in the zero
# border and differ at the image's edges).
# ---------------------------------------------------------------------------


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, a = -0.5 (jax.image's 'cubic' and PIL's)."""
    out = ((1.5 * x - 2.5) * x * x + 1.0) * (x <= 1.0)
    return out + (((-0.5 * x + 2.5) * x - 4.0) * x + 2.0) * (
        (x > 1.0) & (x < 2.0))


def _dyn_axis_weights(canvas: int, dim: int, true_in: torch.Tensor,
                      out_full: torch.Tensor, crop0: torch.Tensor
                      ) -> torch.Tensor:
    """(B, canvas, dim) weights of one image axis. true_in: (B,) padded
    extents; out_full: (B,) resized extents rh / rw; crop0: (B,) crop
    offsets top / left. Output column j samples input position
    (j + crop0 + 0.5) * true_in / out_full - 0.5: the resize composed with
    the center crop; the kernel widens by the inverse scale on a
    downscale."""
    true_f = true_in.float()[:, None, None]
    inv_scale = true_f / out_full.float()[:, None, None]
    sample = (torch.arange(dim, dtype=torch.float32, device=true_in.device)
              + crop0[:, None, None] + 0.5) * inv_scale - 0.5   # (B, 1, dim)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    idx = torch.arange(canvas, dtype=torch.float32,
                       device=true_in.device)[None, :, None]    # (1, C, 1)
    w = _keys_cubic((sample - idx).abs() / kernel_scale)
    w = torch.where(idx < true_f, w, 0.0)          # taps past the image
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1e-6, w / total, 0.0)   # edge renorm
    valid = (sample >= -0.5) & (sample <= true_f - 0.5)
    return torch.where(valid, w, 0.0)


def _dyn_geometry(h: torch.Tensor, w: torch.Tensor, dim: int, kind: str):
    """(B,) resize extents rh, rw and crop offsets top, left from the padded
    extents: the integer arithmetic of transforms.resize_shortest /
    center_crop (int() truncation as floor division, Python's round as
    round half to even)."""
    if kind == "blip_eval":
        full = torch.full_like(h, dim)
        zero = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        return full, full, zero, zero
    short_w = w <= h
    rh = torch.where(short_w, torch.clamp((dim * h) // w, min=1),
                     torch.full_like(h, dim))
    rw = torch.where(short_w, torch.full_like(w, dim),
                     torch.clamp((dim * w) // h, min=1))
    top = torch.round((rh - dim).float() / 2.0)
    left = torch.round((rw - dim).float() / 2.0)
    return rh, rw, top, left


def preprocess_batch_dynamic(canvas_u8: torch.Tensor, extents, dim: int,
                             kind: str = "targetpad",
                             mean: Sequence[float] = CLIP_MEAN,
                             std: Sequence[float] = CLIP_STD) -> torch.Tensor:
    """(B, C, C, 3) uint8 canvases + (B, 2) padded extents (H, W) ->
    (B, dim, dim, 3) float32 normalized, on the canvases' device.

    The canvas holds each PADDED image at the origin (the host applies the
    SquarePad / TargetPad offsets when pasting; 'clip' / 'blip_eval' paste
    the image as it is), zeros elsewhere."""
    c = canvas_u8.shape[1]
    ext = torch.as_tensor(extents, device=canvas_u8.device).to(torch.int32)
    h, w = ext[:, 0], ext[:, 1]
    rh, rw, top, left = _dyn_geometry(h, w, dim, kind)
    wy = _dyn_axis_weights(c, dim, h, rh, top)    # (B, C, dim)
    wx = _dyn_axis_weights(c, dim, w, rw, left)   # (B, C, dim)
    x = canvas_u8.float()
    with ieee_fp32():
        x = torch.einsum("bcd,bcwk->bdwk", wy, x)   # rows:    (B, dim, C, 3)
        x = torch.einsum("bwd,bywk->bydk", wx, x)   # columns: (B, dim, dim, 3)
    x = torch.clamp(torch.round(x), 0.0, 255.0)     # PIL's uint8 intermediate
    return _normalize(x, mean, std)


def batch_to_device(images, device):
    """A host batch on `device`: a (B, H, W, 3) float32 array as a tensor,
    a RawBatch as a RawBatch of tensors."""
    if isinstance(images, RawBatch):
        return RawBatch(torch.from_numpy(images.canvas).to(device),
                        torch.from_numpy(np.asarray(images.extents)).to(device))
    return torch.from_numpy(images).to(device)


def absorb_raw(fn, input_dim: int, kind: str):
    """Wrap an encoder `fn(images, *rest)` so that a RawBatch image argument
    (canvases on the device) is preprocessed here first: the bank
    extraction's hook for `--device_preprocess`. A float32 image tensor
    passes through as it is."""

    def wrapped(images, *rest):
        if isinstance(images, RawBatch):
            images = preprocess_batch_dynamic(images.canvas, images.extents,
                                              input_dim, kind)
        return fn(images, *rest)

    return wrapped


def index_features_from_raw(backbone, canvas_u8: torch.Tensor, extents, *,
                            kind: str = "targetpad"):
    """The device preprocess, then the gallery / index encoder:
    `backbone.index_features` of the staged canvases."""
    x = preprocess_batch_dynamic(canvas_u8, extents, backbone.input_dim, kind)
    return backbone.index_features(x)


def encode_with_fused_preprocess(backbone, images_u8: torch.Tensor, *,
                                 kind: str = "targetpad",
                                 target_ratio: float = 1.25) -> torch.Tensor:
    """`preprocess_batch` of a uniform-size uint8 batch, then the gallery
    encoder."""
    x = preprocess_batch(images_u8, backbone.input_dim, kind, target_ratio)
    return backbone.gallery_features(x)
