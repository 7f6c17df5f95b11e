"""The port's device preprocess (`ops/preprocess.py`) against the JAX
package's (`spn4cir_tpu/ops/preprocess.py`) on the CPU, and against the PIL
host pipeline, on uint8 images made with numpy from a seed.

Tolerances. Against JAX: no element more than one uint8 step apart in
normalized units (1 / 255 / 0.2613), and at most 0.1% of the elements more
than 1e-5 apart (the two packages sum the same float32 products in another
order, which can move a value across the uint8 rounding). Dynamic against
static on a uniform batch: the same. Against PIL: the JAX package's
`test_preprocess_device.py` bounds (mean within 2 steps of 1 / 255 / 0.26,
every element within 16; for an image pre-downscaled to fit the canvas, 3
and 24).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from spn4cir_tpu.ops import preprocess as jpp
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.ops import preprocess as tpp

STEP = 1.0 / 255.0 / 0.2613
KINDS = ["targetpad", "squarepad", "clip", "blip_eval"]
SIZES = [(48, 64), (100, 40), (37, 53), (64, 48), (32, 32), (41, 90)]


def _assert_within_one_step(got, want):
    diff = np.abs(got - want)
    assert diff.max() <= STEP, float(diff.max() / STEP)
    assert (diff > 1e-5).mean() <= 1e-3, float((diff > 1e-5).mean())


def _images(seed, sizes=SIZES):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]


def _stage(images, canvas, kind):
    canv, ext = zip(*(tpp.stage_raw_image(im, canvas, kind) for im in images))
    return np.stack(canv), np.asarray(ext, np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_dynamic_matches_jax_mixed_sizes(kind):
    canv, ext = _stage(_images(0), 128, kind)
    want = np.asarray(jpp.preprocess_batch_dynamic(
        jnp.asarray(canv), jnp.asarray(ext), 32, kind))
    got = tpp.preprocess_batch_dynamic(torch.from_numpy(canv),
                                       torch.from_numpy(ext), 32, kind)
    assert got.dtype == torch.float32 and got.shape == (len(SIZES), 32, 32, 3)
    _assert_within_one_step(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hw", [(48, 64), (100, 40), (57, 57)])
def test_static_matches_jax(kind, hw):
    src = np.random.RandomState(1).randint(0, 256, (3, *hw, 3), np.uint8)
    want = np.asarray(jpp.preprocess_batch(jnp.asarray(src), 32, kind))
    got = tpp.preprocess_batch(torch.from_numpy(src), 32, kind)
    _assert_within_one_step(got.numpy(), want)


def test_dynamic_at_the_clip_geometry_matches_jax():
    """ViT-B/32's 224 from a canvas of 448, the CLI's default, on images of
    CIRR-like sizes (a downscale on both axes, and an upscale)."""
    images = _images(2, [(300, 420), (448, 336), (150, 190)])
    canv, ext = _stage(images, 448, "targetpad")
    want = np.asarray(jpp.preprocess_batch_dynamic(
        jnp.asarray(canv), jnp.asarray(ext), 224, "targetpad"))
    got = tpp.preprocess_batch_dynamic(torch.from_numpy(canv), ext, 224,
                                       "targetpad")
    _assert_within_one_step(got.numpy(), want)


@pytest.mark.parametrize("kind", ["targetpad", "squarepad", "clip"])
def test_dynamic_matches_static_on_a_uniform_batch(kind):
    src = np.random.RandomState(3).randint(0, 256, (3, 48, 64, 3), np.uint8)
    static = tpp.preprocess_batch(torch.from_numpy(src), 32, kind)
    canv, ext = _stage(list(src), 96, kind)
    dynamic = tpp.preprocess_batch_dynamic(torch.from_numpy(canv), ext, 32,
                                           kind)
    _assert_within_one_step(dynamic.numpy(), static.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_dynamic_close_to_pil(kind):
    images = _images(4, [(48, 64), (100, 40), (37, 53), (64, 48), (32, 32)])
    canv, ext = _stage(images, 128, kind)
    got = tpp.preprocess_batch_dynamic(torch.from_numpy(canv), ext, 32,
                                       kind).numpy()
    tf = ImageTransform(kind, 32)
    want = np.stack([tf(Image.fromarray(im)) for im in images])
    scale = 1.0 / 0.26
    assert np.abs(got - want).mean() < 2.0 / 255.0 * scale
    assert np.abs(got - want).max() < 16.0 / 255.0 * scale


@pytest.mark.parametrize("kind", ["targetpad", "squarepad", "clip"])
def test_static_close_to_pil(kind):
    src = np.random.RandomState(5).randint(0, 256, (3, 48, 64, 3), np.uint8)
    got = tpp.preprocess_batch(torch.from_numpy(src), 32, kind).numpy()
    tf = ImageTransform(kind, 32)
    want = np.stack([tf(Image.fromarray(s)) for s in src])
    scale = 1.0 / 0.26
    assert np.abs(got - want).mean() < 2.0 / 255.0 * scale
    assert np.abs(got - want).max() < 16.0 / 255.0 * scale


def test_oversized_image_is_predownscaled_then_close_to_pil():
    im = _images(6, [(300, 120)])[0]
    canvas, (ph, pw) = tpp.stage_raw_image(im, 128, "targetpad")
    assert canvas.shape == (128, 128, 3) and max(ph, pw) <= 128
    got = tpp.preprocess_batch_dynamic(
        torch.from_numpy(canvas[None]), [[ph, pw]], 32, "targetpad")[0]
    want = ImageTransform("targetpad", 32)(Image.fromarray(im))
    scale = 1.0 / 0.26
    assert np.abs(got.numpy() - want).mean() < 3.0 / 255.0 * scale
    assert np.abs(got.numpy() - want).max() < 24.0 / 255.0 * scale


def test_a_minus_0_75_kernel_fails_the_jax_bound(monkeypatch):
    """torch's bicubic constant (a = -0.75) in place of Keys' -0.5 moves
    outputs by more than one uint8 step: the parity bound tells the two
    kernels apart."""
    def cubic_075(x):
        a = -0.75
        near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
        far = ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a
        return near * (x <= 1.0) + far * ((x > 1.0) & (x < 2.0))

    canv, ext = _stage(_images(0), 128, "targetpad")
    want = np.asarray(jpp.preprocess_batch_dynamic(
        jnp.asarray(canv), jnp.asarray(ext), 32, "targetpad"))
    monkeypatch.setattr(tpp, "_keys_cubic", cubic_075)
    got = tpp.preprocess_batch_dynamic(torch.from_numpy(canv), ext, 32,
                                       "targetpad").numpy()
    with pytest.raises(AssertionError):
        _assert_within_one_step(got, want)
    # and torch's own bicubic resize (a = -0.75, no antialias) is further
    # still from the host pipeline's geometry on a downscale
    x = torch.from_numpy(canv[:1, :48, :64]).permute(0, 3, 1, 2).float()
    ref = tpp.preprocess_batch(torch.from_numpy(canv[:1, :48, :64]), 32,
                               "clip")
    interp = torch.nn.functional.interpolate(x, size=(32, 43), mode="bicubic",
                                             align_corners=False)
    interp = torch.clamp(torch.round(interp), 0, 255)[:, :, :, 5:37]
    interp = tpp._normalize(interp.permute(0, 2, 3, 1), tpp.CLIP_MEAN,
                            tpp.CLIP_STD)
    assert np.abs(interp.numpy() - ref.numpy()).max() > STEP


def test_tf32_stays_off_inside_and_is_restored():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        seen = []
        real = torch.einsum

        def spy(*args):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return real(*args)

        torch.einsum = spy
        try:
            canv, ext = _stage(_images(7, [(40, 50)]), 64, "clip")
            tpp.preprocess_batch_dynamic(torch.from_numpy(canv), ext, 32,
                                         "clip")
        finally:
            torch.einsum = real
        assert seen == [False, False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_encode_with_fused_preprocess_and_absorb_raw():
    from spn4cir_tpu_torch.models.clip4cir import ClipCIR
    from tests.torch_fixtures import synthetic_tokenizer

    torch.manual_seed(0)
    bb = ClipCIR("test-tiny", tokenizer=synthetic_tokenizer())
    bb.init_params(torch.Generator().manual_seed(0))
    bb.eval()
    src = np.random.RandomState(8).randint(0, 256, (2, 40, 52, 3), np.uint8)
    with torch.inference_mode():
        feats = tpp.encode_with_fused_preprocess(bb, torch.from_numpy(src))
        assert feats.shape == (2, bb.embed_dim)
        np.testing.assert_allclose(feats.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
        canv, ext = _stage(list(src), 64, "targetpad")
        raw = tpp.batch_to_device(tpp.RawBatch(canv, ext), "cpu")
        absorbed = tpp.absorb_raw(bb.gallery_features, bb.input_dim,
                                  "targetpad")
        want = bb.gallery_features(tpp.preprocess_batch_dynamic(
            raw.canvas, raw.extents, bb.input_dim, "targetpad"))
        torch.testing.assert_close(absorbed(raw), want, rtol=0, atol=0)
        x = torch.randn(2, bb.input_dim, bb.input_dim, 3)
        torch.testing.assert_close(absorbed(x), bb.gallery_features(x),
                                   rtol=0, atol=0)
