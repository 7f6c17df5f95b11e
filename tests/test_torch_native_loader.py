"""The port's native C++ image loader (`spn4cir_tpu_torch/native`) against the
JAX package's and against the PIL pipeline, on images written here from a
seed.

Tolerances: the port's `NativeLoader` / `NativeRawStager` against the JAX
package's: equal to the bit (the same C++ source and flags, built on this
host). Against the PIL `ImageTransform`: the JAX package's loader test's
bounds (every element within 2.5 uint8 steps in normalized units, 99% within
1.5). Raw staging against the PIL staging `stage_raw_image`: equal where
the image is pasted as it is; where it is larger than the canvas and
pre-downscaled first, PIL's fixed-point resample and the float one here
may part by one uint8 step, on at most 0.1% of the elements.
"""

import os

import numpy as np
import pytest
from PIL import Image

from spn4cir_tpu.data.transforms import ImageTransform as JaxImageTransform
from spn4cir_tpu.data.transforms import stage_raw_image as jax_stage_raw_image
from spn4cir_tpu.native import NativeLoader as JaxNativeLoader
from spn4cir_tpu.native import NativeRawStager as JaxNativeRawStager
from spn4cir_tpu_torch import native
from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.data.transforms import (ImageTransform,
                                               RawStageTransform, pad_geometry)
from spn4cir_tpu_torch.native import NativeLoader, NativeRawStager
from tests.fixtures import make_fiq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(64, 48), (48, 64), (100, 40), (57, 57), (33, 47), (200, 80)]


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """PNGs of the sizes above (w, h) and one JPEG, random pixels from
    seed 0."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    paths = []
    for i, (w, h) in enumerate(SIZES):
        p = str(root / f"im{i}.png")
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    jpg = str(root / "im_j.jpg")
    Image.fromarray(rng.randint(0, 256, (50, 70, 3), dtype=np.uint8)).save(
        jpg, quality=95)
    return paths, jpg


def test_library_builds_under_build_native():
    assert native.native_available(), native.build_error()
    lib = native.loaded_library()
    assert os.path.dirname(lib) == os.path.join(REPO, "build", "native")
    assert os.path.basename(lib).startswith("loader-")
    assert not lib.startswith(os.path.join(REPO, "spn4cir_tpu", ""))


@pytest.mark.parametrize("kind", ["clip", "squarepad", "targetpad"])
def test_loader_matches_jax_native_loader_bitwise(image_files, kind):
    paths, jpg = image_files
    got = NativeLoader(kind, 32, num_threads=2).decode_batch(paths + [jpg])
    want = JaxNativeLoader(kind, 32, num_threads=2).decode_batch(paths + [jpg])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["clip", "squarepad", "targetpad"])
def test_loader_matches_pil_pipeline(image_files, kind):
    paths, _ = image_files
    tf = JaxImageTransform(kind, 32)
    got = NativeLoader(kind, 32, num_threads=2).decode_batch(paths)
    want = np.stack([tf(Image.open(p)) for p in paths])
    assert got.shape == want.shape
    scale = 1.0 / min(tf.std)
    diff = np.abs(got - want)
    assert diff.max() < 2.5 / 255.0 * scale, (kind, float(diff.max()))
    assert (diff < 1.5 / 255.0 * scale).mean() > 0.99


def test_jpeg_decodes(image_files):
    _, jpg = image_files
    out = NativeLoader("clip", 32, num_threads=1).decode_batch([jpg])
    assert out.shape == (1, 32, 32, 3) and np.isfinite(out).all()
    want = ImageTransform("clip", 32)(Image.open(jpg))
    assert np.abs(out[0] - want).mean() < 0.1   # two JPEG decoders


def test_missing_file_raises(image_files):
    with pytest.raises(IOError):
        NativeLoader("clip", 32, num_threads=1).decode_batch(
            ["/nonexistent/nope.png"])
    with pytest.raises(IOError):
        NativeRawStager("clip", 64, num_threads=1).stage_batch(
            ["/nonexistent/nope.png"])


def test_threaded_determinism(image_files):
    paths, _ = image_files
    loader = NativeLoader("targetpad", 32, num_threads=4)
    np.testing.assert_array_equal(loader.decode_batch(paths * 4),
                                  loader.decode_batch(paths * 4))
    stager = NativeRawStager("targetpad", 96, num_threads=4)
    a, ea = stager.stage_batch(paths * 4)
    b, eb = stager.stage_batch(paths * 4)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ea, eb)


def test_palette_png_falls_back_per_image(tmp_path):
    """A palette PNG (status 2) goes to the fallback, exactly; an RGB image
    of the same batch stays native; without a fallback the batch raises."""
    rng = np.random.RandomState(0)
    pal = Image.fromarray(rng.randint(0, 8, (40, 70), dtype=np.uint8),
                          mode="P")
    pal.putpalette(list(rng.randint(0, 256, 8 * 3)))
    p_pal = str(tmp_path / "pal.png")
    pal.save(p_pal)
    p_rgb = str(tmp_path / "rgb.png")
    Image.fromarray(rng.randint(0, 256, (40, 70, 3), dtype=np.uint8)).save(
        p_rgb)
    tf = ImageTransform("targetpad", 32)
    out = NativeLoader("targetpad", 32,
                       fallback=lambda p: tf(Image.open(p))).decode_batch(
        [p_pal, p_rgb])
    np.testing.assert_array_equal(out[0], tf(Image.open(p_pal)))
    np.testing.assert_array_equal(
        out[1], NativeLoader("targetpad", 32).decode_batch([p_rgb])[0])
    with pytest.raises(IOError):
        NativeLoader("targetpad", 32).decode_batch([p_pal])
    raw = RawStageTransform("targetpad", 32, 96)
    canv, ext = NativeRawStager(
        "targetpad", 96, fallback=lambda p: raw(Image.open(p))).stage_batch(
        [p_pal])
    want_c, want_e = raw(Image.open(p_pal))
    np.testing.assert_array_equal(canv[0], want_c)
    assert tuple(ext[0]) == tuple(want_e)


@pytest.mark.parametrize("kind", ["clip", "squarepad", "targetpad",
                                  "blip_eval"])
def test_stage_batch_matches_jax_staging(image_files, kind):
    """Canvas 96: the (100, 40) and (200, 80) images are larger than it and
    are pre-downscaled on the host first; the rest are pasted as they
    are."""
    paths, _ = image_files
    got, ext = NativeRawStager(kind, 96, num_threads=2).stage_batch(paths)
    want_n, ext_n = JaxNativeRawStager(kind, 96, num_threads=2).stage_batch(
        paths)
    np.testing.assert_array_equal(got, want_n)
    np.testing.assert_array_equal(ext, ext_n)
    paste_kind = "clip" if kind == "blip_eval" else kind   # as the C++ does
    scaled = 0
    for i, p in enumerate(paths):
        arr = np.asarray(Image.open(p).convert("RGB"), np.uint8)
        want, (ph, pw) = jax_stage_raw_image(arr, 96, paste_kind)
        assert (ext[i, 0], ext[i, 1]) == (ph, pw), (kind, p)
        h, w = arr.shape[:2]
        vp, hp = pad_geometry(h, w, paste_kind)
        if max(h + 2 * vp, w + 2 * hp) <= 96:
            np.testing.assert_array_equal(got[i], want, err_msg=f"{kind} {p}")
        else:
            scaled += 1
            diff = np.abs(got[i].astype(int) - want.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (kind, p)
    assert scaled >= 1   # (200, 80) > 96 whatever the pad


def test_stage_batch_into_preallocated(image_files):
    paths, _ = image_files
    stager = NativeRawStager("targetpad", 64, num_threads=1)
    out = np.zeros((8, 64, 64, 3), np.uint8)
    ext = np.zeros((8, 2), np.int32)
    got, gext = stager.stage_batch(paths[:3], out[:3], ext[:3])
    assert got.base is out and gext.base is ext
    assert out[:3].any() and (ext[:3] > 0).all()
    assert not out[3:].any()
    buf = np.zeros((4, 32, 32, 3), np.float32)
    loader = NativeLoader("clip", 32, num_threads=1)
    res = loader.decode_batch(paths[:3], buf[:3])
    assert res.base is buf and not buf[3].any()
    np.testing.assert_array_equal(buf[:3], loader.decode_batch(paths[:3]))


@pytest.fixture(scope="module")
def fiq_root(tmp_path_factory):
    return make_fiq(str(tmp_path_factory.mktemp("fiq_native")))


def test_dataset_takes_the_native_loader(fiq_root, monkeypatch):
    monkeypatch.delenv("SPN4CIR_NATIVE", raising=False)
    ds = CIRDataset("fiq", "val", "classic", ImageTransform("targetpad", 32),
                    fiq_root, ["dress"])
    assert isinstance(ds.native_loader(), NativeLoader)
    raw = CIRDataset("fiq", "val", "classic",
                     RawStageTransform("targetpad", 32, 64), fiq_root,
                     ["dress"])
    assert isinstance(raw.native_loader(), NativeRawStager)
    # blip_eval resizes straight to (dim, dim): no C++ kind, PIL decodes
    blip = CIRDataset("fiq", "val", "classic", ImageTransform("blip_eval", 32),
                      fiq_root, ["dress"])
    assert blip.native_loader() is None


def test_dataset_falls_back_only_when_unavailable(fiq_root, monkeypatch):
    """SPN4CIR_NATIVE=0 or an unavailable library: PIL. Any other error in
    building the loader raises instead of falling back."""
    tf = ImageTransform("targetpad", 32)
    monkeypatch.setenv("SPN4CIR_NATIVE", "0")
    assert CIRDataset("fiq", "val", "classic", tf, fiq_root,
                      ["dress"]).native_loader() is None
    monkeypatch.delenv("SPN4CIR_NATIVE")
    monkeypatch.setattr(native, "native_available", lambda: False)
    assert CIRDataset("fiq", "val", "classic", tf, fiq_root,
                      ["dress"]).native_loader() is None
    monkeypatch.undo()
    monkeypatch.delenv("SPN4CIR_NATIVE", raising=False)

    def broken(*args, **kwargs):
        raise RuntimeError("loader_create failed")

    monkeypatch.setattr(native, "NativeLoader", broken)
    ds = CIRDataset("fiq", "val", "classic", tf, fiq_root, ["dress"])
    with pytest.raises(RuntimeError, match="loader_create failed"):
        ds.native_loader()
