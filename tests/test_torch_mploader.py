"""The port's multi-process loader (`data/mploader.py`) and the
`SPN4CIR_MP_PROCS` routes of its dataset iterators, against the
single-process routes and the JAX package's iterators, on the fixture
images (tests/fixtures.py).

Tolerances: none where both sides decode with the same code (the native
loader in the workers and in this process, here or in the JAX package):
equal to the bit. Against the PIL `ImageTransform`, the JAX package's
mploader test's 2e-2 in normalized units; with `SPN4CIR_NATIVE=0` the
workers decode with PIL and equal it to the bit. Each loader runs at most
2 worker processes on small batches. That the workers import neither
torch nor JAX is checked in test_torch_serve.py::test_port_imports_no_jax.
"""

import glob
import os

import numpy as np
import pytest
from PIL import Image

from spn4cir_tpu.data.datasets import CIRDataset as JaxCIRDataset
from spn4cir_tpu.data.datasets import iter_gallery as jax_iter_gallery
from spn4cir_tpu.data.datasets import iter_train_images as jax_iter_train_images
from spn4cir_tpu.data.transforms import ImageTransform as JaxImageTransform
from spn4cir_tpu.data.transforms import RawStageTransform as JaxRawStageTransform
from spn4cir_tpu_torch.data.datasets import (CIRDataset, iter_gallery,
                                             iter_train_images)
from spn4cir_tpu_torch.data.mploader import MPLoader, batched_paths
from spn4cir_tpu_torch.data.transforms import (ImageTransform, RawBatch,
                                               RawStageTransform,
                                               stage_raw_image)
from spn4cir_tpu_torch.native import NativeLoader, NativeRawStager
from tests.fixtures import make_fiq



@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_fiq(str(tmp_path_factory.mktemp("mp") / "fashionIQ_dataset"),
                    n_images=10)


@pytest.fixture(scope="module")
def image_paths(root):
    paths = sorted(glob.glob(os.path.join(root, "images", "*.png")))
    assert len(paths) >= 10
    return paths


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    monkeypatch.delenv("SPN4CIR_NATIVE", raising=False)
    # set, so that the undo restores whatever was there (the CLIs set it)
    monkeypatch.setenv("SPN4CIR_MP_PROCS", "0")


def _collect(loader, batches):
    out = []
    for arr, n in loader.map_batches(batches):
        out.append(arr[:n].copy())   # the view is recycled at the next step
    return np.concatenate(out)


def test_order_and_parity(image_paths):
    with MPLoader("targetpad", 32, batch_size=4, num_procs=2,
                  threads_per_proc=1) as loader:
        got = _collect(loader, batched_paths(image_paths, 4))
    np.testing.assert_array_equal(
        got, NativeLoader("targetpad", 32).decode_batch(image_paths))
    tf = ImageTransform("targetpad", 32)
    want = np.stack([tf(Image.open(p)) for p in image_paths])
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_workers_fall_back_to_pil(image_paths, monkeypatch):
    monkeypatch.setenv("SPN4CIR_NATIVE", "0")   # the workers inherit it
    with MPLoader("squarepad", 32, batch_size=4, num_procs=2,
                  threads_per_proc=1) as loader:
        got = _collect(loader, batched_paths(image_paths, 4))
    tf = ImageTransform("squarepad", 32)
    np.testing.assert_array_equal(
        got, np.stack([tf(Image.open(p)) for p in image_paths]))


def test_many_batches_recycle_blocks(image_paths):
    """More batches than shared-memory blocks: the free list recycles them,
    in order."""
    batches = batched_paths(image_paths * 3, 4)   # 8 batches, 6 blocks
    with MPLoader("clip", 32, batch_size=4, num_procs=2, prefetch=2,
                  threads_per_proc=1) as loader:
        assert len(loader._shms) < len(batches)
        got = _collect(loader, batches)
    one = NativeLoader("clip", 32).decode_batch(image_paths)
    np.testing.assert_array_equal(got, np.concatenate([one] * 3))


def test_worker_error_reaches_the_caller(image_paths):
    with MPLoader("clip", 32, batch_size=2, num_procs=1,
                  threads_per_proc=1) as loader:
        with pytest.raises(IOError, match="No such file"):
            for _ in loader.map_batches([[image_paths[0],
                                          "/nonexistent.png"]]):
                pass
        # the loader goes on serving after a failed batch
        got = _collect(loader, [image_paths[:2]])
    np.testing.assert_array_equal(
        got, NativeLoader("clip", 32).decode_batch(image_paths[:2]))


def test_raw_mode(image_paths):
    """raw_canvas: uint8 canvases + extents, in order, equal to staging the
    same paths in this process (native and PIL)."""
    with MPLoader("targetpad", 32, batch_size=4, num_procs=2,
                  threads_per_proc=1, raw_canvas=64) as loader:
        canv, ext = [], []
        for batch, n in loader.map_batches(batched_paths(image_paths, 4)):
            assert isinstance(batch, RawBatch)
            assert batch.canvas.dtype == np.uint8
            canv.append(batch.canvas[:n].copy())
            ext.append(batch.extents[:n].copy())
    canv, ext = np.concatenate(canv), np.concatenate(ext)
    want_c, want_e = NativeRawStager("targetpad", 64).stage_batch(image_paths)
    np.testing.assert_array_equal(canv, want_c)
    np.testing.assert_array_equal(ext, want_e)
    for i, p in enumerate(image_paths):
        arr = np.asarray(Image.open(p).convert("RGB"), np.uint8)
        c, e = stage_raw_image(arr, 64, "targetpad")
        np.testing.assert_array_equal(canv[i], c)
        assert tuple(ext[i]) == e


def _datasets(root, mode, raw):
    if raw:
        tf, jtf = (RawStageTransform("targetpad", 32, 64),
                   JaxRawStageTransform("targetpad", 32, 64))
    else:
        tf, jtf = (ImageTransform("targetpad", 32),
                   JaxImageTransform("targetpad", 32))
    split = "train" if mode == "relative" else "val"
    return (CIRDataset("fiq", split, mode, tf, root, ["dress"]),
            JaxCIRDataset("fiq", split, mode, jtf, root, ["dress"]))


def _assert_images_equal(a, b):
    if isinstance(a, RawBatch):
        np.testing.assert_array_equal(a.canvas, b.canvas)
        np.testing.assert_array_equal(a.extents, b.extents)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("raw", [False, True])
def test_iter_gallery_mp_matches_single_process_and_jax(root, monkeypatch,
                                                        raw):
    ds, jds = _datasets(root, "classic", raw)
    single = list(iter_gallery(ds, 4, num_workers=2))
    jax_batches = list(jax_iter_gallery(jds, 4, num_workers=2))
    monkeypatch.setenv("SPN4CIR_MP_PROCS", "2")
    got = list(iter_gallery(ds, 4, num_workers=2))
    assert len(got) == len(single) == len(jax_batches) > 1
    for (ids, a), (ids1, b), (jids, j) in zip(got, single, jax_batches):
        np.testing.assert_array_equal(ids, ids1)
        np.testing.assert_array_equal(ids, jids)
        assert isinstance(a, RawBatch) == raw
        _assert_images_equal(a, b)
        _assert_images_equal(a, j)
    assert (got[-1][0] < 0).any()   # the padded tail keeps its -1 ids


@pytest.mark.parametrize("raw", [False, True])
def test_iter_train_images_mp_matches_single_process_and_jax(
        root, monkeypatch, raw):
    """Stage 1's 2B-row loader batch: the refer and target halves, the
    epoch-seeded captions and every id column as the single-process route
    and the JAX package's iterator give them."""
    ds, jds = _datasets(root, "relative", raw)
    kw = dict(shuffle=True, epoch_seed=3, num_workers=2)
    single = list(iter_train_images(ds, 4, **kw))
    jax_batches = list(jax_iter_train_images(jds, 4, **kw))
    monkeypatch.setenv("SPN4CIR_MP_PROCS", "2")
    got = list(iter_train_images(ds, 4, **kw))
    assert len(got) == len(single) == len(jax_batches) > 0
    for a, b, j in zip(got, single, jax_batches):
        assert a["captions"] == b["captions"] == j["captions"]
        for key in ("triplet_idx", "target_id", "target_image_id",
                    "refer_image_id"):
            np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(a[key], j[key])
        for side in ("refer_images", "target_images"):
            _assert_images_equal(a[side], b[side])
            _assert_images_equal(a[side], j[side])
