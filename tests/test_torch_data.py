"""The port's copies of the host modules against the JAX package's own:
transforms, datasets, prefetch and the BPE tokenizer give the same arrays,
ids and batches on `tests/fixtures.py` data and the synthetic merges table.

The JAX package's datasets decode through its native C++ loader when that
builds; the port's copy has the PIL path only, so the JAX side is pinned to
PIL with SPN4CIR_NATIVE=0. Tolerance: exact equality (the code is the
same); tokenizer ids are compared between the port's pure-Python BPE and
the JAX package's tokenizer on the same merges.
"""

import numpy as np
import pytest
from PIL import Image

from spn4cir_tpu.data import datasets as jds
from spn4cir_tpu.data import transforms as jtf
from spn4cir_tpu.data.prefetch import prefetch as jax_prefetch
from spn4cir_tpu.tokenizer import bpe as jbpe
from spn4cir_tpu_torch.data import datasets as tds
from spn4cir_tpu_torch.data import transforms as ttf
from spn4cir_tpu_torch.data.prefetch import prefetch
from spn4cir_tpu_torch.tokenizer import bpe as tbpe
from tests.fixtures import make_cirr, make_fiq
from tests.torch_fixtures import CORPUS, synthetic_merges, write_merges_file


@pytest.fixture(autouse=True)
def _pil_decode(monkeypatch):
    monkeypatch.setenv("SPN4CIR_NATIVE", "0")


def _image(rng, w, h):
    return Image.fromarray(rng.randint(0, 255, (h, w, 3)).astype(np.uint8))


@pytest.mark.parametrize("kind", ["clip", "squarepad", "targetpad", "blip_eval"])
@pytest.mark.parametrize("size", [(40, 40), (90, 31), (23, 77)])
def test_image_transform_equal(kind, size, rng):
    img = _image(rng, *size)
    want = jtf.ImageTransform(kind, 32)(img)
    got = ttf.ImageTransform(kind, 32)(img)
    assert got.dtype == want.dtype and got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, want)


def test_raw_stage_and_captions_equal(rng):
    img = _image(rng, 100, 37)
    want_c, want_e = jtf.RawStageTransform("targetpad", 32, 64)(img)
    got_c, got_e = ttf.RawStageTransform("targetpad", 32, 64)(img)
    np.testing.assert_array_equal(got_c, want_c)
    assert got_e == want_e
    caps = ["is red.", "has long sleeves, "]
    for t in range(4):
        assert (ttf.generate_randomized_fiq_caption(caps, type=t)
                == jtf.generate_randomized_fiq_caption(caps, type=t))
    assert (ttf.deterministic_fiq_caption(caps)
            == jtf.deterministic_fiq_caption(caps))


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            pairs = [(g[k], w[k]) for k in w]
        else:
            pairs = list(zip(g, w))
        for a, b in pairs:
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


@pytest.mark.parametrize("data_name", ["fiq", "cirr"])
def test_train_dataset_and_iterators_equal(data_name, tmp_path):
    make = make_fiq if data_name == "fiq" else make_cirr
    root = make(str(tmp_path / data_name))
    kw = dict(plus=True, extend_suffix="clip", seed=3)
    jd = jds.CIRDataset(data_name, "train", "relative",
                        jtf.ImageTransform("targetpad", 32), root, ["dress"], **kw)
    td = tds.CIRDataset(data_name, "train", "relative",
                        ttf.ImageTransform("targetpad", 32), root, ["dress"], **kw)
    assert td.triplets == jd.triplets
    assert td.imagenames == jd.imagenames and td.imagepaths == jd.imagepaths
    assert td.imagename2id == jd.imagename2id
    assert td.targetname2id == jd.targetname2id
    assert td.num_unique_images == jd.num_unique_images
    for epoch_seed in (0, 5):
        _same_batches(
            tds.iter_train_bank(td, 4, epoch_seed=epoch_seed),
            jds.iter_train_bank(jd, 4, epoch_seed=epoch_seed))
    _same_batches(tds.iter_train_bank(td, 4, epoch_seed=1, start_step=1),
                  jds.iter_train_bank(jd, 4, epoch_seed=1, start_step=1))
    _same_batches(tds.iter_unique_images(td, 5, num_workers=2),
                  jds.iter_unique_images(jd, 5, num_workers=0))
    _same_batches(tds.iter_train_images(td, 4, num_workers=0, shuffle=True,
                                        epoch_seed=2),
                  jds.iter_train_images(jd, 4, num_workers=0, shuffle=True,
                                        epoch_seed=2))


@pytest.mark.parametrize("data_name", ["fiq", "cirr"])
def test_val_dataset_and_iterators_equal(data_name, tmp_path):
    make = make_fiq if data_name == "fiq" else make_cirr
    root = make(str(tmp_path / data_name))
    datasets = {}
    for mod, tf in ((jds, jtf), (tds, ttf)):
        t = tf.ImageTransform("squarepad", 32)
        datasets[mod] = (
            mod.CIRDataset(data_name, "val", "classic", t, root, ["dress"]),
            mod.CIRDataset(data_name, "val", "relative", t, root, ["dress"]))
    (jc, jr), (tc, tr) = datasets[jds], datasets[tds]
    assert tc.gallery_names == jc.gallery_names
    assert tc.gallery_paths == jc.gallery_paths
    assert len(tc) == len(jc) and len(tr) == len(jr)
    _same_batches(tds.iter_gallery(tc, 4, num_workers=0),
                  jds.iter_gallery(jc, 4, num_workers=0))
    _same_batches(tds.iter_relative_eval(tr, 3, gallery_names=tc.gallery_names),
                  jds.iter_relative_eval(jr, 3, gallery_names=jc.gallery_names))
    name, image = tc[1]
    jname, jimage = jc[1]
    assert name == jname
    np.testing.assert_array_equal(image, jimage)


def test_fiq_val_type_1_gallery_equal(tmp_path):
    root = make_fiq(str(tmp_path / "fiq"))
    t = ttf.ImageTransform("clip", 32)
    td = tds.CIRDataset("fiq", "val", "classic", t, root, ["dress"],
                        fiq_val_type=1)
    jd = jds.CIRDataset("fiq", "val", "classic", t, root, ["dress"],
                        fiq_val_type=1)
    assert td.gallery_names == jd.gallery_names


def test_prefetch_equal_and_propagates_errors():
    items = [np.arange(i) for i in range(7)]
    got, want = list(prefetch(iter(items), 2)), list(jax_prefetch(iter(items), 2))
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

    def broken():
        yield 1
        raise KeyError("boom")

    out = prefetch(broken(), 1)
    assert next(out) == 1
    with pytest.raises(KeyError, match="boom"):
        next(out)


TEXTS = list(CORPUS) + [
    "A Zebra's  stripes &amp; 12 dots!!", "", "naïve café — ünïcode ✓",
    "word " * 100]


def test_bpe_ids_equal_on_synthetic_merges():
    merges = synthetic_merges()
    jt, tt = jbpe.ClipTokenizer(merges=merges), tbpe.ClipTokenizer(merges=merges)
    assert tt.vocab_size == jt.vocab_size
    assert (tt.sot_id, tt.eot_id) == (jt.sot_id, jt.eot_id)
    for text in TEXTS:
        assert tt.encode(text) == jt._encode_py(text)
        assert tt.decode(tt.encode(text)) == jt.decode(jt._encode_py(text))
    assert tt.encode_batch(TEXTS) == [jt._encode_py(t) for t in TEXTS]
    want = jbpe.tokenize(TEXTS, truncate=True, tokenizer=jt)
    got = tbpe.tokenize(TEXTS, truncate=True, tokenizer=tt)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="too long"):
        tbpe.tokenize(TEXTS, tokenizer=tt)
    assert tbpe.fits_context(TEXTS[0], tokenizer=tt)
    assert not tbpe.fits_context(TEXTS[-1], tokenizer=tt)


def test_bpe_vocab_env_is_read_when_the_tokenizer_is_built(tmp_path, monkeypatch):
    """SPN4CIR_BPE_VOCAB set after the module was imported still counts."""
    path = write_merges_file(str(tmp_path / "merges.txt.gz"))
    monkeypatch.setenv("SPN4CIR_BPE_VOCAB", path)
    tok = tbpe.ClipTokenizer()
    ref = tbpe.ClipTokenizer(merges=synthetic_merges())
    assert tok.encode(TEXTS[0]) == ref.encode(TEXTS[0])
    monkeypatch.setenv("SPN4CIR_BPE_VOCAB", str(tmp_path / "missing.gz"))
    with pytest.raises(FileNotFoundError, match="SPN4CIR_BPE_VOCAB"):
        tbpe.ClipTokenizer(str(tmp_path / "also_missing.gz"))
