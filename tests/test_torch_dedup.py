"""The port's image dedup (datagen/dedup.py, cli/deduplicate_images.py)
against the JAX package's.

A synthetic CIRR tree with planted duplicates: some images are re-saved
under other names with their pixels unchanged but their bytes not (another
PNG compression level, and one as RGBA). Both packages' `deduplicate` run
over their own copy of the train dataset must write `same_image_list.json`
and `optimized_images.json` byte for byte alike; the port's CLI writes the
same files, and its `CIRDataset` reads the map back. Both run over the
same tree, one after the other (the first one's files removed before the
second reads the tree).
"""

import os

import pytest
from PIL import Image

from spn4cir_tpu.data.datasets import CIRDataset as JaxCIRDataset
from spn4cir_tpu.data.transforms import ImageTransform as JaxImageTransform
from spn4cir_tpu.datagen import dedup as jdedup
from spn4cir_tpu_torch.cli import deduplicate_images
from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.datagen import dedup as tdedup
from tests.fixtures import make_cirr

FILES = ("same_image_list.json", "optimized_images.json")
# (copy of, name): image `name` gets the pixels of image `copy of`
PLANTED = ((0, 5), (0, 9), (3, 11), (7, 2))


def _planted_tree(root):
    root = make_cirr(root, n_images=14, n_train=12, extended=False)
    dev = os.path.join(root, "dev")
    for src, dst in PLANTED:
        with Image.open(os.path.join(dev, f"cirr_img{src}.png")) as img:
            pixels = img.convert("RGB")
        out = os.path.join(dev, f"cirr_img{dst}.png")
        if dst == 9:
            pixels.convert("RGBA").save(out)
        else:
            pixels.save(out, compress_level=1)
    return root


@pytest.fixture
def root(tmp_path):
    return _planted_tree(str(tmp_path / "cirr_dataset"))


def _read(root):
    out = []
    for name in FILES:
        with open(os.path.join(root, name), "rb") as f:
            out.append(f.read())
    return out


def _jax_files(root):
    """What the JAX `deduplicate` writes over `root`; its files removed."""
    jds = JaxCIRDataset("cirr", "train", "relative",
                        JaxImageTransform("targetpad", 32), root)
    jdedup.deduplicate(jds, root)
    out = _read(root)
    for name in FILES:
        os.remove(os.path.join(root, name))
    return out


def test_json_files_are_byte_identical_to_jax(root):
    want = _jax_files(root)
    tds = CIRDataset("cirr", "train", "relative",
                     ImageTransform("targetpad", 32), root)
    tdedup.deduplicate(tds, root)
    assert _read(root) == want
    groups = tdedup.find_duplicate_groups(tds.imagenames, tds.imagepaths)
    planted = ({0, 5, 9}, {3, 11}, {2, 7})
    present = {int(n[len("cirr_img"):]) for n in tds.imagenames}
    want = {frozenset(s & present) for s in planted if len(s & present) > 1}
    assert want, "the fixture's train set holds no planted pair"
    assert {frozenset(int(n[len("cirr_img"):]) for n in g)
            for g in groups} == want


def test_digest_reads_pixels_not_bytes(root):
    dev = os.path.join(root, "dev")
    a, b = (os.path.join(dev, f"cirr_img{i}.png") for i in (0, 5))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() != fb.read()
    assert tdedup.image_digest(a) == tdedup.image_digest(b) == \
        jdedup.image_digest(a)
    assert tdedup.image_digest(a) != tdedup.image_digest(
        os.path.join(dev, "cirr_img1.png"))


def test_cli_writes_the_map_that_the_dataset_reads(root):
    want = _jax_files(root)
    before = CIRDataset("cirr", "train", "relative", None, root)
    out = deduplicate_images.main(["--dataset", "cirr", "--data_path", root])
    assert out == os.path.join(root, "optimized_images.json")
    assert _read(root) == want
    after = CIRDataset("cirr", "train", "relative", None, root)
    groups = tdedup.find_duplicate_groups(before.imagenames,
                                          before.imagepaths)
    n_dups = sum(len(g) - 1 for g in groups)
    assert n_dups > 0
    assert after.num_unique_images == before.num_unique_images - n_dups
    for group in groups:
        assert len({after.imagename2id[n] for n in group}) == 1
        assert group[0] in after.imagenames
        assert not set(group[1:]) & set(after.imagenames)


def test_build_optimized_images_keeps_the_first_member():
    names = ["a", "b", "c", "d", "e"]
    paths = [f"/x/{n}.png" for n in names]
    groups = [["b", "d"], ["a", "e"]]
    want = jdedup.build_optimized_images(names, paths, groups)
    got = tdedup.build_optimized_images(names, paths, groups)
    assert got == want
    assert got[0] == ["a", "b", "c"]
    assert got[2] == {"a": 0, "b": 1, "c": 2, "d": 1, "e": 0}
    assert tdedup.build_optimized_images(names, paths, []) == (
        names, paths, {n: i for i, n in enumerate(names)})
