"""The port's case-study and generic-retrieval tools (eval/cases.py,
eval/generic_retrieval.py) and their entry points (cli.validate_case,
cli.analysis_case, cli.retrieval) against the JAX package's.

Both sides run CLIP `test-tiny` with the JAX package's random weights
carried into the port (`clip_state_dict_from_jax`) and the synthetic BPE
table (tests/torch_fixtures.py), on synthetic FashionIQ and CIRR trees
(tests/fixtures.py); the JAX side decodes with PIL (`SPN4CIR_NATIVE=0`),
as the port does.

What must be equal: every case record (caption, names, the target's rank,
the top-k names), the comparison and the exported files, and the i2i / t2i
indices; the encoded features agree within 1e-4 (float32 towers in another
order). `i2i_topk` is also held to the JAX function on scores with
deliberate ties.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from spn4cir_tpu.data.datasets import CIRDataset as JaxCIRDataset
from spn4cir_tpu.data.transforms import ImageTransform as JaxImageTransform
from spn4cir_tpu.eval import cases as jcases
from spn4cir_tpu.eval import generic_retrieval as jgr
from spn4cir_tpu.eval import retrieval as jretrieval
from spn4cir_tpu.models.api import build_backbone as jax_build_backbone
from spn4cir_tpu.tokenizer.bpe import tokenize as jax_tokenize
from spn4cir_tpu_torch.cli import analysis_case, retrieval as cli_retrieval
from spn4cir_tpu_torch.cli.validate_case import validate_case_main
from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.eval import cases as tcases
from spn4cir_tpu_torch.eval import generic_retrieval as tgr
from spn4cir_tpu_torch.eval import retrieval
from spn4cir_tpu_torch.models.clip4cir import ClipCIR
from spn4cir_tpu_torch.models.convert import clip_state_dict_from_jax
from tests.fixtures import make_cirr, make_fiq
from tests.torch_fixtures import synthetic_tokenizer

torch.set_num_threads(1)

TF_J = JaxImageTransform("targetpad", 32)
TF_T = ImageTransform("targetpad", 32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tok = synthetic_tokenizer()
    jb = jax_build_backbone("clip", clip_model_name="test-tiny")
    jb.tokenize = lambda texts: jax_tokenize(texts, context_length=77,
                                             truncate=True, tokenizer=tok)
    params = jax.jit(jb.init_params)(jax.random.PRNGKey(0))
    tb = ClipCIR("test-tiny", tokenizer=tok)
    tb.model.load_state_dict(
        clip_state_dict_from_jax(jax.device_get(params), tb.cfg))
    tb.eval()
    base = tmp_path_factory.mktemp("cases")
    return dict(tok=tok, jb=jb, params=params, tb=tb,
                cirr=make_cirr(str(base / "cirr_dataset"), n_images=20,
                               n_val=9, extended=False),
                fiq=make_fiq(str(base / "fiq_dataset"),
                             dress_types=("dress", "shirt")))


@pytest.fixture
def pil_decode(monkeypatch):
    monkeypatch.setenv("SPN4CIR_NATIVE", "0")


@pytest.mark.parametrize("data,kinds", [("fiq", ["dress"]), ("cirr", None)])
def test_dump_cases_match_jax(world, pil_decode, tmp_path, data, kinds):
    jb, params, tb, root = world["jb"], world["params"], world["tb"], world[
        data]
    jindex = jretrieval.extract_index_features(
        jb, params, JaxCIRDataset(data, "val", "classic", TF_J, root, kinds),
        4, num_workers=0)
    tindex = retrieval.extract_index_features(
        tb, CIRDataset(data, "val", "classic", TF_T, root, kinds), 4,
        num_workers=0)
    want = jcases.dump_cases(
        jb, params, JaxCIRDataset(data, "val", "relative", TF_J, root, kinds),
        jindex, str(tmp_path / "j" / "cases.json"), top_k=5, batch_size=4)
    got = tcases.dump_cases(
        tb, CIRDataset(data, "val", "relative", TF_T, root, kinds), tindex,
        str(tmp_path / "t" / "cases.json"), top_k=5, batch_size=4)
    assert got == want and len(got) > 0
    with open(tmp_path / "t" / "cases.json") as f:
        assert json.load(f) == want
    for c in got:
        assert len(c["topk"]) == 5 and c["reference_name"] not in c["topk"]


def test_compare_and_export_match_jax(world, tmp_path):
    root = world["fiq"]
    ds = CIRDataset("fiq", "val", "classic", TF_T, root, ["dress"])
    cases = [{"caption": f"c{i}", "reference_name": ds.gallery_names[i],
              "target_name": ds.gallery_names[i + 1], "rank": r,
              "topk": []} for i, r in enumerate([0, 12, 3, 40])]
    cases_b = [dict(c, rank=r) for c, r in zip(cases, [5, 0, 0, 0])]
    wins = tcases.compare_cases(cases, cases_b)
    assert wins == jcases.compare_cases(cases, cases_b)
    assert [w["query"]["caption"] for w in wins] == ["c1", "c3"]
    n2p = dict(zip(ds.gallery_names, ds.gallery_paths))
    for pkg, out in ((tcases, "t"), (jcases, "j")):
        assert pkg.export_case_images(wins, n2p, str(tmp_path / out),
                                      limit=1) == 2
    assert sorted(os.listdir(tmp_path / "t" / "case_0000")) == sorted(
        os.listdir(tmp_path / "j" / "case_0000"))


def test_i2i_topk_matches_jax_on_tied_scores():
    rng = np.random.RandomState(0)
    feats = (rng.randint(0, 3, (12, 4)) / 3.0).astype(np.float32)
    gallery = (rng.randint(0, 3, (9, 4)) / 3.0).astype(np.float32)
    for q, g, k, ex in ((feats, feats, 5, None), (feats, gallery, 4, False),
                        (gallery, gallery, 20, True)):
        np.testing.assert_array_equal(tgr.i2i_topk(q, g, k, ex),
                                      jgr.i2i_topk(q, g, k, ex))
    with pytest.raises(ValueError):
        tgr.i2i_topk(feats, gallery, 3, exclude_self=True)


def test_encode_and_rank_paths_match_jax(world, pil_decode, tmp_path):
    jb, params, tb = world["jb"], world["params"], world["tb"]
    paths = tgr.list_images(os.path.join(world["fiq"], "images"))
    assert paths == jgr.list_images(os.path.join(world["fiq"], "images"))
    assert len(paths) == 24
    want = jgr.encode_paths(jb, params, paths, TF_J, batch_size=5)
    got = tgr.encode_paths(tb, paths, TF_T, batch_size=5)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(tgr.i2i_topk(got, got, k=3),
                                  jgr.i2i_topk(want, want, k=3))
    texts = ["a blue dress", "make it like number 7 but red"]
    np.testing.assert_array_equal(tgr.t2i_topk(tb, texts, got, k=4),
                                  jgr.t2i_topk(jb, params, texts, want, k=4))
    top = tgr.i2i_topk(got, got, k=3)
    tgr.export_results(paths[:2], paths, top[:2], str(tmp_path / "t"))
    jgr.export_results(paths[:2], paths, top[:2], str(tmp_path / "j"))
    for q in ("query_0000", "query_0001"):
        assert sorted(os.listdir(tmp_path / "t" / q)) == sorted(
            os.listdir(tmp_path / "j" / q)) == ["query.png", "rank00.png",
                                                "rank01.png", "rank02.png"]


def test_list_images_json_and_csv(tmp_path):
    items = ["/a.png", "/b.png"]
    path = str(tmp_path / "list.json")
    with open(path, "w") as f:
        json.dump(items, f)
    assert tgr.list_images(path) == jgr.list_images(path) == items
    assert tgr.list_images("/a.png,/b.png") == items


def test_validate_case_and_analysis_case_clis(world, tmp_path):
    out = str(tmp_path / "cases" / "model.json")
    argv = ["--dataset", "fiq", "--data_path", world["fiq"],
            "--dress_types", "dress,shirt", "--clip-model-name", "test-tiny",
            "--device", "cpu", "--cases_out", out]
    summaries = validate_case_main("clip", argv, tokenizer=world["tok"])
    assert [s["dress_type"] for s in summaries] == ["dress", "shirt"]
    for s in summaries:
        with open(s["out"]) as f:
            cases = json.load(f)
        assert s["out"].endswith(f"model.{s['dress_type']}.json")
        assert len(cases) == s["queries"] > 0
        assert all(set(c) == {"caption", "reference_name", "target_name",
                              "rank", "topk"} and len(c["topk"]) == 10
                   for c in cases)
    a, b = (s["out"] for s in summaries)
    n2p = str(tmp_path / "n2p.json")
    ds = CIRDataset("fiq", "val", "classic", TF_T, world["fiq"], ["dress"])
    with open(n2p, "w") as f:
        json.dump(dict(zip(ds.gallery_names, ds.gallery_paths)), f)
    wins = analysis_case.main(["--cases_a", a, "--cases_b", a,
                               "--fail_rank", "0", "--win_rank", "100",
                               "--name_to_path", n2p, "--out_dir",
                               str(tmp_path / "cmp"), "--limit", "2"])
    assert len(wins) == summaries[0]["queries"]
    assert sorted(os.listdir(tmp_path / "cmp")) == ["case_0000", "case_0001"]
    assert analysis_case.main(["--cases_a", a, "--cases_b", b,
                               "--win_rank", "-1"]) == []


def test_retrieval_cli_i2i_and_t2i(world, tmp_path):
    gallery = os.path.join(world["cirr"], "dev")
    common = ["--gallery", gallery, "--clip-model-name", "test-tiny",
              "--topk", "3", "--device", "cpu"]
    top = cli_retrieval.main(common + ["--out_dir", str(tmp_path / "i2i")],
                             tokenizer=world["tok"])
    assert top.shape == (20, 3)
    assert all(i not in top[i] for i in range(20))
    assert len(os.listdir(tmp_path / "i2i")) == 20
    top = cli_retrieval.main(common + ["--text", "a dog,two cats",
                                       "--out_dir", str(tmp_path / "t2i")],
                             tokenizer=world["tok"])
    assert top.shape == (2, 3)
    assert sorted(os.listdir(tmp_path / "t2i" / "query_0001")) == [
        "rank00.png", "rank01.png", "rank02.png"]
