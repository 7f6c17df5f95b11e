"""The port's CIRR submission files and its validate / submission entry
points against the JAX package, on the CPU in float32.

Both packages run the `test-tiny` CLIP (width 32, 2 + 2 layers) with the
same weights over the same synthetic CIRR tree (`tests/fixtures.make_cirr`,
which has a `test1` split). The JAX side decodes with PIL, as the port
does. The submission files must agree byte for byte; Recall values within
1e-4 (they are means of 0/1 ranks, so in fact equal).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from spn4cir_tpu.cli import common as jax_common
from spn4cir_tpu.cli.submission import submission_main as jax_submission_main
from spn4cir_tpu.cli.validate import validate_main as jax_validate_main
from spn4cir_tpu.data.transforms import ImageTransform as JaxImageTransform
from spn4cir_tpu.eval import submission as jsubmission
from spn4cir_tpu.models.api import build_backbone as jax_build_backbone
from spn4cir_tpu.tokenizer.bpe import tokenize as jax_tokenize
from spn4cir_tpu_torch.cli.submission import submission_main
from spn4cir_tpu_torch.cli.validate import validate_main
from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.eval import retrieval, submission
from spn4cir_tpu_torch.models.clip4cir import ClipCIR
from spn4cir_tpu_torch.models.convert import clip_state_dict_from_jax
from spn4cir_tpu_torch.ops.bank_kernels import quantize_bank
from spn4cir_tpu_torch.utils.checkpoint import save_model
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
    base = tmp_path_factory.mktemp("submission")
    ckpt = str(base / "weights.pt")
    save_model(ckpt, tb.model, epoch=0)
    return dict(tok=tok, jb=jb, params=params, tb=tb, ckpt=ckpt,
                cirr=make_cirr(str(base / "cirr_dataset"), n_images=20,
                               n_val=9, extended=False),
                fiq=make_fiq(str(base / "fiq_dataset")))


@pytest.fixture
def pil_decode(monkeypatch):
    """The port decodes with PIL only; hold the JAX side to the same."""
    monkeypatch.setenv("SPN4CIR_NATIVE", "0")


@pytest.fixture
def jax_cli(world, monkeypatch):
    """The JAX package's CLIs with the test's weights and tokenizer: they
    build their backbone and initialise it inside, so both hooks are
    replaced for the length of one test."""
    def make_backbone(name, args):
        assert (name, args.clip_model_name) == ("clip", "test-tiny")
        return world["jb"]

    for mod in ("spn4cir_tpu.cli.validate", "spn4cir_tpu.cli.submission"):
        monkeypatch.setattr(f"{mod}.make_backbone", make_backbone)
        monkeypatch.setattr(f"{mod}.load_or_init_params",
                            lambda backbone, args, key: world["params"])
    assert jax_common.make_backbone is not make_backbone


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_submission_files_equal_jax_byte_for_byte(world, pil_decode, tmp_path):
    jb, params, tb, root = (world[k] for k in ("jb", "params", "tb", "cirr"))
    want = jsubmission.generate_cirr_test_submissions(
        jb, params, "run", TF_J, root, output_root=str(tmp_path / "jax"),
        batch_size=4)
    got = submission.generate_cirr_test_submissions(
        tb, "run", TF_T, root, output_root=str(tmp_path / "port"),
        batch_size=4)
    for g, w in zip(got, want):
        assert os.path.relpath(g, tmp_path / "port") == os.path.relpath(
            w, tmp_path / "jax")
        assert _read(g) == _read(w)
    assert os.path.basename(got[0]) == "recall_submission_run.json"
    assert os.path.basename(got[1]) == "recall_subset_submission_run.json"
    assert os.path.basename(os.path.dirname(got[0])) == "clip4cir"

    pred, group = (json.loads(_read(p)) for p in got)
    assert (pred.pop("version"), pred.pop("metric")) == ("rc2", "recall")
    assert (group.pop("version"), group.pop("metric")) == (
        "rc2", "recall_subset")
    rel = CIRDataset("cirr", "test1", "relative", TF_T, root)
    assert set(pred) == set(group) == {
        str(int(t["pairid"])) for t in rel.triplets}
    refer = {str(int(t["pairid"])): t["reference"] for t in rel.triplets}
    for pid in pred:
        # 20 images: the masked reference row is removed, not listed last
        assert len(pred[pid]) == 19 and refer[pid] not in pred[pid]
        assert len(set(pred[pid])) == 19
        assert len(group[pid]) == 3 and refer[pid] not in group[pid]
    assert _read(got[0]).startswith(b'{"')
    assert list(json.loads(_read(got[0]))) == sorted(json.loads(_read(got[0])))


def test_test_dicts_match_jax_over_an_int8_gallery(world, pil_decode):
    """`generate_cirr_test_dicts` over a quantized gallery: the same names
    as over the dense one wherever the quantization error leaves the order
    alone, and every key a `str(int(pairid))`."""
    tb, root = world["tb"], world["cirr"]
    index = retrieval.extract_index_features(
        tb, CIRDataset("cirr", "test1", "classic", TF_T, root), 4,
        num_workers=0)
    rel = CIRDataset("cirr", "test1", "relative", TF_T, root)
    dense = submission.generate_cirr_test_dicts(tb, rel, index, 4)
    index.target = quantize_bank(index.target)
    q8 = submission.generate_cirr_test_dicts(tb, rel, index, 4)
    assert dense[0].keys() == q8[0].keys() and dense[1].keys() == q8[1].keys()
    assert all(k == str(int(k)) for k in q8[0])
    same = np.mean([dense[0][k][:3] == q8[0][k][:3] for k in dense[0]])
    assert same > 0.5
    for k in q8[0]:
        assert sorted(q8[0][k]) == sorted(dense[0][k])


ARGV = ["--clip-model-name", "test-tiny", "--device", "cpu"]


def test_validate_main_recall_equals_jax_on_cirr(world, pil_decode, jax_cli,
                                                 capsys):
    want = jax_validate_main("clip", ["--dataset", "cirr", "--data_path",
                                      world["cirr"], "--clip-model-name",
                                      "test-tiny"])
    got = validate_main("clip", ARGV + ["--dataset", "cirr", "--data_path",
                                        world["cirr"], "--model_path",
                                        world["ckpt"]], tokenizer=world["tok"])
    assert got.keys() == want.keys() and "arithmetic_mean" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    assert any(v > 0 for v in got.values())
    printed = capsys.readouterr().out
    assert json.dumps(got, indent=2, sort_keys=True) in printed


def test_validate_main_recall_equals_jax_on_fiq(world, pil_decode, jax_cli):
    flags = ["--dataset", "fiq", "--data_path", world["fiq"], "--dress_types",
             "dress"]
    want = jax_validate_main("clip", flags + ["--clip-model-name",
                                              "test-tiny"])
    got = validate_main("clip", ARGV + flags + ["--model_path", world["ckpt"]],
                        tokenizer=world["tok"])
    assert got.keys() == want.keys()
    assert {"dress_recall_at10", "dress_recall_at50", "mean_recall"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


def test_submission_main_equals_jax(world, pil_decode, jax_cli, tmp_path,
                                    monkeypatch):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    want = jax_submission_main("clip", [
        "--dataset", "cirr", "--data_path", world["cirr"],
        "--clip-model-name", "test-tiny", "--submission-name", "x"])
    monkeypatch.chdir(tmp_path / "port")
    got = submission_main("clip", ARGV + [
        "--dataset", "cirr", "--data_path", world["cirr"], "--model_path",
        world["ckpt"], "--submission-name", "x"], tokenizer=world["tok"])
    assert got == want == (
        os.path.join("submission", "clip4cir", "recall_submission_x.json"),
        os.path.join("submission", "clip4cir",
                     "recall_subset_submission_x.json"))
    for g in got:
        assert _read(tmp_path / "port" / g) == _read(tmp_path / "jax" / g)


def test_submission_main_needs_cirr(world):
    with pytest.raises(SystemExit, match="require --dataset cirr"):
        submission_main("clip", ARGV + ["--dataset", "fiq", "--data_path",
                                        world["fiq"]], tokenizer=world["tok"])


@pytest.mark.parametrize("main", [validate_main, submission_main])
@pytest.mark.parametrize("flags,match", [
    (["--mesh_data", "2"], "--mesh_data"),
    (["--mesh_model", "2"], "--mesh_model"),
    (["--mesh_bank", "2"], "--mesh_bank"),
    (["--distributed"], "--distributed"),
    (["--device_preprocess", "--mesh_data", "2"], "--mesh_data"),
])
def test_entry_points_refuse_what_is_not_ported(main, flags, match, world,
                                                monkeypatch):
    """A mesh (`match`'s flag) runs one process per GPU: a process started
    alone, without a torchrun or SPN4CIR_DIST_* launch, is refused."""
    for var in ("SPN4CIR_DIST_NPROCS", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    argv = ARGV + ["--dataset", "cirr", "--data_path", world["cirr"]] + flags
    with pytest.raises(SystemExit, match="multi-process launch"):
        main("clip", argv, tokenizer=world["tok"])
    assert match in " ".join(flags)


@pytest.mark.parametrize("main", [validate_main, submission_main])
def test_entry_points_default_to_cuda(main, world):
    """Without --device the entry points ask for cuda:0 and fail where
    there is none: the CPU is used only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        main("clip", ["--clip-model-name", "test-tiny", "--dataset", "cirr",
                      "--data_path", world["cirr"]], tokenizer=world["tok"])
