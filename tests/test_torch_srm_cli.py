"""`cli.srm_utils` on the CPU at the tiny size, and what it writes.

`--tiny_srm` (Unicom and BGE at the test geometries, random weights from
seed 0) beside CLIP `test-tiny` over the synthetic merges table, on a
16-image synthetic CIRR tree: the four similarity matrices and the six
score arrays are written, the scores equal the JAX `srm_scores` run on the
written matrices (ranks exactly, negatives up to the order inside runs of
equal values), and the i2i matrix is `cli.get_cir_data`'s rank window.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spn4cir_tpu.datagen import srm as jsrm
from spn4cir_tpu_torch.cli import get_cir_data, srm_utils
from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.datagen import srm as tsrm
from tests.fixtures import make_cirr
from tests.test_torch_srm import _assert_same_up_to_ties
from tests.torch_fixtures import synthetic_tokenizer

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def cirr_root(tmp_path_factory):
    return make_cirr(str(tmp_path_factory.mktemp("srm") / "cirr_dataset"),
                     n_images=16, n_train=13, extended=False)


def test_cli_tiny_srm_feeds_get_cir_data(cirr_root, tmp_path):
    """`cli.srm_utils --tiny_srm` on the CPU: both roles encoded, the sims
    and the scores written; its i2i is get_cir_data's rank window."""
    out, sims_out = str(tmp_path / "srm.npz"), str(tmp_path / "sims.npz")
    argv = ["--dataset", "cirr", "--data_path", cirr_root,
            "--clip-model-name", "test-tiny", "--tiny_srm", "--device", "cpu",
            "--batch_size", "5", "--k_negatives", "4", "--out", out,
            "--sims_out", sims_out]
    assert srm_utils.main(argv, tokenizer=synthetic_tokenizer()) == (
        sims_out, out)
    sims, scores = dict(np.load(sims_out)), tsrm.load_srm(out)
    n_img, n_txt = sims["i2i"].shape[0], sims["t2t"].shape[0]
    assert n_txt == 13 and sims["i2t"].shape == (n_img, n_txt)
    np.testing.assert_array_equal(sims["t2i"], sims["i2t"].T)
    np.testing.assert_allclose(np.diag(sims["i2i"]), 1.0, atol=1e-5)
    assert scores["r_fn"].shape == (13, 4) and scores["rt"].shape == (13,)
    assert all(scores[k].dtype == np.int64 for k in scores)
    ds = CIRDataset("cirr", "train", "relative", None, cirr_root)
    refer = [ds.imagename2id[t["reference_name"]] for t in ds.triplets]
    target = [ds.imagename2id[t["target_name"]] for t in ds.triplets]
    refer, target = np.asarray(refer), np.asarray(target)
    want = jsrm.srm_scores(sims, refer, target, 4)
    for key in ("rt", "rm", "mt"):
        np.testing.assert_array_equal(scores[key], want[key], err_msg=key)
    # the tiny vocabulary reads the fixture's captions as the same [UNK]s:
    # t2t's rows are runs of equal values
    for key, mat, selves in (("r_fn", sims["i2i"][refer], refer),
                             ("t_fn", sims["i2i"][target], target),
                             ("m_fn", sims["t2t"], np.arange(n_txt))):
        _assert_same_up_to_ties(mat, selves, want[key], scores[key])

    it = tmp_path / "it.json"
    it.write_text(json.dumps([{"image_id": n, "caption": f"a photo of {n}"}
                              for n in ds.imagenames]))
    path = get_cir_data.main(["--dataset", "cirr", "--data_path", cirr_root,
                              "--it_list", str(it), "--srm", sims_out,
                              "--i2i_rank", "1", "--i2i_rank_max", "3",
                              "--model", "clip", "--device", "cpu"])
    assert os.path.exists(path)


def test_cli_fails_fast_without_checkpoints(cirr_root, tmp_path):
    with pytest.raises(SystemExit, match="--unicom_ckpt"):
        srm_utils.main(["--dataset", "cirr", "--data_path", cirr_root,
                        "--device", "cpu"])
    # the default device is the card: no CUDA here, so it raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            srm_utils.main(["--dataset", "cirr", "--data_path", cirr_root,
                            "--tiny_srm"])


def test_new_modules_import_no_jax():
    code = (
        "import importlib, sys\n"
        "for m in ('models.unicom', 'models.srm', 'datagen.srm',\n"
        "          'datagen.dedup', 'cli.srm_utils', 'cli.deduplicate_images',\n"
        "          'utils.checkpoint', 'utils.logging'):\n"
        "    importlib.import_module('spn4cir_tpu_torch.' + m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'spn4cir_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cli_allow_clip_srm_takes_clips_features(cirr_root, tmp_path,
                                                 capsys):
    """Without the SRM checkpoints, `--allow_clip_srm` puts CLIP's features
    in the intra-modal roles: i2i and t2t are CLIP's own products."""
    out, sims_out = str(tmp_path / "srm.npz"), str(tmp_path / "sims.npz")
    srm_utils.main(["--dataset", "cirr", "--data_path", cirr_root,
                    "--clip-model-name", "test-tiny", "--allow_clip_srm",
                    "--device", "cpu", "--k_negatives", "3", "--out", out,
                    "--sims_out", sims_out], tokenizer=synthetic_tokenizer())
    assert "substituting CLIP features" in capsys.readouterr().out
    sims = dict(np.load(sims_out))
    # the diagonal of t2t is each caption's CLIP text feature against itself
    np.testing.assert_allclose(np.diag(sims["t2t"]), 1.0, atol=1e-5)
    assert sims["t2t"].shape == (13, 13)
    assert tsrm.load_srm(out)["m_fn"].shape == (13, 3)
