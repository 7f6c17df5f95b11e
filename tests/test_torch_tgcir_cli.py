"""tgcir through the port's entry points on the CPU, at `test-tgcir` width:
`cli.train tgcir` (stage 2 over a (N, 12, 512) refer bank of token sets,
float32 and int8 target banks), `cli.validate tgcir` on CIRR and FashionIQ
(the FIQ ranks keep the reference image, as the published tgcir eval
does), `cli.submission tgcir` and `cli.serve tgcir`, and the flags tgcir
refuses. The CPU route launches no kernel.
"""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from spn4cir_tpu_torch.bank.bank import Bank
from spn4cir_tpu_torch.cli import common
from spn4cir_tpu_torch.cli.serve import serve_main
from spn4cir_tpu_torch.cli.submission import submission_main
from spn4cir_tpu_torch.cli.train import train_main
from spn4cir_tpu_torch.cli.validate import validate_main
from spn4cir_tpu_torch.eval import metrics
from spn4cir_tpu_torch.models.convert import load_tgcir_checkpoint
from spn4cir_tpu_torch.models.tgcir import TgcirCIR
from spn4cir_tpu_torch.ops import attention_kernels, bank_kernels
from tests.fixtures import make_cirr, make_fiq
from tests.torch_fixtures import synthetic_tokenizer, write_merges_file

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--dataset", "cirr", "--clip-model-name", "test-tgcir", "--device",
        "cpu", "--batch-size", "4", "--learning-rate", "1e-3", "--seed", "0"]


@pytest.fixture(scope="module")
def tok():
    return synthetic_tokenizer()


@pytest.fixture(scope="module")
def cirr_root(tmp_path_factory):
    return make_cirr(str(tmp_path_factory.mktemp("tgcir") / "cirr_dataset"),
                     n_images=8, n_train=8, n_val=6, extended=False)


def _counts():
    return [c.launches for c in (
        attention_kernels.short_attention, attention_kernels.short_attention_bwd,
        attention_kernels.long_attention, bank_kernels.bank_infonce_fwd,
        bank_kernels.bank_infonce_bwd, bank_kernels.bank_infonce_q8_fwd)]


def _frozen(name: str) -> bool:
    return (name.startswith(("clip.visual.", "fc.", "tokenlearn.", "masks."))
            or name == "clip.logit_scale")


def test_train_validate_submission_main_tgcir_cirr(tok, cirr_root, tmp_path,
                                                   capsys, monkeypatch):
    """Stage 2 through the CLI with tgcir's recipe defaults: the token-set
    refer bank and the pooled target bank, the image branch bit-identical
    after training, the text branch moved; then a second run over an int8
    bank from the cache; validation and the submission files from the
    checkpoint."""
    out = str(tmp_path / "run")
    before = _counts()
    best = train_main("tgcir", ARGV + ["--data_path", cirr_root,
                                       "--output_path", out,
                                       "--num-epochs", "1"],
                      tokenizer=tok, log_every=1)
    text = capsys.readouterr().out
    assert "tau : 0.02" in text and "num_epochs : 1" in text
    assert "refer (" in text and ", 12, 512)" in text
    assert 0.0 < best <= 100.0          # 8 gallery images: recall@5 > 0
    bank = Bank.load(os.path.join(out, "cirr_bank.npz"))
    assert bank.refer.shape[1:] == (12, 512)
    assert tuple(bank.target.shape[1:]) == (512,)
    np.testing.assert_allclose(bank.target.norm(dim=-1).numpy(), 1.0,
                               atol=1e-5)

    ckpt = os.path.join(out, "best.pt")
    sd = load_tgcir_checkpoint(ckpt)
    fresh = TgcirCIR("test-tgcir")
    fresh.init_params(torch.Generator().manual_seed(0))
    assert set(sd) == set(fresh.model.state_dict())
    moved = 0
    for name, t in fresh.model.state_dict().items():
        if _frozen(name):
            assert torch.equal(sd[name], t), f"frozen {name} moved"
        else:
            moved += int(not torch.equal(sd[name], t))
    for name in ("masks_text.weight", "tokenlearn_text.attn.weight",
                 "s_remain.fc1.weight", "text_fc.weight",
                 "clip.text_projection"):
        assert not torch.equal(sd[name], fresh.model.state_dict()[name]), name

    again = train_main("tgcir", ARGV + [
        "--data_path", cirr_root, "--output_path", out, "--num-epochs", "1",
        "--bank_dtype", "int8"], tokenizer=tok, log_every=0)
    assert "torch.int8" in capsys.readouterr().out and 0.0 <= again <= 100.0

    results = validate_main("tgcir", ARGV + ["--data_path", cirr_root,
                                             "--model_path", ckpt],
                            tokenizer=tok)
    assert "arithmetic_mean" in results
    monkeypatch.chdir(tmp_path)
    paths = submission_main("tgcir", ARGV + [
        "--data_path", cirr_root, "--model_path", ckpt, "--submission-name",
        "t"], tokenizer=tok)
    assert paths[0] == os.path.join("submission", "tgcir4cir",
                                    "recall_submission_t.json")
    for path in paths:
        with open(path) as fh:
            assert json.load(fh)["version"] == "rc2"
    assert _counts() == before                          # CPU: no launch


def test_train_and_validate_main_tgcir_fiq_rank_the_full_gallery(
        tok, tmp_path, monkeypatch):
    """Stage 2 and validation on FashionIQ: tgcir's FIQ metrics get no
    reference ids to exclude (the epoch's validation and validate_main's),
    clip's do."""
    root = make_fiq(str(tmp_path / "fiq"), n_images=10, n_train=4, n_val=4,
                    extended=False)
    seen = []
    real = metrics.fiq_metrics

    def spy(scores, target, refer=None, *a, **kw):
        seen.append(refer)
        return real(scores, target, refer, *a, **kw)

    monkeypatch.setattr(metrics, "fiq_metrics", spy)
    argv = ARGV[2:] + ["--dataset", "fiq", "--data_path", root,
                       "--dress_types", "dress"]
    best = train_main("tgcir", argv + ["--num-epochs", "1", "--output_path",
                                       str(tmp_path / "run")],
                      tokenizer=tok, log_every=0)
    assert 0.0 <= best <= 100.0
    results = validate_main("tgcir", argv, tokenizer=tok)
    assert seen == [None, None] and "mean_recall" in results
    validate_main("clip", [a if a != "test-tgcir" else "test-tiny"
                           for a in argv], tokenizer=tok)
    assert seen[2] is not None and len(seen[2]) == 4


@pytest.mark.parametrize("module,first", [
    ("spn4cir_tpu_torch.cli.train", ["tgcir"]),
    ("spn4cir_tpu_torch.cli.validate", ["tgcir"]),
    ("spn4cir_tpu_torch.cli.train_negtype", []),
])
def test_python_dash_m_entry_points(module, first, cirr_root, tmp_path):
    """The `python -m` forms read the first word and their recipe's flags
    from the command line; the tokenizer reads SPN4CIR_BPE_VOCAB."""
    merges = write_merges_file(str(tmp_path / "bpe.txt.gz"))
    model = "test-tgcir" if first else "test-tiny"
    argv = [sys.executable, "-m", module, *first, "--dataset", "cirr",
            "--data_path", cirr_root, "--clip-model-name", model, "--device",
            "cpu", "--batch-size", "4", "--num-epochs", "1", "--output_path",
            str(tmp_path / "run")]
    path = os.pathsep.join(filter(None, [REPO,
                                         os.environ.get("PYTHONPATH")]))
    out = subprocess.run(argv, capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env=dict(
                             os.environ, SPN4CIR_BPE_VOCAB=merges,
                             PYTHONPATH=path))
    assert out.returncode == 0, out.stderr[-2000:]
    tau = " tau : 0.02" if first else " neg_type : 15"
    assert tau in out.stdout


def test_serve_main_tgcir(tok, cirr_root):
    server, service = serve_main(ARGV + [
        "--data_path", cirr_root, "--serve_host", "127.0.0.1",
        "--serve_port", "0", "--no-block", "--serve_batch", "4"],
        backbone_name="tgcir", tokenizer=tok)
    port = server.server_address[1]
    try:
        index = service.index
        assert index.refer.shape == (8, 12, 512)
        assert tuple(index.target.shape) == (8, 512)
        name = index.names[2]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/retrieve",
            data=json.dumps({"reference_name": name, "caption": "is red",
                             "k": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            got = json.loads(r.read())["results"]
        assert len(got) == 5 and name not in [g["name"] for g in got]
        assert all(a["score"] >= b["score"] for a, b in zip(got, got[1:]))
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("flags,error,match", [
    (["--wo_bank"], NotImplementedError, "no stage-1 loss"),
    (["--unlabeled"], NotImplementedError, "--unlabeled with tgcir"),
    (["--dropout", "0.1"], NotImplementedError, "--dropout"),
    (["--text_max_len", "40"], NotImplementedError, "--text_max_len"),
    (["--wo_bank", "--neg_type", "3"], NotImplementedError,
     "--neg_type with tgcir"),
])
def test_tgcir_refuses(flags, error, match, tok, cirr_root, tmp_path):
    with pytest.raises(error, match=match):
        train_main("tgcir", ARGV + ["--data_path", cirr_root,
                                    "--output_path", str(tmp_path / "r")]
                   + flags, tokenizer=tok)


def test_tgcir_is_a_first_word_with_its_recipe():
    assert common.backbone_from_argv(["tgcir", "--dataset", "cirr"]) == (
        "tgcir", ["--dataset", "cirr"])
    args = common.base_parser(**common.recipe_defaults("tgcir")).parse_args(
        ["--dataset", "cirr"])
    assert (args.clip_model_name, args.tau, args.learning_rate,
            args.batch_size, args.num_epochs) == ("ViT-B/16", 0.02, 2e-5,
                                                  256, 5)
