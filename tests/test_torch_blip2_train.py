"""The port's blip24cir training and entry points against the JAX package, on
the CPU in float32.

`test-tiny` blip24cir (EVA: 28-pixel images, 5 tokens, width 32, 2 layers;
Q-Former: hidden 32, 2 layers, 8 query tokens; `tiny_test_vocab`), the same
weights on both sides (`blip2_state_dict_from_jax`), the same numpy inputs
from a seed, the same AdamW settings (blip2's betas (0.9, 0.98), eps 1e-7,
weight decay 0.05):
  - three stage-2 steps against `stage2_train_step` (the JAX step through
    the XLA max-query loss): every loss, and the parameters after steps 1
    and 3; everything but Qformer_query, text_proj_q and temp bit-identical
    to the start;
  - `extract_fusion_banks` against the JAX one, keyed by triplet and, under
    `--plus`, by image;
  - `train_main("blip2")`, `validate_main`, `submission_main` and
    `serve_main(backbone_name="blip2")` with `--device cpu`, and equal Recall
    from both packages' `validate_main`.

Left out of the parameter comparisons: the self-attention `key.bias` of
Qformer_query (a constant added to all logits of a softmax row: its
gradient is exactly zero, and Adam turns either side's rounding noise into
a step of size LR). Also the parts of Qformer_query that the stage-2 text
re-read never runs, its cross-attention and its query feed-forward: their
gradient is None in the port, so AdamW leaves them where they are, as the
reference does; the JAX tree has no cross-attention there, and its query
feed-forward gets a zero gradient, so optax's weight decay shrinks it by
(1 - LR·0.05) a step.

Tolerances (float32): losses atol 5e-5; parameters atol 3e-5, rtol 1e-3 at
LR 1e-3 (one step moves a coordinate by ~1e-3).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.bank import bank as jbank_mod
from spn4cir_tpu.cli.validate import validate_main as jax_validate_main
from spn4cir_tpu.data.datasets import CIRDataset as JCIRDataset
from spn4cir_tpu.data.datasets import iter_train_images as jiter_train_images
from spn4cir_tpu.data.transforms import ImageTransform as JImageTransform
from spn4cir_tpu.models.api import build_backbone as jax_build_backbone
from spn4cir_tpu.train import stage2 as jstage2
from spn4cir_tpu_torch.bank.bank import Bank, extract_fusion_banks
from spn4cir_tpu_torch.cli import common
from spn4cir_tpu_torch.cli.serve import serve_main
from spn4cir_tpu_torch.cli.submission import submission_main
from spn4cir_tpu_torch.cli.train import BLIP24CIR_DEFAULTS, train_main
from spn4cir_tpu_torch.cli.validate import validate_main
from spn4cir_tpu_torch.data.datasets import CIRDataset, iter_train_images
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.models.api import build_backbone
from spn4cir_tpu_torch.models.convert import (blip2_state_dict_from_jax,
                                              load_blip2_checkpoint)
from spn4cir_tpu_torch.ops import (attention_kernels, bank_kernels,
                                   maxquery_kernels)
from spn4cir_tpu_torch.train import stage2
from spn4cir_tpu_torch.utils.checkpoint import save_model
from tests.fixtures import make_cirr

torch.set_num_threads(1)

LR = 1e-3
B, M = 6, 30
LOSS_TOL = dict(atol=5e-5, rtol=1e-5)
PARAM_TOL = dict(atol=3e-5, rtol=1e-3)
CAPTIONS = ["make it more blue", "a red dress with short sleeve",
            "less print", "the long shirt", "it", "more red less blue"]
ARGV = ["--dataset", "cirr", "--clip-model-name", "test-tiny", "--device",
        "cpu", "--batch-size", "4", "--learning-rate", "1e-3", "--seed", "0"]


@pytest.fixture(scope="module")
def jax_side():
    jb = jax_build_backbone("blip2", blip2_size="test-tiny")
    params = jax.jit(jb.init_params)(jax.random.PRNGKey(0))
    return jb, params


def _port(params, **kw):
    tb = build_backbone("blip2", blip2_size="test-tiny", **kw)
    tb.model.load_state_dict(blip2_state_dict_from_jax(jax.device_get(params)))
    return tb


def _trains(name: str) -> bool:
    return name.startswith(("Qformer_query.", "text_proj_q.", "temp"))


def _unrun(name: str) -> bool:
    """Parts of Qformer_query the text re-read never runs."""
    return name.startswith("Qformer_query.") and (
        ".crossattention." in name or "_query.dense" in name
        or ".output_query." in name)


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _batches(rng, tb, n):
    bank = _norm(rng.randn(M, 8, 256)).astype(np.float32)
    out = []
    for i in range(n):
        caps = [CAPTIONS[(i + j) % len(CAPTIONS)] for j in range(B)]
        out.append({"refer_feats": rng.randn(B, 8, 32).astype(np.float32),
                    "text_ids": tb.tokenize(caps),
                    "labels": rng.randint(0, M, B).astype(np.int64)})
    return bank, out


def test_three_stage2_steps_match_jax(jax_side, rng):
    jb, params = jax_side
    tb = _port(params)
    start = {k: v.clone() for k, v in tb.model.state_dict().items()}
    bank, batches = _batches(rng, tb, 3)
    jstate = jstage2.create_train_state(jb, params, LR)
    state = stage2.create_train_state(tb, LR)
    counts = (maxquery_kernels.max_query_infonce_fwd.launches,
              attention_kernels.long_attention.launches)
    for step, batch in enumerate(batches, start=1):
        jstate, want_loss = jstage2.stage2_train_step(
            jb, jstate, jnp.asarray(bank),
            {k: jnp.asarray(v) for k, v in batch.items()}, "xla")
        loss = stage2.stage2_train_step(
            tb, state, torch.from_numpy(bank),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
        if step not in (1, 3):
            continue
        want = blip2_state_dict_from_jax(jax.device_get(jstate.params))
        moved = 0.0
        for name, got in tb.model.state_dict().items():
            if not _trains(name) or _unrun(name):
                assert torch.equal(got, start[name]), f"{name} moved"
                if ".crossattention." not in name and _unrun(name):
                    # optax decays the zero-gradient query FFN of the copy
                    np.testing.assert_allclose(
                        want[name].numpy(),
                        start[name].numpy() * (1 - LR * 0.05) ** step,
                        atol=1e-7, rtol=1e-6, err_msg=name)
                elif ".crossattention." not in name:
                    assert torch.equal(want[name], start[name]), name
                continue
            if name.endswith("attention.self.key.bias"):
                continue
            np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                       err_msg=f"{name} after {step}",
                                       **PARAM_TOL)
            moved = max(moved, (got - start[name]).abs().max().item())
        assert moved > 0.5 * LR, moved          # about LR a step
    # the CPU route counts no launch
    assert counts == (maxquery_kernels.max_query_infonce_fwd.launches,
                      attention_kernels.long_attention.launches)
    assert tb.model.temp.item() != pytest.approx(0.05, abs=1e-6)
    # AdamW holds the unrun parts of the copy, which never got a gradient
    for name, p in tb.model.named_parameters():
        if _unrun(name):
            assert p.grad is None, name


@pytest.fixture(scope="module")
def cirr_root(tmp_path_factory):
    return make_cirr(str(tmp_path_factory.mktemp("blip2") / "cirr_dataset"),
                     n_images=20, n_train=10, n_val=9, extended=True,
                     extend_suffix="blip2")


@pytest.mark.parametrize("plus", [False, True])
def test_extract_fusion_banks_equals_jax(jax_side, cirr_root, plus,
                                         monkeypatch):
    """The caption-aware bank, keyed by triplet, and under --plus by image
    (both images of each triplet, with its caption); the target bank covers
    the refer images too. Both sides decode with PIL."""
    monkeypatch.setenv("SPN4CIR_NATIVE", "0")
    jb, params = jax_side
    tb = _port(params).eval()
    jds = JCIRDataset("cirr", "train", "relative", JImageTransform(
        "targetpad", 28), cirr_root, plus=plus, extend_suffix="blip2")
    tds = CIRDataset("cirr", "train", "relative", ImageTransform(
        "targetpad", 28), cirr_root, plus=plus, extend_suffix="blip2")
    assert len(tds.triplets) == len(jds.triplets)
    fn = jax.jit(lambda imgs, txt: jb.fusion_bank_features(params, imgs, txt))
    want = jbank_mod.extract_fusion_banks(
        fn, jiter_train_images(jds, 4), len(jds.triplets),
        jds.num_unique_images, jb.tokenize, by_image=plus)
    got = extract_fusion_banks(
        tb.fusion_bank_features, iter_train_images(tds, 4),
        len(tds.triplets), tds.num_unique_images, tb.tokenize,
        by_image=plus)
    assert got.refer_key == want.refer_key == ("image" if plus else "triplet")
    rows = tds.num_unique_images if plus else len(tds.triplets)
    assert got.refer.shape == (rows, 8, 32)
    assert got.target.shape == (tds.num_unique_images, 8, 256)
    np.testing.assert_allclose(got.refer, np.asarray(want.refer), atol=1e-5)
    np.testing.assert_allclose(got.target.numpy(), np.asarray(want.target),
                               atol=1e-5)
    batch = {"triplet_idx": np.arange(3), "refer_image_id": np.arange(3)}
    assert got.gather_refer(batch).shape == (3, 8, 32)


def test_defaults_and_first_word():
    assert BLIP24CIR_DEFAULTS == dict(default_model="pretrain",
                                      default_tau=0.05, default_lr=1e-05,
                                      default_bs=32, default_epochs=3)
    assert common.backbone_from_argv(["blip2", "--dataset", "cirr"]) == (
        "blip2", ["--dataset", "cirr"])
    assert common.recipe_defaults("blip2") is BLIP24CIR_DEFAULTS
    args = common.base_parser(**BLIP24CIR_DEFAULTS).parse_args(
        ["--dataset", "cirr"])
    assert (args.tau, args.learning_rate, args.batch_size,
            args.num_epochs, args.clip_model_name) == (0.05, 1e-5, 32, 3,
                                                       "pretrain")
    assert common.FIRST_WORDS == ("clip", "blip", "blip2")


def test_blip2_refuses_a_size_it_does_not_have(cirr_root):
    """`--clip-model-name` names the blip2 size: anything but `pretrain` or
    `test-tiny` raises, rather than building the full EVA-g model."""
    with pytest.raises(ValueError, match="'RN50x4'"):
        train_main("blip2", ARGV + ["--data_path", cirr_root,
                                    "--clip-model-name", "RN50x4"])
    with pytest.raises(ValueError, match="'pretrian'"):
        build_backbone("blip2", blip2_size="pretrian")


def test_wo_bank_with_blip2_raises(cirr_root):
    """The JAX package's blip2 backbone has no stage-1 loss, so the port has
    none to offer: `--wo_bank` raises before a model is built."""
    with pytest.raises(NotImplementedError, match="stage-1"):
        train_main("blip2", ARGV + ["--data_path", cirr_root, "--wo_bank"])
    with pytest.raises(NotImplementedError, match="--text_max_len"):
        train_main("blip2", ARGV + ["--data_path", cirr_root,
                                    "--text_max_len", "20"])


def test_train_validate_submission_main_blip2_cpu_end_to_end(
        cirr_root, tmp_path, capsys, monkeypatch):
    """Stage 2 through the CLI: the triplet-keyed fusion bank, two epochs
    with dropout, a best checkpoint with LAVIS's names, then validation and
    the submission files from it."""
    out = str(tmp_path / "run")
    counters = [maxquery_kernels.max_query_infonce_fwd,
                maxquery_kernels.max_query_infonce_bwd,
                attention_kernels.long_attention,
                bank_kernels.bank_infonce_fwd]
    before = [c.launches for c in counters]
    best = train_main("blip2", ARGV + ["--data_path", cirr_root,
                                       "--output_path", out, "--num-epochs",
                                       "2", "--dropout", "0.1"], log_every=1)
    assert [c.launches for c in counters] == before     # CPU: no launch
    text = capsys.readouterr().out
    assert "tau : 0.05" in text and "epoch 1: mean" in text
    assert 0.0 < best <= 100.0
    bank = Bank.load(os.path.join(out, "cirr_bank.npz"))
    assert bank.refer_key == "triplet" and bank.refer.shape == (10, 8, 32)
    assert bank.target.shape[1:] == (8, 256)
    ckpt = os.path.join(out, "best.pt")
    sd = load_blip2_checkpoint(ckpt)
    fresh = build_backbone("blip2", blip2_size="test-tiny")
    fresh.init_params(torch.Generator().manual_seed(0))
    assert set(sd) == set(fresh.model.state_dict())
    for name, t in fresh.model.state_dict().items():
        if not _trains(name) or _unrun(name):
            assert torch.equal(sd[name], t), f"{name} moved"
    assert not torch.equal(sd["text_proj_q.weight"],
                           fresh.model.text_proj_q.weight)
    assert sd["temp"].item() != pytest.approx(0.05, abs=1e-6)

    results = validate_main("blip2", ARGV + ["--data_path", cirr_root,
                                             "--model_path", ckpt])
    assert results["arithmetic_mean"] == pytest.approx(best)
    monkeypatch.chdir(tmp_path)
    paths = submission_main("blip2", ARGV + [
        "--data_path", cirr_root, "--model_path", ckpt, "--submission-name",
        "t"])
    assert paths[0] == os.path.join("submission", "blip24cir",
                                    "recall_submission_t.json")
    for path in paths:
        with open(path) as fh:
            doc = json.load(fh)
        assert doc["version"] == "rc2" and len(doc) > 2


def test_train_main_blip2_plus_int8_and_unlabeled_cpu(cirr_root, tmp_path,
                                                      capsys):
    """`--plus --bank_dtype int8 --unlabeled` on the 3-D target: an
    image-keyed refer bank, the unlabeled pool's (32, 256)-shaped features
    appended, the whole target quantized per (m, q) row; and bfloat16."""
    pool = CIRDataset("cirr", "train", "unlabeled", ImageTransform(
        "targetpad", 28), cirr_root, extend_suffix="blip2")
    u = len(pool.unlabeled_imagepaths)
    assert u >= 3
    n = CIRDataset("cirr", "train", "relative", ImageTransform(
        "targetpad", 28), cirr_root, plus=True,
        extend_suffix="blip2").num_unique_images
    out = str(tmp_path / "run")
    argv = ARGV + ["--data_path", cirr_root, "--output_path", out,
                   "--num-epochs", "1", "--plus", "--bank_dtype", "int8",
                   "--unlabeled"]
    best = train_main("blip2", argv, log_every=0)
    text = capsys.readouterr().out
    assert f"bank: {n + u} images, refer ({n}, 8, 32)" in text
    assert f"target ({n + u}, 8, 256) torch.int8" in text
    assert 0.0 <= best <= 100.0
    assert Bank.load(os.path.join(out, "cirr_bank.npz")).refer_key == "image"
    cached = np.load(os.path.join(out, "cirr_bank_unlabeled.npz"))["unlabeled"]
    assert cached.shape == (u, 8, 256)
    train_main("blip2", argv[:-3] + ["--bank_dtype", "bfloat16"], log_every=0)
    assert "torch.bfloat16" in capsys.readouterr().out


def test_validate_main_recall_equals_jax_for_blip2(jax_side, cirr_root,
                                                   tmp_path, monkeypatch):
    jb, params = jax_side
    monkeypatch.setenv("SPN4CIR_NATIVE", "0")       # both sides decode with PIL

    def make_backbone(name, args):
        assert (name, args.clip_model_name) == ("blip2", "test-tiny")
        return jb

    monkeypatch.setattr("spn4cir_tpu.cli.validate.make_backbone",
                        make_backbone)
    monkeypatch.setattr("spn4cir_tpu.cli.validate.load_or_init_params",
                        lambda backbone, args, key: params)
    want = jax_validate_main("blip2", ["--dataset", "cirr", "--data_path",
                                       cirr_root, "--clip-model-name",
                                       "test-tiny"])
    ckpt = str(tmp_path / "weights.pth")
    save_model(ckpt, _port(params).model, epoch=0)
    got = validate_main("blip2", ARGV + ["--data_path", cirr_root,
                                         "--model_path", ckpt])
    assert got.keys() == want.keys() and "arithmetic_mean" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    assert any(v > 0 for v in got.values())


@pytest.mark.parametrize("gallery_dtype", ["float32", "int8"])
def test_serve_main_blip2_cpu(jax_side, cirr_root, tmp_path, gallery_dtype):
    """The retrieval service over a blip2 index: (32, 256)-shaped targets
    scored by their best query (an int8 gallery dequantized after the
    product), the refer side's EVA tokens on the host, a query by gallery
    name excludes its reference."""
    jb, params = jax_side
    ckpt = str(tmp_path / "weights.pth")
    tb = _port(params)
    # an upstream checkpoint: LAVIS's prefix, no temperature
    torch.save({"model": {f"blip_model.{k}": v for k, v in
                          tb.model.state_dict().items() if k != "temp"}}, ckpt)
    server, service = serve_main(
        ["--dataset", "cirr", "--data_path", cirr_root, "--clip-model-name",
         "test-tiny", "--device", "cpu", "--serve_host", "127.0.0.1",
         "--serve_port", "0", "--no-block", "--batch-size", "4",
         "--model_path", ckpt, "--gallery_dtype", gallery_dtype],
        backbone_name="blip2")
    try:
        index = service.index
        assert index.refer.shape == (len(index.names), 5, 32)
        assert index.target.shape == (len(index.names), 8, 256)
        assert service.backbone.model.temp.item() == pytest.approx(0.05)
        name = index.names[3]
        results = service.query_by_name(name, "make it more blue", k=5)
        assert len(results) == 5 and name not in [r["name"] for r in results]
        scores = [r["score"] for r in results]
        assert scores == sorted(scores, reverse=True)
        with torch.inference_mode():
            q = tb.eval().fuse(
                index.refer_rows(np.asarray([3])),
                torch.from_numpy(service.backbone.tokenize(
                    ["make it more blue"])))
            target = index.target
            dense = (target.dequantize()
                     if isinstance(target, bank_kernels.QuantBank) else target)
            want = torch.einsum("bd,mqd->bmq", q, dense).amax(-1)[0]
            want[3] = float("-inf")
        assert results[0]["name"] == index.names[int(want.argmax())]
        assert results[0]["score"] == pytest.approx(want.max().item(),
                                                    abs=1e-5)
    finally:
        server.shutdown()
        server.server_close()


def test_blip2_entry_points_default_to_cuda(cirr_root):
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        validate_main("blip2", ["--clip-model-name", "test-tiny", "--dataset",
                                "cirr", "--data_path", cirr_root])
