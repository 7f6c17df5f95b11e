"""The stage-1 negative-type ablation, `--use_cc` and the zscir entry points
of the port, on the CPU.

The four negative flavors and their bitmask mean against
`spn4cir_tpu.ops.infonce` (float32 numpy inputs from a seed);
`ClipCIR.stage1_negtype_loss`, its gradients and one stage-1 AdamW step
against the JAX package on `test-tiny` with the same weights; the CLI over
CC triplets; the zscir recipes; and the four recipe wrappers
(`cli.train_negtype`, `cli.train_negplus`, `cli.train_zs`,
`cli.train_zs_bank`) end to end with `--device cpu`.

Tolerances (float32): the losses atol 1e-5, rtol 1e-5 on the op level and
atol 5e-5, rtol 1e-5 through the towers; gradients atol 2e-5, rtol 2e-3;
parameters after one step atol 3e-5, rtol 1e-3 at LR 1e-3 (as
tests/test_torch_stage2.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.models.api import build_backbone as jax_build_backbone
from spn4cir_tpu.ops import infonce as jinfonce
from spn4cir_tpu.tokenizer.bpe import tokenize as jax_tokenize
from spn4cir_tpu.train import stage1 as jstage1
from spn4cir_tpu_torch.cli import (common, train_negplus, train_negtype,
                                   train_zs, train_zs_bank)
from spn4cir_tpu_torch.cli.train import train_main
from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.models.api import backbone_class, build_backbone
from spn4cir_tpu_torch.models.clip4cir import ClipCIR
from spn4cir_tpu_torch.models.convert import clip_state_dict_from_train_state
from spn4cir_tpu_torch.ops import infonce
from spn4cir_tpu_torch.train import stage1
from tests.fixtures import make_cirr
from tests.torch_fixtures import synthetic_tokenizer

torch.set_num_threads(1)

OP_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_TOL = dict(atol=5e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-3)
PARAM_TOL = dict(atol=3e-5, rtol=1e-3)
LR = 1e-3
TAU = 0.02
CAPTIONS = ["make it red", "is darker", "with a floral print", "add a dog"]


def _features(rng, b=6, d=16):
    refer = rng.randn(b, d).astype(np.float32)
    text = rng.randn(b, d).astype(np.float32)
    target = rng.randn(b, d).astype(np.float32)
    target /= np.linalg.norm(target, axis=-1, keepdims=True)
    return refer, text, target


def test_each_flavor_matches_jax(rng):
    feats = _features(rng)
    want = jinfonce.negtype_losses(*map(jnp.asarray, feats), TAU)
    got = infonce.negtype_losses(*map(torch.from_numpy, feats), TAU)
    assert set(got) == set(want) == set(infonce.NEGTYPE_ORDER)
    for name in infonce.NEGTYPE_ORDER:
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   err_msg=name, **OP_TOL)
    # the flavors differ: each reads other negatives
    assert len({round(v.item(), 4) for v in got.values()}) == 4


@pytest.mark.parametrize("mask", range(1, 16))
def test_every_mask_matches_jax(mask, rng):
    feats = _features(rng)
    want = jinfonce.combine_negtype(
        jinfonce.negtype_losses(*map(jnp.asarray, feats), TAU), mask)
    losses = infonce.negtype_losses(*map(torch.from_numpy, feats), TAU)
    got = infonce.combine_negtype(losses, mask)
    np.testing.assert_allclose(got.item(), float(want), **OP_TOL)
    picked = [losses[n] for i, n in enumerate(infonce.NEGTYPE_ORDER)
              if mask >> i & 1]
    assert got.item() == pytest.approx(sum(picked).item() / len(picked))


def test_mask_zero_raises_in_both_packages(rng):
    feats = _features(rng)
    with pytest.raises(ValueError, match="selects no losses"):
        infonce.combine_negtype(
            infonce.negtype_losses(*map(torch.from_numpy, feats), TAU), 0)
    with pytest.raises(ValueError, match="selects no losses"):
        jinfonce.combine_negtype(
            jinfonce.negtype_losses(*map(jnp.asarray, feats), TAU), 0)


# ---- through the towers ----

@pytest.fixture(scope="module")
def tok():
    return synthetic_tokenizer()


@pytest.fixture(scope="module")
def sides(tok):
    jb = jax_build_backbone("clip", clip_model_name="test-tiny", tau=TAU)
    params = jax.device_get(jax.jit(jb.init_params)(jax.random.PRNGKey(0)))
    ids = np.asarray(jax_tokenize(CAPTIONS, context_length=77, truncate=True,
                                  tokenizer=tok))
    return jb, params, ids


def _port(params, tok):
    tb = ClipCIR("test-tiny", tau=TAU, tokenizer=tok)
    tb.model.load_state_dict(clip_state_dict_from_train_state(params, tb.cfg))
    return tb


def _batch(rng, ids):
    b = ids.shape[0]
    return {"refer_images": rng.randn(b, 32, 32, 3).astype(np.float32),
            "target_images": rng.randn(b, 32, 32, 3).astype(np.float32),
            "text_ids": ids}


@pytest.mark.parametrize("neg_type", [15, 3, 12])
def test_stage1_negtype_loss_and_gradients_match_jax(neg_type, sides, tok,
                                                     rng):
    jb, params, ids = sides
    tb = _port(params, tok)
    batch = _batch(rng, ids)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jb.stage1_negtype_loss(p, jbatch["refer_images"],
                                         jbatch["target_images"],
                                         jbatch["text_ids"], neg_type))(params)
    stage1.create_stage1_state(tb, LR)
    loss = tb.stage1_negtype_loss(*[torch.from_numpy(v)
                                    for v in batch.values()], neg_type)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    want = clip_state_dict_from_train_state(jax.device_get(want_grads),
                                            tb.cfg)
    for name, p in tb.model.named_parameters():
        if name == "logit_scale":
            assert p.grad is None
            continue
        g, w = p.grad, want[name]
        if name.endswith("attn.in_proj_bias"):    # zero-gradient key third
            third = g.shape[0] // 3
            g, w = (torch.cat([t[:third], t[2 * third:]]) for t in (g, w))
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **GRAD_TOL)


def test_one_negtype_stage1_step_matches_jax(sides, tok, rng):
    """One step through both packages' stage-1 trainers; elements whose
    gradient is within rounding noise of Adam's eps are held to the step's
    bound (as tests/test_torch_blip_train.py does)."""
    jb, params, ids = sides
    tb = _port(params, tok)
    start = {k: v.clone() for k, v in tb.model.state_dict().items()}
    batch = _batch(rng, ids)
    jstate = jstage1.create_stage1_state(jb, params, LR)
    jstate, want_loss = jstage1.stage1_train_step(
        jb, jstate, {k: jnp.asarray(v) for k, v in batch.items()}, neg_type=7)
    state = stage1.create_stage1_state(tb, LR)
    loss = stage1.stage1_train_step(
        tb, state, {k: torch.from_numpy(v) for k, v in batch.items()},
        neg_type=7)
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    want = clip_state_dict_from_train_state(jax.device_get(jstate), tb.cfg)
    held = seen = 0
    for name, got in tb.model.state_dict().items():
        if name == "logit_scale":
            assert torch.equal(got, start[name])
            continue
        a, b, g = got, want[name], tb.model.get_parameter(name).grad
        if name.endswith("attn.in_proj_bias"):
            third = a.shape[0] // 3
            a, b, g = (torch.cat([t[:third], t[2 * third:]]) for t in (a, b, g))
        sure = (g.abs() > 3e-6) | (g == 0)
        held += int(sure.sum())
        seen += sure.numel()
        np.testing.assert_allclose(a[sure].numpy(), b[sure].numpy(),
                                   err_msg=name, **PARAM_TOL)
        assert (a - b).abs().max() <= 2.1 * LR, name
    assert held > 0.9 * seen, (held, seen)
    assert not torch.equal(tb.model.visual.proj, start["visual.proj"])


def test_negtype_step_runs_without_dropout(sides, tok, rng):
    """`neg_type` takes the ablation's loss and hands no generator on."""
    jb, params, ids = sides
    tb = _port(params, tok)
    batch = {k: torch.from_numpy(v) for k, v in _batch(rng, ids).items()}
    got = stage1.stage1_loss_fn(tb, batch, 5, torch.Generator())
    want = tb.stage1_negtype_loss(*batch.values(), 5)
    assert torch.equal(got, want)
    assert not torch.equal(stage1.stage1_loss_fn(tb, batch), got)


# ---- the CLI: --neg_type, --use_cc, zs ----

ARGV = ["--dataset", "cirr", "--clip-model-name", "test-tiny", "--device",
        "cpu", "--batch-size", "4", "--learning-rate", "1e-3", "--seed", "0",
        "--num-epochs", "1"]


def _write_cc(root, n=6, seed=1):
    """CC triplets in the reference's schema: full image paths, names
    outside the dataset's splits (as `get_cir_data.py` writes them)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "cc_images")
    os.makedirs(img_dir, exist_ok=True)
    names = [f"cc_img{i}" for i in range(n + 1)]
    for name in names:
        Image.fromarray(rng.randint(0, 256, (40, 40, 3), dtype=np.uint8)
                        ).save(os.path.join(img_dir, f"{name}.png"))
    rows = [{"reference": os.path.join(img_dir, f"{names[i]}.png"),
             "reference_name": names[i],
             "target": os.path.join(img_dir, f"{names[i + 1]}.png"),
             "target_name": names[i + 1],
             "captions": [f"cc caption {i}"]} for i in range(n)]
    with open(os.path.join(root, "cirr", "captions",
                           "cap.rc2.train.cc.json"), "w") as fh:
        json.dump(rows, fh)
    return names


@pytest.fixture(scope="module")
def cc_root(tmp_path_factory):
    root = make_cirr(str(tmp_path_factory.mktemp("cc") / "cirr_dataset"),
                     n_images=10, n_train=8, n_val=5, extended=True,
                     extend_suffix="zs")
    make_cirr(root, n_images=10, n_train=8, n_val=5, extended=True,
              extend_suffix="clip")
    _write_cc(root)
    return root


def _losses(text):
    return [json.loads(line)["loss"] for line in text.splitlines()
            if line.startswith('{"step"')]


def test_use_cc_reads_the_cc_triplets(tok, cc_root, tmp_path, capsys):
    """clip with --plus --use_cc: the human triplets plus the CC ones (the
    bank covers the CC images); zs --use_cc --wo_bank: the CC triplets
    alone replace the generated ones."""
    tf = ImageTransform("targetpad", 32)
    plain = CIRDataset("cirr", "train", "relative", tf, cc_root)
    plus = CIRDataset("cirr", "train", "relative", tf, cc_root, plus=True,
                      use_cc=True)
    assert len(plus.triplets) == len(plain.triplets) + 6
    best = train_main("clip", ARGV + ["--data_path", cc_root, "--output_path",
                                      str(tmp_path / "plus"), "--plus",
                                      "--use_cc"], tokenizer=tok, log_every=1)
    text = capsys.readouterr().out
    assert f"bank: {plus.num_unique_images} images" in text
    assert 0.0 <= best <= 100.0 and all(np.isfinite(_losses(text)))
    train_main("zs", ARGV + ["--data_path", cc_root, "--output_path",
                             str(tmp_path / "zs"), "--wo_bank", "--use_cc"],
               tokenizer=tok, log_every=1)
    assert len(_losses(capsys.readouterr().out)) == 6 // 4


def test_train_negtype_wrapper_end_to_end(tok, cc_root, tmp_path, capsys):
    argv = ARGV + ["--data_path", cc_root, "--output_path",
                   str(tmp_path / "negtype")]
    assert train_negtype.recipe_argv(argv) == argv + ["--wo_bank",
                                                      "--neg_type", "15"]
    assert train_negtype.recipe_argv(["--neg_type", "3", "--wo_bank"]) == [
        "--neg_type", "3", "--wo_bank"]
    best = train_negtype.main(argv, tokenizer=tok, log_every=1)
    text = capsys.readouterr().out
    assert "neg_type : 15" in text and "wo_bank : True" in text
    assert "RN50x4" not in text.split("clip_model_name :")[1].split("\n")[0]
    assert "bank:" not in text and 0.0 <= best <= 100.0
    assert len(_losses(text)) == 2 and all(np.isfinite(_losses(text)))


def test_train_negplus_wrapper_end_to_end(tok, cc_root, tmp_path, capsys):
    argv = ARGV + ["--data_path", cc_root, "--output_path",
                   str(tmp_path / "negplus")]
    assert train_negplus.recipe_argv(argv) == argv + ["--unlabeled"]
    assert train_negplus.recipe_argv(["--unlabeled"]) == ["--unlabeled"]
    train_negplus.main(argv, tokenizer=tok, log_every=0)
    text = capsys.readouterr().out
    assert "unlabeled : True" in text and "tau : 0.02" in text
    assert os.path.exists(tmp_path / "negplus" / "cirr_bank_unlabeled.npz")


def test_train_zs_wrappers_end_to_end(tok, cc_root, tmp_path, capsys):
    """zscir stage 1 (in-batch, end to end) and stage 2 (the bank) on the
    generated triplets, which replace the human ones; each with its own
    recipe defaults."""
    argv = ARGV + ["--data_path", cc_root]
    assert train_zs.recipe_argv(argv) == argv + ["--wo_bank"]
    train_zs.main(argv + ["--output_path", str(tmp_path / "zs1")],
                  tokenizer=tok, log_every=1)
    text = capsys.readouterr().out
    assert "tau : 0.01" in text and "learning_rate : 0.001" in text
    assert len(_losses(text)) == 8 // 4
    tf = ImageTransform("targetpad", 32)
    zs_ds = CIRDataset("cirr", "train", "relative", tf, cc_root,
                       extend_suffix="zs", replace_extended=True)
    human = CIRDataset("cirr", "train", "relative", tf, cc_root)
    assert [t["captions"] for t in zs_ds.triplets] != [
        t["captions"] for t in human.triplets]
    train_zs_bank.main(argv + ["--output_path", str(tmp_path / "zs2")],
                       tokenizer=tok, log_every=1)
    text = capsys.readouterr().out
    assert "tau : 0.02" in text and "wo_bank : False" in text
    assert f"bank: {zs_ds.num_unique_images} images" in text


def test_zs_recipes_and_first_word():
    assert common.ZSCIR_DEFAULTS == dict(default_model="ViT-L/14",
                                         default_tau=0.01, default_lr=2e-06,
                                         default_bs=48, default_epochs=10)
    assert common.ZSCIR_BANK_DEFAULTS == dict(
        default_model="ViT-L/14", default_tau=0.02, default_lr=2e-06,
        default_bs=128, default_epochs=5)
    assert common.backbone_from_argv(["zs", "--dataset", "cirr"]) == (
        "zs", ["--dataset", "cirr"])
    args = common.base_parser(**common.recipe_defaults("zs")).parse_args(
        ["--dataset", "cirr"])
    assert (args.clip_model_name, args.tau, args.batch_size) == ("ViT-L/14",
                                                                 0.01, 48)
    zs = build_backbone("zs", clip_model_name="test-tiny")
    assert (zs.name, zs.extend_suffix, zs.replace_extended, zs.tau) == (
        "zs", "zs", True, 0.01)
    assert hasattr(zs, "stage1_negtype_loss")


@pytest.mark.parametrize("name,can", [
    ("clip", (True, True, False, True)),
    ("zs", (True, True, True, True)),
    ("tgcir", (False, False, False, False)),
    ("blip", (True, False, False, True)),
    ("blip2", (False, False, False, True)),
])
def test_backbone_class_states_what_it_can_do(name, can):
    """The train CLI's refusals read these class attributes: a stage-1
    loss, a negtype loss, generated triplets in place of the human ones,
    gallery rows that can extend the target bank."""
    cls = backbone_class(name)
    assert cls.name == name
    assert (cls.has_stage1, hasattr(cls, "stage1_negtype_loss"),
            cls.replace_extended, cls.gallery_extends_target_bank) == can


@pytest.mark.parametrize("name,flags,error,match", [
    ("clip", ["--wo_bank", "--neg_type", "16"], SystemExit, "1-15"),
    ("clip", ["--neg_type", "3"], NotImplementedError,
     "--neg_type without --wo_bank"),
    ("blip2", ["--wo_bank", "--neg_type", "3"], NotImplementedError,
     "--neg_type with blip2"),
    ("clip", ["--use_cc"], NotImplementedError, "--use_cc without --plus"),
    ("blip", ["--wo_bank", "--use_cc"], NotImplementedError,
     "--use_cc without --plus"),
])
def test_new_refusals(name, flags, error, match, cc_root, tmp_path):
    """Refused before a model is built."""
    with pytest.raises(error, match=match):
        train_main(name, ARGV + ["--data_path", cc_root, "--output_path",
                                 str(tmp_path / "r")] + flags)
