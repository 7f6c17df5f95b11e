"""The port's blip4cir training and entry points against the JAX package, on
the CPU in float32.

`test-tiny` blip4cir (ViT: 32-pixel images, 5 tokens, width 32, 2 layers;
MED: hidden 32, 2 layers, cross-attention in both; `tiny_test_vocab`), the
same weights on both sides (`blip_state_dict_from_jax`), the same numpy
inputs from a seed, the same AdamW settings:
  - five stage-2 steps against `stage2_train_step` (the JAX step through the
    XLA loss): every loss, and the parameters after steps 1, 3 and 5, the
    learnable tau among them (it is decayed with the rest on both sides);
    the ViT and vision_proj bit-identical to the start;
  - three stage-1 steps against `stage1_train_step`: every weight trains;
  - `--grad_ckpt` (remat) gives the same loss and gradients;
  - the clip stage-1 loss, one step on a tiny ViT and on a tiny
    ModifiedResNet;
  - `train_main("blip")`, `--wo_bank`, `validate_main`, `submission_main` and
    `serve_main(backbone_name="blip")` with `--device cpu`, and equal Recall
    from both packages' `validate_main`.

Left out of the parameter comparisons, as in tests/test_torch_stage2.py:
parameters whose gradient is exactly zero, where Adam turns either side's
rounding noise into a step of size LR. Those are MED's `key.bias` (self and
cross: a constant added to all logits of a softmax row) and the key third
of the ViT's `attn.qkv.bias`.

Tolerances (float32; the sides differ in summation order, LayerNorm's
variance formula and Adam's bias-correction association): losses atol 5e-5;
gradients atol 2e-5, rtol 2e-3; parameters atol 3e-5, rtol 1e-3 at LR 1e-3,
where one step moves a coordinate by ~1e-3 (5e-5 after five steps and in
stage 1, where the gradient passes two more layers).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.cli.validate import validate_main as jax_validate_main
from spn4cir_tpu.models import clip as jclip
from spn4cir_tpu.models.api import build_backbone as jax_build_backbone
from spn4cir_tpu.tokenizer.bpe import tokenize as jax_tokenize
from spn4cir_tpu.train import stage1 as jstage1
from spn4cir_tpu.train import stage2 as jstage2
from spn4cir_tpu_torch.cli.serve import serve_main
from spn4cir_tpu_torch.cli.submission import submission_main
from spn4cir_tpu_torch.cli.train import (BLIP4CIR_DEFAULTS, CLIP4CIR_DEFAULTS,
                                         train_main)
from spn4cir_tpu_torch.cli.validate import validate_main
from spn4cir_tpu_torch.cli import common
from spn4cir_tpu_torch.models import clip as tclip
from spn4cir_tpu_torch.models.api import build_backbone
from spn4cir_tpu_torch.models.clip4cir import ClipCIR
from spn4cir_tpu_torch.models.convert import (blip_state_dict_from_jax,
                                              clip_state_dict_from_train_state,
                                              load_blip_checkpoint)
from spn4cir_tpu_torch.ops import attention_kernels, bank_kernels
from spn4cir_tpu_torch.train import stage1, stage2
from spn4cir_tpu_torch.utils.checkpoint import save_model
from tests.fixtures import make_cirr
from tests.torch_fixtures import synthetic_tokenizer

torch.set_num_threads(1)

LR = 1e-3
B, M = 6, 40
LOSS_TOL = dict(atol=5e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-3)
PARAM_TOL = dict(atol=3e-5, rtol=1e-3)
LATE_PARAM_TOL = dict(atol=5e-5, rtol=1e-3)
CAPTIONS = ["make it more blue", "a red dress with short sleeve",
            "less print", "the long shirt", "it", "more red less blue"]


@pytest.fixture(scope="module")
def jax_side():
    jb = jax_build_backbone("blip", blip_size="test-tiny")
    params = jax.jit(jb.init_params)(jax.random.PRNGKey(0))
    return jb, params


def _port(params, **kw):
    tb = build_backbone("blip", blip_size="test-tiny", **kw)
    tb.model.load_state_dict(blip_state_dict_from_jax(jax.device_get(params)))
    return tb


def _comparable(name: str, t: torch.Tensor):
    """The part of a tensor whose gradient is not identically zero (None
    when none is): see the module docstring."""
    if name.endswith(".self.key.bias"):
        return None
    if name.endswith("attn.qkv.bias"):
        third = t.shape[0] // 3
        return torch.cat([t[:third], t[2 * third:]])
    return t


def _frozen(name: str) -> bool:
    return name.startswith(("visual_encoder.", "vision_proj."))


def _compare_params(tb, jstate, start, tol, frozen=_frozen, label=""):
    want = blip_state_dict_from_jax(jax.device_get(jstate))
    moved = 0.0
    for name, got in tb.model.state_dict().items():
        if frozen(name):
            assert torch.equal(got, start[name]), name
            assert torch.equal(want[name], start[name]), name
            continue
        a, b = _comparable(name, got), _comparable(name, want[name])
        if a is None:
            continue
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   err_msg=f"{name} {label}", **tol)
        moved = max(moved, (a - _comparable(name, start[name]))
                    .abs().max().item())
    return moved


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _stage2_batches(rng, tb, n):
    bank = _norm(rng.randn(M, 256)).astype(np.float32)
    out = []
    for i in range(n):
        caps = [CAPTIONS[(i + j) % len(CAPTIONS)] for j in range(B)]
        out.append({"refer_feats": rng.randn(B, 5, 32).astype(np.float32),
                    "text_ids": tb.tokenize(caps),
                    "labels": rng.randint(0, M, B).astype(np.int64)})
    return bank, out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_stage2_step0_loss_and_gradients_match_jax(jax_side, rng):
    jb, params = jax_side
    tb = _port(params)
    bank, (batch,) = _stage2_batches(rng, tb, 1)
    jbatch = _jax(batch)
    want_loss, want_grads = jax.value_and_grad(lambda p: jb.stage2_loss(
        p, jbatch["refer_feats"], jbatch["text_ids"], jnp.asarray(bank),
        jbatch["labels"], impl="xla"))(params)
    stage2.create_train_state(tb, LR)
    tbatch = _torch(batch)
    before = (bank_kernels.bank_infonce_fwd.launches,
              attention_kernels.long_attention.launches)
    loss = tb.stage2_loss(tbatch["refer_feats"], tbatch["text_ids"],
                          torch.from_numpy(bank), tbatch["labels"])
    loss.backward()
    assert before == (bank_kernels.bank_infonce_fwd.launches,
                      attention_kernels.long_attention.launches)
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    want = blip_state_dict_from_jax(jax.device_get(want_grads))
    checked = 0
    for name, p in tb.model.named_parameters():
        if _frozen(name):
            assert p.grad is None, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
        checked += 1
    assert checked == 4 + 2 * 26 + 2 + 1   # embeddings, layers, text_proj, tau
    assert tb.model.tau.grad.abs() > 0
    # the zero-gradient parameters are zero to rounding on both sides
    for name, p in tb.model.named_parameters():
        if name.endswith(".self.key.bias"):
            assert p.grad.abs().max() < 1e-6, name


def test_five_stage2_steps_match_jax(jax_side, rng):
    jb, params = jax_side
    tb = _port(params)
    start = {k: v.clone() for k, v in tb.model.state_dict().items()}
    bank, batches = _stage2_batches(rng, tb, 5)
    jstate = jstage2.create_train_state(jb, params, LR)
    state = stage2.create_train_state(tb, LR)
    tbank, jbank = torch.from_numpy(bank), jnp.asarray(bank)
    moved = 0.0
    for step, batch in enumerate(batches, start=1):
        jstate, want_loss = jstage2.stage2_train_step(jb, jstate, jbank,
                                                      _jax(batch), "xla")
        loss = stage2.stage2_train_step(tb, state, tbank, _torch(batch))
        assert not loss.requires_grad and state.step == step
        np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
        if step in (1, 3, 5):
            moved = max(moved, _compare_params(
                tb, jstate, start, PARAM_TOL if step < 5 else LATE_PARAM_TOL,
                label=f"after {step}"))
    assert moved > 50 * PARAM_TOL["atol"], moved
    # tau is trained and decayed on both sides
    tau = tb.model.tau.item()
    want_tau = float(jax.device_get(jstate.params)["params"]["tau"])
    assert abs(tau - 0.03) > 1e-4 and abs(tau - want_tau) < 3e-5


def _stage1_batches(rng, tb, n):
    out = []
    for i in range(n):
        caps = [CAPTIONS[(i + j) % len(CAPTIONS)] for j in range(B)]
        out.append({
            "refer_images": rng.randn(B, 32, 32, 3).astype(np.float32),
            "target_images": rng.randn(B, 32, 32, 3).astype(np.float32),
            "text_ids": tb.tokenize(caps)})
    return out


def test_three_stage1_steps_match_jax(jax_side, rng):
    jb, params = jax_side
    tb = _port(params)
    start = {k: v.clone() for k, v in tb.model.state_dict().items()}
    jstate = jstage1.create_stage1_state(jb, params, LR)
    state = stage1.create_stage1_state(tb, LR)
    assert all(p.requires_grad for p in tb.parameters())
    moved = 0.0
    for step, batch in enumerate(_stage1_batches(rng, tb, 3), start=1):
        jstate, want_loss = jstage1.stage1_train_step(jb, jstate, _jax(batch))
        loss = stage1.stage1_train_step(tb, state, _torch(batch))
        np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
        if step in (1, 3):
            moved = max(moved, _compare_params(
                tb, jstate, start, LATE_PARAM_TOL, frozen=lambda n: False,
                label=f"after {step}"))
    assert moved > 50 * PARAM_TOL["atol"], moved
    vit_moved = (tb.model.visual_encoder.blocks[0].mlp.fc1.weight
                 - start["visual_encoder.blocks.0.mlp.fc1.weight"]).abs().max()
    assert vit_moved > 1e-4


def test_stage1_gradients_match_jax_and_key_biases_get_zero(jax_side, rng):
    jb, params = jax_side
    tb = _port(params)
    batch, = _stage1_batches(rng, tb, 1)
    jbatch = _jax(batch)
    want_loss, want_grads = jax.value_and_grad(lambda p: jb.stage1_loss(
        p, jbatch["refer_images"], jbatch["target_images"],
        jbatch["text_ids"]))(params)
    stage1.create_stage1_state(tb, LR)
    loss = tb.stage1_loss(*_torch(batch).values())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    want = blip_state_dict_from_jax(jax.device_get(want_grads))
    for name, p in tb.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    qkv = tb.model.visual_encoder.blocks[1].attn.qkv.bias.grad
    third = qkv.shape[0] // 3
    assert qkv[third:2 * third].abs().max() < 1e-6 < qkv[:third].abs().max()


def test_grad_ckpt_gives_the_same_loss_and_gradients(jax_side, rng):
    jb, params = jax_side
    plain, remat = _port(params), _port(params, remat=True)
    assert remat.model.visual_encoder.remat and not plain.model.visual_encoder.remat
    batch, = _stage1_batches(rng, plain, 1)
    calls = {"n": 0}
    block = remat.model.visual_encoder.blocks[0]
    # a pre-hook: the recomputation stops early, once the last tensor the
    # backward needs is there, so a block's second forward never returns
    block.register_forward_pre_hook(
        lambda *a: calls.__setitem__("n", calls["n"] + 1))
    grads = []
    for tb in (plain, remat):
        stage1.create_stage1_state(tb, LR)
        loss = tb.stage1_loss(*_torch(batch).values())
        loss.backward()
        grads.append((loss.detach(), {n: p.grad for n, p in
                                      tb.model.named_parameters()}))
    # two tower calls, each block run again in the backward
    assert calls["n"] == 4
    assert torch.equal(grads[0][0], grads[1][0])
    for name, g in grads[0][1].items():
        torch.testing.assert_close(grads[1][1][name], g, atol=0, rtol=0,
                                   msg=name)


# ---- clip stage 1 ----

RN_TINY = dict(embed_dim=32, image_resolution=32, vision_layers=(1, 1, 1, 1),
               vision_width=8, vision_patch_size=None, context_length=77,
               transformer_width=32, transformer_heads=2,
               transformer_layers=2)


@pytest.mark.parametrize("model", ["test-tiny", "test-rn"])
def test_clip_stage1_step_matches_jax(model, rng, monkeypatch):
    """One stage-1 step of clip4cir on a tiny ViT and on a tiny
    ModifiedResNet (BatchNorm on the stored statistics, its affine
    parameters train; `logit_scale` and the statistics do not move)."""
    monkeypatch.setitem(jclip.CLIP_CONFIGS, "test-rn",
                        jclip.CLIPConfig(**RN_TINY))
    monkeypatch.setitem(tclip.CLIP_CONFIGS, "test-rn",
                        tclip.CLIPConfig(**RN_TINY))
    tok = synthetic_tokenizer()
    jb = jax_build_backbone("clip", clip_model_name=model)
    params = jax.jit(jb.init_params)(jax.random.PRNGKey(0))
    tb = ClipCIR(model, tokenizer=tok)
    tb.model.load_state_dict(clip_state_dict_from_train_state(params, tb.cfg))
    start = {k: v.clone() for k, v in tb.model.state_dict().items()}
    ids = np.asarray(jax_tokenize(CAPTIONS, context_length=77, truncate=True,
                                  tokenizer=tok))
    batch = {"refer_images": rng.randn(B, 32, 32, 3).astype(np.float32),
             "target_images": rng.randn(B, 32, 32, 3).astype(np.float32),
             "text_ids": ids}
    jstate = jstage1.create_stage1_state(jb, params, LR)
    jstate, want_loss = jstage1.stage1_train_step(jb, jstate, _jax(batch))
    state = stage1.create_stage1_state(tb, LR)
    loss = stage1.stage1_train_step(tb, state, _torch(batch))
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    stats = (jax.device_get(params).get("batch_stats")
             if model == "test-rn" else None)
    want = clip_state_dict_from_train_state(jax.device_get(jstate), tb.cfg,
                                            stats)
    moved = held = seen = 0
    for name, got in tb.model.state_dict().items():
        if name == "logit_scale" or "running_" in name or "num_batches" in name:
            assert torch.equal(got, start[name]), name
            continue
        a, b = got, want[name]
        if name.endswith("attn.in_proj_bias"):      # zero-gradient key third
            third = a.shape[0] // 3
            a = torch.cat([a[:third], a[2 * third:]])
            b = torch.cat([b[:third], b[2 * third:]])
        if name.endswith("attnpool.k_proj.bias"):   # zero gradient too
            continue
        # a first Adam step is lr * g / (|g| + 1e-7): where |g| is within
        # rounding noise of that eps, the step's size is noise. Such
        # elements (a handful per tensor) are held to the step's bound.
        grad = tb.model.get_parameter(name).grad
        if name.endswith("attn.in_proj_bias"):
            grad = torch.cat([grad[:third], grad[2 * third:]])
        sure = (grad.abs() > 3e-6) | (grad == 0)    # unused table rows
        held += int(sure.sum())
        seen += sure.numel()
        np.testing.assert_allclose(a[sure].numpy(), b[sure].numpy(),
                                   err_msg=name, **PARAM_TOL)
        assert (a - b).abs().max() <= 2.1 * LR, name
        moved += int(not torch.equal(got, start[name]))
    assert moved > 20 and held > 0.9 * seen, (moved, held, seen)
    visual = "visual.bn1.weight" if model == "test-rn" else "visual.proj"
    assert not torch.equal(tb.model.state_dict()[visual], start[visual])


# ---- entry points ----

ARGV = ["--dataset", "cirr", "--clip-model-name", "test-tiny", "--device",
        "cpu", "--batch-size", "4", "--learning-rate", "1e-3", "--seed", "0"]


@pytest.fixture(scope="module")
def cirr_root(tmp_path_factory):
    return make_cirr(str(tmp_path_factory.mktemp("blip") / "cirr_dataset"),
                     n_images=20, n_train=12, n_val=9, extended=False)


def _counters():
    return [attention_kernels.long_attention,
            attention_kernels.long_attention_bwd,
            attention_kernels.short_attention, bank_kernels.bank_infonce_fwd,
            bank_kernels.bank_infonce_bwd]


def test_defaults_are_the_recipes():
    assert BLIP4CIR_DEFAULTS == dict(default_model="RN50x4", default_tau=0.03,
                                     default_lr=5e-06, default_bs=128,
                                     default_epochs=10)
    assert common.backbone_from_argv(["blip", "--dataset", "cirr"]) == (
        "blip", ["--dataset", "cirr"])
    assert common.backbone_from_argv(["--dataset", "cirr"]) == (
        "clip", ["--dataset", "cirr"])
    assert common.backbone_from_argv(["clip"]) == ("clip", [])
    assert common.recipe_defaults("blip") is BLIP4CIR_DEFAULTS
    assert common.recipe_defaults("clip") is CLIP4CIR_DEFAULTS
    assert common.recipe_defaults("zs") is CLIP4CIR_DEFAULTS
    # an unknown backbone raises before a parser takes another's recipe
    with pytest.raises(NotImplementedError, match="tgcir"):
        train_main("tgcir", ["--dataset", "cirr"])
    args = common.base_parser(**BLIP4CIR_DEFAULTS).parse_args(
        ["--dataset", "cirr"])
    assert (args.tau, args.learning_rate, args.batch_size,
            args.num_epochs) == (0.03, 5e-6, 128, 10)


def test_train_validate_submission_main_blip_cpu_end_to_end(
        cirr_root, tmp_path, capsys, monkeypatch):
    """Stage 2 through the CLI: token-shaped refer bank, two epochs with
    dropout, a best checkpoint with the BLIP names, then validation and the
    submission files from it."""
    out = str(tmp_path / "run")
    before = [c.launches for c in _counters()]
    argv = ARGV + ["--data_path", cirr_root, "--output_path", out,
                   "--num-epochs", "2", "--dropout", "0.1"]
    best = train_main("blip", argv, log_every=1)
    assert [c.launches for c in _counters()] == before     # CPU: no launch
    text = capsys.readouterr().out
    assert "refer (" in text and ", 5, 32)" in text and "epoch 1: mean" in text
    assert "tau : 0.03" in text                 # blip's default, not clip's
    assert 0.0 < best <= 100.0
    bank = np.load(os.path.join(out, "cirr_bank.npz"))
    assert bank["refer"].shape[1:] == (5, 32)
    assert bank["target"].shape[1:] == (256,)
    ckpt = os.path.join(out, "best.pt")
    sd = load_blip_checkpoint(ckpt)
    fresh = build_backbone("blip", blip_size="test-tiny")
    fresh.init_params(torch.Generator().manual_seed(0))
    assert set(sd) == set(fresh.model.state_dict())
    for name, t in fresh.model.state_dict().items():
        if _frozen(name):
            assert torch.equal(sd[name], t), f"frozen {name} moved"
    assert not torch.equal(sd["text_proj.weight"],
                           fresh.model.text_proj.weight)
    assert sd["tau"].item() != pytest.approx(0.03, abs=1e-6)

    results = validate_main("blip", ARGV + ["--data_path", cirr_root,
                                            "--model_path", ckpt])
    assert results["arithmetic_mean"] == pytest.approx(best)
    monkeypatch.chdir(tmp_path)
    paths = submission_main("blip", ARGV + [
        "--data_path", cirr_root, "--model_path", ckpt, "--submission-name",
        "t"])
    assert paths[0] == os.path.join("submission", "blip4cir",
                                    "recall_submission_t.json")
    for path in paths:
        with open(path) as fh:
            doc = json.load(fh)
        assert doc["version"] == "rc2" and len(doc) > 2


def test_train_main_blip_wo_bank_cpu(cirr_root, tmp_path, capsys):
    """Stage 1 through the CLI (`--wo_bank --grad_ckpt`): no bank file, every
    tower trains, the loss is logged per step."""
    out = str(tmp_path / "run1")
    best = train_main("blip", ARGV + [
        "--data_path", cirr_root, "--output_path", out, "--num-epochs", "1",
        "--wo_bank", "--grad_ckpt"], log_every=1)
    text = capsys.readouterr().out
    losses = [json.loads(l)["loss"] for l in text.splitlines()
              if l.startswith('{"step"')]
    assert len(losses) == 3 and all(np.isfinite(losses))    # 12 // 4
    assert not os.path.exists(os.path.join(out, "cirr_bank.npz"))
    assert "bank:" not in text and 0.0 <= best <= 100.0
    sd = load_blip_checkpoint(os.path.join(out, "best.pt"))
    fresh = build_backbone("blip", blip_size="test-tiny")
    fresh.init_params(torch.Generator().manual_seed(0))
    assert not torch.equal(sd["visual_encoder.blocks.0.mlp.fc1.weight"],
                           fresh.model.visual_encoder.blocks[0].mlp.fc1.weight)
    with pytest.raises(NotImplementedError, match="--neg_type"):
        train_main("blip", ARGV + ["--data_path", cirr_root, "--wo_bank",
                                   "--neg_type", "3"])


@pytest.mark.parametrize("flags,match", [
    (["--bank_dtype", "int8"], "--bank_dtype int8"),
    (["--bank_dtype", "bfloat16"], "--bank_dtype bfloat16"),
    (["--unlabeled"], "--unlabeled"),
    (["--neg_num", "5"], "--neg_num"),
    (["--bank_path", "bank.npz"], "--bank_path"),
    (["--reload_bank"], "--reload_bank"),
])
@pytest.mark.parametrize("name", ["clip", "blip"])
def test_wo_bank_refuses_the_bank_flags(name, flags, match, cirr_root):
    """Stage 1 builds no bank, so a flag that shapes one is refused and not
    ignored; it exits before a model is built."""
    with pytest.raises(SystemExit) as err:
        train_main(name, ARGV + ["--data_path", cirr_root, "--wo_bank"]
                   + flags)
    assert match in str(err.value) and "has no bank" in str(err.value)


def test_train_main_clip_wo_bank_cpu(cirr_root, tmp_path, capsys):
    out = str(tmp_path / "run_clip")
    best = train_main("clip", ARGV + [
        "--data_path", cirr_root, "--output_path", out, "--num-epochs", "1",
        "--wo_bank", "--grad_ckpt"], tokenizer=synthetic_tokenizer(),
        log_every=1)
    text = capsys.readouterr().out
    assert text.count('{"step"') == 3 and 0.0 <= best <= 100.0
    assert "tau : 0.02" in text
    sd = torch.load(os.path.join(out, "best.pt"))["state_dict"]
    fresh = ClipCIR("test-tiny", tokenizer=object())
    fresh.init_params(torch.Generator().manual_seed(0))
    assert not torch.equal(sd["visual.proj"], fresh.model.visual.proj)
    assert torch.equal(sd["logit_scale"], fresh.model.logit_scale)


def test_validate_main_recall_equals_jax_for_blip(jax_side, cirr_root,
                                                  tmp_path, monkeypatch):
    jb, params = jax_side
    monkeypatch.setenv("SPN4CIR_NATIVE", "0")       # both sides decode with PIL

    def make_backbone(name, args):
        assert (name, args.clip_model_name) == ("blip", "test-tiny")
        return jb

    monkeypatch.setattr("spn4cir_tpu.cli.validate.make_backbone",
                        make_backbone)
    monkeypatch.setattr("spn4cir_tpu.cli.validate.load_or_init_params",
                        lambda backbone, args, key: params)
    want = jax_validate_main("blip", ["--dataset", "cirr", "--data_path",
                                      cirr_root, "--clip-model-name",
                                      "test-tiny"])
    ckpt = str(tmp_path / "weights.pth")
    save_model(ckpt, _port(params).model, epoch=0)
    got = validate_main("blip", ARGV + ["--data_path", cirr_root,
                                        "--model_path", ckpt])
    assert got.keys() == want.keys() and "arithmetic_mean" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    assert any(v > 0 for v in got.values())


def test_serve_main_blip_cpu(jax_side, cirr_root, tmp_path):
    """The retrieval service over a blip index: the refer side holds ViT
    tokens on the host, a query by gallery name excludes its reference."""
    jb, params = jax_side
    ckpt = str(tmp_path / "weights.pth")
    tb = _port(params)
    # an upstream checkpoint: CIRPlus prefix, no temperature
    torch.save({"model": {f"blip.{k}": v for k, v in
                          tb.model.state_dict().items() if k != "tau"}}, ckpt)
    server, service = serve_main(
        ["--dataset", "cirr", "--data_path", cirr_root, "--clip-model-name",
         "test-tiny", "--device", "cpu", "--serve_host", "127.0.0.1",
         "--serve_port", "0", "--no-block", "--batch-size", "4",
         "--model_path", ckpt, "--text_max_len", "20"], backbone_name="blip")
    try:
        index = service.index
        assert index.refer.shape == (len(index.names), 5, 32)
        assert index.target.shape == (len(index.names), 256)
        assert service.backbone.text_max_len == 20
        assert service.backbone.model.tau.item() == pytest.approx(0.03)
        name = index.names[3]
        results = service.query_by_name(name, "make it more blue", k=5)
        assert len(results) == 5 and name not in [r["name"] for r in results]
        scores = [r["score"] for r in results]
        assert scores == sorted(scores, reverse=True)
        # the same query by hand
        with torch.inference_mode():
            q = tb.eval().fuse(
                index.refer_rows(np.asarray([3])),
                torch.from_numpy(service.backbone.tokenize(
                    ["make it more blue"])))
            want = (q @ index.target.T)[0]
            want[3] = float("-inf")
        assert results[0]["name"] == index.names[int(want.argmax())]
        assert results[0]["score"] == pytest.approx(want.max().item(),
                                                    abs=1e-5)
    finally:
        server.shutdown()
        server.server_close()


def test_blip_entry_points_default_to_cuda(cirr_root):
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        validate_main("blip", ["--clip-model-name", "test-tiny", "--dataset",
                               "cirr", "--data_path", cirr_root])
