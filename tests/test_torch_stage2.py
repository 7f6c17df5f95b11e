"""The port's stage-2 trainer against the JAX package, on the CPU in float32.

A two-layer narrow CLIP (`test-tiny`: width 32, 2 heads, 2 + 2 layers) with
the same weights on both sides (`clip_state_dict_from_train_state`), the
same numpy inputs from a seed, the same optimizer settings. Rungs, as in
tests/test_parity_trainstep.py:
  rung 1: the step-0 loss and the gradient of every trainable parameter;
  rung 2: the loss of every step;
  rung 3: the parameters after 1 and after 3 AdamW steps; frozen tensors
          (image tower, logit_scale) bit-identical to the start on both
          sides.
Then the epoch loop on a fixture dataset (both packages' `train_epoch`, full
bank and sampled negatives), the learning-rate schedules, and the training
CLI end to end with `--device cpu`.

Tolerances (float32; the sides differ in summation order, in LayerNorm's
variance formula and in how Adam's bias correction is associated): losses
atol 5e-5, rtol 1e-5; gradients atol 2e-5, rtol 2e-3; parameters after training atol
3e-5, rtol 1e-3 at LR 1e-3, where one step moves a coordinate by ~1e-3.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.bank.bank import Bank as JaxBank
from spn4cir_tpu.data.datasets import (CIRDataset as JaxCIRDataset,
                                       iter_train_bank as jax_iter_train_bank)
from spn4cir_tpu.data.transforms import ImageTransform as JaxImageTransform
from spn4cir_tpu.models import clip as jclip
from spn4cir_tpu.models.api import build_backbone as jax_build_backbone
from spn4cir_tpu.ops import bank_kernels as jax_bank_kernels
from spn4cir_tpu.tokenizer.bpe import tokenize as jax_tokenize
from spn4cir_tpu.train import stage2 as jstage2
from spn4cir_tpu_torch.bank.bank import Bank
from spn4cir_tpu_torch.cli.common import backbone_from_argv
from spn4cir_tpu_torch.cli.train import train_main
from spn4cir_tpu_torch.data.datasets import CIRDataset, iter_train_bank
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.models import clip as tclip
from spn4cir_tpu_torch.models.clip4cir import ClipCIR
from spn4cir_tpu_torch.models.convert import clip_state_dict_from_train_state
from spn4cir_tpu_torch.ops import attention_kernels, bank_kernels
from spn4cir_tpu_torch.train import stage2
from spn4cir_tpu_torch.utils.checkpoint import load_model, save_model
from spn4cir_tpu_torch.utils.logging import MetricLogger, StepTimer
from tests.fixtures import make_cirr
from tests.torch_fixtures import synthetic_tokenizer

torch.set_num_threads(1)

LR = 1e-3
B, M = 6, 40
LOSS_TOL = dict(atol=5e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-3)
PARAM_TOL = dict(atol=3e-5, rtol=1e-3)


@pytest.fixture(scope="module")
def tok():
    return synthetic_tokenizer()


@pytest.fixture(scope="module")
def jax_side(tok):
    jb = jax_build_backbone("clip", clip_model_name="test-tiny")
    jb.tokenize = lambda texts: jax_tokenize(texts, context_length=77,
                                             truncate=True, tokenizer=tok)
    params = jax.jit(jb.init_params)(jax.random.PRNGKey(0))
    return jb, params


def _port_backbone(tok, params) -> ClipCIR:
    tb = ClipCIR("test-tiny", tokenizer=tok)
    tb.model.load_state_dict(clip_state_dict_from_train_state(params, tb.cfg))
    return tb


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _batches(rng, n, neg_num=None, vocab=49408):
    bank = _norm(rng.randn(M, 32)).astype(np.float32)
    out = []
    for _ in range(n):
        ids = np.zeros((B, 77), np.int32)
        for row in range(B):
            k = rng.randint(1, 30)
            ids[row, 0] = vocab - 2
            ids[row, 1:k + 1] = rng.randint(1, 800, k)
            ids[row, k + 1] = vocab - 1
        batch = {"refer_feats": rng.randn(B, 32).astype(np.float32),
                 "text_ids": ids,
                 "labels": rng.randint(0, M, B).astype(np.int64)}
        if neg_num:
            batch["neg_idx"] = stage2.sample_negatives(rng, batch["labels"], M,
                                                       neg_num)
        out.append(batch)
    return bank, out


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _frozen(name: str) -> bool:
    """By the CLIP model's parameter name, or the backbone's ('model.'...)."""
    name = name.removeprefix("model.")
    return name.startswith("visual.") or name == "logit_scale"


def _comparable(name: str, t: torch.Tensor) -> torch.Tensor:
    """The part of a trained tensor that the two sides must agree on. The
    key third of `in_proj_bias` is left out: a softmax does not change when
    one constant is added to all its logits, so that bias has a gradient of
    exactly zero, what either side computes for it is rounding noise, and
    Adam scales noise of either sign to a full step of size LR."""
    if name.endswith("attn.in_proj_bias"):
        third = t.shape[0] // 3
        return torch.cat([t[:third], t[2 * third:]])
    return t


def test_trainable_mask_freezes_the_image_tower_and_logit_scale(tok, jax_side):
    jb, params = jax_side
    tb = _port_backbone(tok, params)
    mask = stage2.trainable_mask(tb)
    assert set(mask) == {n for n, _ in tb.named_parameters()}
    for name, trains in mask.items():
        assert trains == (not _frozen(name)), name
    # the same split as the JAX mask, leaf for leaf through the converter:
    # a frozen JAX leaf set to NaN shows up only in frozen port tensors
    jmask = jstage2.trainable_mask(params, jb.trainable_filter)
    marked = jax.tree_util.tree_map(
        lambda p, m: np.full(np.shape(p), 0.0 if m else np.nan, np.float32),
        jax.device_get(params), jmask)
    for name, t in clip_state_dict_from_train_state(marked, tb.cfg).items():
        assert bool(torch.isnan(t).all()) == (not mask["model." + name]), name
    state = stage2.create_train_state(tb, LR)
    in_opt = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    for name, p in tb.named_parameters():
        assert p.requires_grad == mask[name] == (id(p) in in_opt), name
    group = state.optimizer.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == (
        (0.9, 0.999), 1e-7, 1e-2)


@pytest.mark.parametrize("neg_num", [None, 7])
def test_step0_loss_and_gradients_match_jax(neg_num, tok, jax_side, rng):
    jb, params = jax_side
    tb = _port_backbone(tok, params)
    bank, (batch,) = _batches(rng, 1, neg_num)
    jbatch = _to_jax(batch)

    def loss_fn(p):
        return jb.stage2_loss(p, jbatch["refer_feats"], jbatch["text_ids"],
                              jnp.asarray(bank), jbatch["labels"],
                              neg_idx=jbatch.get("neg_idx"), impl="xla")

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    stage2.create_train_state(tb, LR)       # sets requires_grad from the mask
    tbatch = _to_torch(batch)
    loss = tb.stage2_loss(tbatch["refer_feats"], tbatch["text_ids"],
                          torch.from_numpy(bank), tbatch["labels"],
                          neg_idx=tbatch.get("neg_idx"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    want = clip_state_dict_from_train_state(jax.device_get(want_grads), tb.cfg)
    checked = 0
    for name, p in tb.model.named_parameters():
        if _frozen(name):
            assert p.grad is None, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
        checked += 1
    # in_proj, LayerNorm and both embeddings get gradients through the
    # per-use dtype casts
    for name in ("transformer.resblocks.0.attn.in_proj_weight",
                 "transformer.resblocks.1.ln_1.weight", "ln_final.bias",
                 "token_embedding.weight", "positional_embedding",
                 "text_projection"):
        assert tb.model.get_parameter(name).grad.abs().max() > 0, name
    assert checked == 29     # 12 per text block x 2, embeddings, ln_final, proj


@pytest.mark.parametrize("neg_num", [None, 7])
def test_parameters_after_1_and_3_steps_match_jax(neg_num, tok, jax_side, rng):
    jb, params = jax_side
    tb = _port_backbone(tok, params)
    start = {k: v.clone() for k, v in tb.model.state_dict().items()}
    bank, batches = _batches(rng, 3, neg_num)
    jstate = jstage2.create_train_state(jb, params, LR)
    state = stage2.create_train_state(tb, LR)
    tbank, jbank = torch.from_numpy(bank), jnp.asarray(bank)
    moved = 0.0
    for step, batch in enumerate(batches, start=1):
        jstate, want_loss = jstage2.stage2_train_step(jb, jstate, jbank,
                                                      _to_jax(batch), "xla")
        loss = stage2.stage2_train_step(tb, state, tbank, _to_torch(batch))
        assert not loss.requires_grad and state.step == step
        np.testing.assert_allclose(loss.item(), float(want_loss),
                                   **LOSS_TOL)
        if step not in (1, 3):
            continue
        want = clip_state_dict_from_train_state(jax.device_get(jstate), tb.cfg)
        for name, got in tb.model.state_dict().items():
            if _frozen(name):
                assert torch.equal(got, start[name]), name
                assert torch.equal(want[name], start[name]), name
            else:
                got, ref = _comparable(name, got), _comparable(name, want[name])
                np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                           err_msg=f"{name} after {step}",
                                           **PARAM_TOL)
                moved = max(moved, (got - _comparable(name, start[name]))
                            .abs().max().item())
    assert moved > 50 * PARAM_TOL["atol"], moved


RN_TINY = dict(embed_dim=32, image_resolution=32, vision_layers=(1, 1, 1, 1),
               vision_width=8, vision_patch_size=None, context_length=77,
               transformer_width=32, transformer_heads=2,
               transformer_layers=2)


@pytest.fixture
def rn_sides(tok, monkeypatch):
    """Both packages' clip4cir backbone over a narrow ResNet-tower CLIP
    ("test-rn", registered for the length of one test), same weights."""
    monkeypatch.setitem(jclip.CLIP_CONFIGS, "test-rn",
                        jclip.CLIPConfig(**RN_TINY))
    monkeypatch.setitem(tclip.CLIP_CONFIGS, "test-rn",
                        tclip.CLIPConfig(**RN_TINY))
    jb = jax_build_backbone("clip", clip_model_name="test-rn")
    params = jax.jit(jb.init_params)(jax.random.PRNGKey(0))
    assert "batch_stats" in params
    tb = ClipCIR("test-rn", tokenizer=tok)
    tb.model.load_state_dict(clip_state_dict_from_train_state(params, tb.cfg))
    return jb, params, tb


def test_resnet_tower_int8_bank_steps_match_jax(rn_sides, rng):
    """Stage-2 steps of a ResNet-tower model against an int8 bank: the JAX
    step runs `bank_infonce_q8_pallas` in interpret mode, the port its plain
    version; losses and the parameters after 1 and 3 steps agree (the key
    third of `in_proj_bias` left out, see `_comparable`), and the image
    tower, its running statistics and `logit_scale` do not move."""
    jb, params, tb = rn_sides
    start = {k: v.clone() for k, v in tb.model.state_dict().items()}
    bank, batches = _batches(rng, 3)
    tbank = bank_kernels.quantize_bank(torch.from_numpy(bank))
    jbank = jax_bank_kernels.QuantBank(jnp.asarray(tbank.values.numpy()),
                                       jnp.asarray(tbank.scales.numpy()))
    jstate = jstage2.create_train_state(jb, params, LR)
    state = stage2.create_train_state(tb, LR)
    assert not any(p.requires_grad for n, p in tb.model.named_parameters()
                   if n.startswith("visual."))
    for step, batch in enumerate(batches, start=1):
        jstate, want_loss = jstage2.stage2_train_step(jb, jstate, jbank,
                                                      _to_jax(batch), "pallas")
        loss = stage2.stage2_train_step(tb, state, tbank, _to_torch(batch))
        np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
        if step not in (1, 3):
            continue
        want = clip_state_dict_from_train_state(jax.device_get(jstate), tb.cfg)
        for name, got in tb.model.state_dict().items():
            if _frozen(name):
                assert torch.equal(got, start[name]), name
                if not name.endswith("num_batches_tracked"):
                    assert torch.equal(want[name], start[name]), name
            else:
                np.testing.assert_allclose(
                    _comparable(name, got).numpy(),
                    _comparable(name, want[name]).numpy(),
                    err_msg=f"{name} after {step}", **PARAM_TOL)
    assert not torch.equal(tb.model.text_projection, start["text_projection"])


@pytest.mark.parametrize("kind,warmup", [("constant", 0), ("cosine", 0),
                                         ("cosine", 5), ("linear", 0)])
def test_lr_schedules_match_optax(kind, warmup):
    want = jstage2.make_lr_schedule(kind, 2e-5, 10, 3, warmup, 1e-6)
    got = stage2.make_lr_schedule(kind, 2e-5, 10, 3, warmup, 1e-6)
    for step in (0, 1, 4, 5, 6, 15, 29, 30, 45):
        w = float(want(step)) if callable(want) else want
        g = got(step) if callable(got) else got
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-12,
                                   err_msg=f"{kind} step {step}")
    with pytest.raises(ValueError, match="unknown lr schedule"):
        stage2.make_lr_schedule("step", 1e-3, 10, 3)


def test_scheduled_lr_reaches_the_optimizer(tok, jax_side, rng):
    _, params = jax_side
    tb = _port_backbone(tok, params)
    bank, batches = _batches(rng, 3)
    state = stage2.create_train_state(tb, lambda step: 1e-3 / (step + 1))
    seen = []
    for batch in batches:
        stage2.stage2_train_step(tb, state, torch.from_numpy(bank),
                                 _to_torch(batch))
        seen.append(state.optimizer.param_groups[0]["lr"])
    np.testing.assert_allclose(seen, [1e-3, 5e-4, 1e-3 / 3])


@pytest.fixture(scope="module")
def cirr_root(tmp_path_factory):
    return make_cirr(str(tmp_path_factory.mktemp("cirr") / "cirr_dataset"),
                     n_images=16, n_train=13, extended=False)


@pytest.mark.parametrize("neg_num", [None, 5])
def test_train_epoch_matches_jax(neg_num, tok, jax_side, cirr_root, rng):
    """Both packages' epoch loops over their own copy of the dataset: the
    same shuffled batches, captions, stateless negative draws, per-step
    losses and mean loss; the frozen tensors do not move."""
    jb, params = jax_side
    tb = _port_backbone(tok, params)
    jds = JaxCIRDataset("cirr", "train", "relative",
                        JaxImageTransform("targetpad", 32), cirr_root)
    tds = CIRDataset("cirr", "train", "relative",
                     ImageTransform("targetpad", 32), cirr_root)
    n = tds.num_unique_images
    assert n == jds.num_unique_images
    refer = rng.randn(n, 32).astype(np.float32)
    target = _norm(rng.randn(n, 32)).astype(np.float32)
    jlog, tlog = [], []
    jstate, jmean = jstage2.train_epoch(
        jb, jstage2.create_train_state(jb, params, LR),
        JaxBank(refer=refer, target=jnp.asarray(target)),
        jax_iter_train_bank(jds, 4, epoch_seed=3), impl="xla",
        neg_num=neg_num, neg_seed=11, log_every=1,
        log_fn=lambda s, l: jlog.append((s, l)))
    start = {k: v.clone() for k, v in tb.model.state_dict().items()}
    state, tmean = stage2.train_epoch(
        tb, stage2.create_train_state(tb, LR),
        Bank(refer=refer, target=torch.from_numpy(target)),
        iter_train_bank(tds, 4, epoch_seed=3), neg_num=neg_num, neg_seed=11,
        log_every=1, log_fn=lambda s, l: tlog.append((s, l)))
    assert state.step == 3 and [s for s, _ in tlog] == [s for s, _ in jlog]
    np.testing.assert_allclose([l for _, l in tlog], [l for _, l in jlog],
                               **LOSS_TOL)
    np.testing.assert_allclose(tmean, jmean, **LOSS_TOL)
    want = clip_state_dict_from_train_state(jax.device_get(jstate), tb.cfg)
    for name, got in tb.model.state_dict().items():
        if _frozen(name):
            assert torch.equal(got, start[name]), name
        else:
            np.testing.assert_allclose(_comparable(name, got).numpy(),
                                       _comparable(name, want[name]).numpy(),
                                       err_msg=name, **PARAM_TOL)


def test_train_epoch_logs_only_every_log_every_steps(tok, jax_side, cirr_root,
                                                     rng):
    _, params = jax_side
    tb = _port_backbone(tok, params)
    tds = CIRDataset("cirr", "train", "relative",
                     ImageTransform("targetpad", 32), cirr_root)
    n = tds.num_unique_images
    bank = Bank(refer=rng.randn(n, 32).astype(np.float32),
                target=torch.from_numpy(_norm(rng.randn(n, 32)).astype(np.float32)))
    log = []
    _, mean = stage2.train_epoch(
        tb, stage2.create_train_state(tb, LR), bank,
        iter_train_bank(tds, 2, epoch_seed=0), log_every=4, start_step=2,
        log_fn=lambda s, l: log.append(s))
    assert log == [4] and np.isfinite(mean)     # steps 2..7: only step 4 logs


ARGV = ["--dataset", "cirr", "--clip-model-name", "test-tiny", "--device",
        "cpu", "--batch-size", "4", "--num-epochs", "2", "--learning-rate",
        "1e-3", "--seed", "0"]


def test_train_main_cpu_end_to_end(tok, cirr_root, tmp_path, capsys):
    """The training CLI on the CPU: bank extraction and cache, two epochs,
    a validation after each, the best checkpoint written and read back;
    the CPU route launches no kernel."""
    out = str(tmp_path / "run")
    counters = (attention_kernels.short_attention, attention_kernels.short_attention_bwd,
                bank_kernels.bank_infonce_fwd, bank_kernels.bank_infonce_bwd)
    before = [c.launches for c in counters]
    argv = ARGV + ["--data_path", cirr_root, "--output_path", out]
    best = train_main("clip", argv, tokenizer=tok, log_every=1)
    assert [c.launches for c in counters] == before
    text = capsys.readouterr().out
    n = CIRDataset("cirr", "train", "relative", ImageTransform("targetpad", 32),
                   cirr_root).num_unique_images
    assert f"bank: {n} images" in text and "epoch 1: mean loss" in text
    assert 0.0 < best <= 100.0
    assert os.path.exists(os.path.join(out, "cirr_bank.npz"))

    tb = ClipCIR("test-tiny", tokenizer=tok)
    fresh = ClipCIR("test-tiny", tokenizer=tok)
    fresh.init_params(torch.Generator().manual_seed(0))
    _, meta = load_model(os.path.join(out, "best.pt"), tb.model)
    assert meta["dataset"] == "cirr" and meta["score"] == best
    assert meta["epoch"] in (0, 1)
    for name, got in tb.model.state_dict().items():
        same = torch.equal(got, fresh.model.state_dict()[name])
        if _frozen(name):
            assert same, f"frozen {name} moved"
    assert not torch.equal(tb.model.text_projection,
                           fresh.model.text_projection)

    # a second run finds the bank cache and trains from it
    bank_file = os.path.join(out, "cirr_bank.npz")
    stamp = os.path.getmtime(bank_file)
    again = train_main("clip", argv + ["--neg_num", "5", "--bank_dtype",
                                       "bfloat16", "--lr_schedule", "cosine"],
                       tokenizer=tok, log_every=0)
    assert os.path.getmtime(bank_file) == stamp and 0.0 <= again <= 100.0
    assert "bfloat16" in capsys.readouterr().out


def test_train_main_int8_bank_and_unlabeled_pool_on_the_cpu(
        tok, cirr_root, tmp_path, capsys, monkeypatch):
    """`--bank_dtype int8 --unlabeled` on the CPU, a ResNet-tower model: the
    bank is extended with the unlabeled pool (cached beside the bank under
    the name derived from the resolved bank file), then quantized; `--neg_num`
    with `--unlabeled` truncates the pool and keeps the full-bank loss."""
    monkeypatch.setitem(tclip.CLIP_CONFIGS, "test-rn",
                        tclip.CLIPConfig(**RN_TINY))
    tf = ImageTransform("targetpad", 32)
    pool = CIRDataset("cirr", "train", "unlabeled", tf, cirr_root,
                      extend_suffix="clip").unlabeled_imagepaths
    u = len(pool)
    assert u >= 3
    out = str(tmp_path / "run")
    argv = [a if a != "test-tiny" else "test-rn" for a in ARGV] + [
        "--data_path", cirr_root, "--output_path", out, "--num-epochs", "1",
        "--bank_path", str(tmp_path / "banks" / "mybank"),
        "--bank_dtype", "int8", "--unlabeled"]
    n = CIRDataset("cirr", "train", "relative", tf,
                   cirr_root).num_unique_images
    best = train_main("clip", argv, tokenizer=tok, log_every=0)
    text = capsys.readouterr().out
    assert f"bank: {n + u} images" in text and "torch.int8" in text
    assert 0.0 <= best <= 100.0
    assert os.path.exists(tmp_path / "banks" / "mybank.npz")
    cached = np.load(tmp_path / "banks" / "mybank_unlabeled.npz")["unlabeled"]
    assert cached.shape == (u, 32)
    np.testing.assert_allclose(np.linalg.norm(cached, axis=-1), 1.0, atol=1e-5)
    train_main("clip", argv + ["--neg_num", "2"], tokenizer=tok, log_every=0)
    assert f"bank: {n + 2} images" in capsys.readouterr().out


def test_int8_bank_with_sampled_negatives_exits_as_the_jax_cli_does(
        tok, cirr_root, tmp_path):
    argv = ARGV + ["--data_path", cirr_root, "--output_path",
                   str(tmp_path / "run"), "--bank_dtype", "int8",
                   "--neg_num", "5"]
    with pytest.raises(SystemExit, match="needs the full-bank loss"):
        train_main("clip", argv, tokenizer=tok)


@pytest.mark.parametrize("flags,match", [
    (["tgcir", "--wo_bank", "--neg_type", "1"], "--neg_type"),
    (["--neg_type", "1"], "--neg_type"),
    (["tgcir", "--unlabeled"], "--unlabeled"),
    (["--use_cc"], "--use_cc"),
    (["--loss_impl", "xla"], "--loss_impl"),
    (["blip2", "--text_max_len", "40"], "--text_max_len"),
    (["--wo_bank", "--use_cc"], "--use_cc"),
    (["--dropout", "0.1"], "--dropout"),
    (["--text_max_len", "40"], "--text_max_len"),
    (["--val_ret_train"], "--val_ret_train"),
    (["zs", "--dropout", "0.1"], "--dropout"),
])
def test_unported_flags_raise_not_yet_ported(flags, match, tok, cirr_root,
                                             tmp_path):
    """A first word picks another backbone (clip when absent): the negtype
    ablation is clip's and zs's alone; `--neg_type` without `--wo_bank`
    and `--use_cc` without `--plus` would have no effect on clip, and are
    refused as the JAX CLI's other inert flags are."""
    name, flags = backbone_from_argv(flags)
    argv = ARGV + ["--data_path", cirr_root, "--output_path",
                   str(tmp_path / "run")] + flags
    with pytest.raises(NotImplementedError) as err:
        train_main(name, argv, tokenizer=tok)
    assert match in str(err.value) and "not yet ported" in str(err.value)


@pytest.mark.parametrize("flags", [
    ["--mesh_data", "2"], ["--mesh_bank", "2"], ["--mesh_model", "2"],
    ["--distributed"], ["--device_preprocess", "--mesh_data", "2"],
    ["--device_preprocess", "--distributed"],
    ["--device_preprocess", "--device_canvas", "448", "--mesh_model", "2"],
])
def test_meshes_need_a_multi_process_launch(flags, tok, cirr_root, tmp_path,
                                            monkeypatch):
    """A mesh runs one process per GPU (`parallel/`): a process started
    alone, without torchrun's or the SPN4CIR_DIST_* variables, is refused
    before it builds anything."""
    for var in ("SPN4CIR_DIST_NPROCS", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    argv = ARGV + ["--data_path", cirr_root, "--output_path",
                   str(tmp_path / "run")] + flags
    with pytest.raises(SystemExit, match="multi-process launch"):
        train_main("clip", argv, tokenizer=tok)


def test_train_main_defaults_to_cuda(tok, cirr_root, tmp_path):
    """Without --device the trainer asks for cuda:0 and fails where there
    is none: the CPU is used only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a GPU")
    argv = [a for a in ARGV if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main("clip", argv + ["--data_path", cirr_root, "--output_path",
                                   str(tmp_path / "run")], tokenizer=tok)


def test_checkpoint_round_trip_and_logging(tok, tmp_path):
    a = ClipCIR("test-tiny", tokenizer=tok)
    a.init_params(torch.Generator().manual_seed(3))
    path = str(tmp_path / "sub" / "best.pt")
    save_model(path, a.model, epoch=4, extra={"score": 12.5})
    b = ClipCIR("test-tiny", tokenizer=tok)
    b.init_params(torch.Generator().manual_seed(4))
    _, meta = load_model(path, b.model)
    assert meta == {"epoch": 4, "score": 12.5}
    for (name, x), y in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(x, y), name
    # the file holds the reference's parameter names: it loads as a CLIP
    # checkpoint through the CLI's --model_path too
    assert "visual.conv1.weight" in torch.load(path)["state_dict"]

    stream = io.StringIO()
    logger = MetricLogger(stream=stream, prefix="t")
    logger.log(3, loss=1.5)
    row = json.loads(stream.getvalue())
    assert (row["step"], row["loss"], row["tag"]) == (3, 1.5, "t")
    timer = StepTimer(warmup=1)
    for _ in range(3):
        timer.start()
        timer.stop(items=8)
    assert len(timer.times) == 2 and timer.items_per_s > 0
    assert timer.mean_step_s >= 0
