"""The port's tgcir backbone against the JAX package, on the CPU in float32.

`test-tgcir` (ViT-B/16's widths at two layers and 32 px: vision width 768,
text width 512 with 8 heads, embedding 512) with the same weights on both
sides (`tgcir_state_dict_from_jax`) and the same numpy inputs from a seed:
the tower tokens, the image and caption token sets, the fusion, the bank
pooling, the striped masks, the freeze filter, the stage-2 surgery, the
step-0 loss and gradients and the parameters after 1 and 3 AdamW steps,
the weight round trip and the reference-checkpoint loader.

Tolerances (float32; the sides differ in summation order and in
LayerNorm's variance formula): tokens, token sets and fused queries atol
1e-4 (as tests/test_torch_clip.py); losses atol 5e-5, rtol 1e-5; gradients
atol 2e-5, rtol 2e-3; parameters after training atol 3e-5, rtol 1e-3 at
LR 1e-3 (as tests/test_torch_stage2.py); the weight conversions are exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.models.convert import convert_tgcir_state_dict
from spn4cir_tpu.models.tgcir import TgcirCIR as JaxTgcirCIR
from spn4cir_tpu.train import stage2 as jstage2
from spn4cir_tpu_torch.models.api import build_backbone
from spn4cir_tpu_torch.models.convert import (load_tgcir_checkpoint,
                                              tgcir_state_dict_from_jax)
from spn4cir_tpu_torch.models.tgcir import GlobalMasks, TgcirCIR
from spn4cir_tpu_torch.ops import attention_kernels, bank_kernels
from spn4cir_tpu_torch.train import stage2

torch.set_num_threads(1)

ATOL = 1e-4
LR = 1e-3
B, M = 4, 24
LOSS_TOL = dict(atol=5e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-3)
PARAM_TOL = dict(atol=3e-5, rtol=1e-3)


@pytest.fixture(scope="module")
def sides():
    """(jax backbone, its params as numpy, port backbone) on one set of
    weights."""
    jb = JaxTgcirCIR("test-tgcir", tau=0.02)
    params = jax.device_get(jax.jit(jb.init_params)(jax.random.PRNGKey(0)))
    tb = TgcirCIR("test-tgcir", tau=0.02)
    tb.model.load_state_dict(tgcir_state_dict_from_jax(params, tb.cfg))
    return jb, params, tb


def _text_ids(rng, b, vocab=49408):
    ids = np.zeros((b, 77), np.int32)
    for row in range(b):
        n = rng.randint(1, 40)
        ids[row, 0] = vocab - 2                         # SOT
        ids[row, 1:n + 1] = rng.randint(1, vocab - 2, n)
        ids[row, n + 1] = vocab - 1                     # EOT: the argmax
    return ids


def _images(rng, b, res=32):
    return rng.standard_normal((b, res, res, 3)).astype(np.float32)


def _apply(jb, params, method, *args):
    return np.asarray(jax.jit(functools.partial(jb.model.apply,
                                                method=method))(
        params, *[jnp.asarray(a) for a in args]))


def test_tower_tokens_match_jax(sides, rng):
    """Vision tokens (B, 1+P, 768) before ln_post, text tokens (B, 77, 512)
    after ln_final, beside the pooled projections."""
    jb, params, tb = sides
    images, ids = _images(rng, 2), _text_ids(rng, 3)

    def vision(m, x):
        return m.clip.encode_image(x, return_tokens=True)

    def text(m, x):
        return m.clip.encode_text(x, return_tokens=True)

    with torch.inference_mode():
        got_v = tb.model.clip.encode_image(torch.from_numpy(images),
                                           return_tokens=True)
        got_t = tb.model.clip.encode_text(torch.from_numpy(ids),
                                          return_tokens=True)
        assert torch.equal(got_v[0], tb.model.clip.encode_image(
            torch.from_numpy(images)))
    for got, fn, x, shapes in ((got_v, vision, images, ((2, 512),
                                                          (2, 5, 768))),
                               (got_t, text, ids, ((3, 512), (3, 77, 512)))):
        want = jax.jit(functools.partial(jb.model.apply, method=fn))(
            params, jnp.asarray(x))
        for g, w, shape in zip(got, want, shapes):
            assert g.shape == shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=0)


def test_token_sets_and_fusion_match_jax(sides, rng):
    jb, params, tb = sides
    images, ids = _images(rng, 3), _text_ids(rng, 3)
    want_img = _apply(jb, params, "extract_img_fea", images)
    want_txt = _apply(jb, params, "extract_text_fea", ids)
    want_q = np.asarray(jax.jit(jb.fuse)(params, jnp.asarray(want_img),
                                         jnp.asarray(ids)))
    with torch.inference_mode():
        got_img = tb.encode_image(torch.from_numpy(images))
        got_txt = tb.encode_text(torch.from_numpy(ids))
        got_q = tb.fuse(got_img, torch.from_numpy(ids))
    assert got_img.shape == got_txt.shape == (3, 12, 512)
    assert got_q.shape == (3, 512) and got_q.dtype == torch.float32
    for got, want in ((got_img, want_img), (got_txt, want_txt),
                      (got_q, want_q)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_q.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_bank_and_index_features_pool_the_token_set(sides, rng):
    jb, params, tb = sides
    images = _images(rng, 3)
    want_refer, want_target = jax.jit(jb.bank_features)(params,
                                                        jnp.asarray(images))
    with torch.inference_mode():
        refer, target = tb.bank_features(torch.from_numpy(images))
        index = tb.index_features(torch.from_numpy(images))
        gallery = tb.gallery_features(torch.from_numpy(images))
    pooled = refer.mean(dim=1)
    np.testing.assert_allclose(
        target.numpy(), (pooled / pooled.norm(dim=-1, keepdim=True)).numpy(),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(refer.numpy(), np.asarray(want_refer),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(target.numpy(), np.asarray(want_target),
                               atol=ATOL, rtol=0)
    assert torch.equal(index["refer"], refer)
    assert torch.equal(index["target"], target)
    assert torch.equal(gallery, refer)         # the raw token sets
    assert tb.bank_spec().refer_shape == (12, 512)
    assert tb.bank_spec().target_shape == (512,)


def test_striped_mask_init_matches_jax(sides):
    jb, params, tb = sides
    fresh = TgcirCIR("test-tgcir")
    fresh.init_params(torch.Generator().manual_seed(0))
    want = np.asarray(params["params"]["masks"]["masks"])
    assert want.shape == (4, 512)
    np.testing.assert_array_equal(GlobalMasks.striped(4, 512), want)
    for masks in (fresh.model.masks, fresh.model.masks_text):
        np.testing.assert_array_equal(masks.weight.detach().numpy(), want)
    seg = 512 // 4
    assert (want[1, seg:2 * seg] == 1.0).all() and want[1, 0] == 0.1


def test_trainable_filter_matches_jax_on_every_parameter(sides):
    """By the top-level name: `masks_text` and `tokenlearn_text` train,
    though a prefix test on `masks` / `tokenlearn` would freeze them."""
    jb, params, tb = sides
    names = [n for n, _ in tb.named_parameters()]
    want = {}
    for path, _ in jax.tree_util.tree_leaves_with_path(params):
        keys = tuple(k.key for k in path)
        want[keys] = jb.trainable_filter(keys)
    roots = {}
    for name in names:
        root = name.split(".")[1]
        roots.setdefault(root, set()).add(tb.trainable_filter(name))
    # the JAX verdict of each top-level module, and CLIP's towers
    jroots = {}
    for keys, verdict in want.items():
        root = keys[1] if keys[1] != "clip" else f"clip.{keys[2]}"
        jroots.setdefault(root, set()).add(verdict)
    assert jroots == {"clip.visual": {False}, "clip.text": {True},
                      "clip.logit_scale": {True}, "fc": {False},
                      "text_fc": {True}, "tokenlearn": {False},
                      "tokenlearn_text": {True}, "masks": {False},
                      "masks_text": {True}, "s_remain": {True}}
    assert roots["fc"] == roots["tokenlearn"] == roots["masks"] == {False}
    assert (roots["text_fc"] == roots["tokenlearn_text"]
            == roots["masks_text"] == roots["s_remain"] == {True})
    for name in names:
        if name.startswith("model.clip."):
            assert tb.trainable_filter(name) == (
                not name.startswith("model.clip.visual.")), name
    # logit_scale passes the filter and is held out by the mask, as in the
    # JAX package's trainable_mask
    mask = stage2.trainable_mask(tb)
    assert not mask["model.clip.logit_scale"]
    assert mask["model.masks_text.weight"] and mask["model.tokenlearn_text.attn.weight"]
    assert not mask["model.masks.weight"] and not mask["model.fc.weight"]


def test_init_stage2_copies_the_image_branch_into_the_text_branch(sides):
    jb, params, tb = sides
    model = TgcirCIR("test-tgcir").model
    model.load_state_dict(tb.model.state_dict())
    with torch.no_grad():
        model.masks.weight.mul_(0.5)
        model.tokenlearn.attn.bias.add_(1.0)
    ids_before = [id(p) for p in model.parameters()]
    TgcirCIR.init_stage2(model)
    assert [id(p) for p in model.parameters()] == ids_before
    assert torch.equal(model.masks_text.weight, model.masks.weight)
    for a, b in zip(model.tokenlearn.parameters(),
                    model.tokenlearn_text.parameters()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    jparams = jax.tree_util.tree_map(np.asarray, params)
    jparams["params"]["masks"]["masks"] = (
        model.masks.weight.detach().numpy().copy())
    jparams["params"]["tokenlearn"]["attn"]["bias"] = (
        model.tokenlearn.attn.bias.detach().numpy().copy())
    want = tgcir_state_dict_from_jax(JaxTgcirCIR.init_stage2(jparams),
                                     tb.cfg)
    for name, t in model.state_dict().items():
        assert torch.equal(t, want[name]), name


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _batches(rng, n, neg_num=None):
    bank = _norm(rng.randn(M, 512)).astype(np.float32)
    out = []
    for _ in range(n):
        batch = {"refer_feats": rng.randn(B, 12, 512).astype(np.float32),
                 "text_ids": _text_ids(rng, B),
                 "labels": rng.randint(0, M, B).astype(np.int64)}
        if neg_num:
            batch["neg_idx"] = stage2.sample_negatives(rng, batch["labels"], M,
                                                       neg_num)
        out.append(batch)
    return bank, out


def _port(tb_ref, params):
    tb = TgcirCIR("test-tgcir", tau=0.02)
    tb.model.load_state_dict(tgcir_state_dict_from_jax(params, tb.cfg))
    return tb


def _frozen(name: str) -> bool:
    name = name.removeprefix("model.")
    return (name.startswith(("clip.visual.", "fc.", "tokenlearn.", "masks."))
            or name == "clip.logit_scale")


def _comparable(name: str, t: torch.Tensor) -> torch.Tensor:
    """The key third of `in_proj_bias` has an exactly-zero gradient, so
    either side's value there is rounding noise that Adam scales to a full
    step: it is left out (as in tests/test_torch_stage2.py)."""
    if name.endswith("attn.in_proj_bias"):
        third = t.shape[0] // 3
        return torch.cat([t[:third], t[2 * third:]])
    return t


@pytest.mark.parametrize("neg_num", [None, 5])
def test_step0_loss_and_gradients_match_jax(neg_num, sides, rng):
    jb, params, tb0 = sides
    tb = _port(tb0, params)
    bank, (batch,) = _batches(rng, 1, neg_num)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        return jb.stage2_loss(p, jbatch["refer_feats"], jbatch["text_ids"],
                              jnp.asarray(bank), jbatch["labels"],
                              neg_idx=jbatch.get("neg_idx"), impl="xla")

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    stage2.create_train_state(tb, LR)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = bank_kernels.bank_infonce_fwd.launches
    loss = tb.stage2_loss(tbatch["refer_feats"], tbatch["text_ids"],
                          torch.from_numpy(bank), tbatch["labels"],
                          neg_idx=tbatch.get("neg_idx"))
    loss.backward()
    assert bank_kernels.bank_infonce_fwd.launches == before   # CPU route
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    want = tgcir_state_dict_from_jax(jax.device_get(want_grads), tb.cfg)
    checked = 0
    for name, p in tb.model.named_parameters():
        if _frozen(name):
            assert p.grad is None, name
            continue
        np.testing.assert_allclose(
            _comparable(name, p.grad).numpy(),
            _comparable(name, want[name]).numpy(), err_msg=name, **GRAD_TOL)
        assert p.grad.abs().max() > 0, name
        checked += 1
    # 12 per text block x 2, the embeddings, ln_final, the projection;
    # text_fc, tokenlearn_text and s_remain's two layers (2 each), masks_text
    assert checked == 29 + 9


@pytest.mark.parametrize("neg_num", [None, 5])
def test_parameters_after_1_and_3_steps_match_jax(neg_num, sides, rng):
    """An Adam step is lr * m / (sqrt(v) + 1e-7): where a gradient is
    within rounding noise of that eps, the step's size is noise. Elements
    whose gradient fell under 3e-6, but not to zero, at some step (a
    handful per tensor, as in tests/test_torch_blip_train.py) are held to
    the steps' bound, the rest to PARAM_TOL."""
    jb, params, tb0 = sides
    tb = _port(tb0, params)
    start = {k: v.clone() for k, v in tb.model.state_dict().items()}
    bank, batches = _batches(rng, 3, neg_num)
    jstate = jstage2.create_train_state(jb, params, LR)
    state = stage2.create_train_state(tb, LR)
    tbank, jbank = torch.from_numpy(bank), jnp.asarray(bank)
    moved, held, seen = 0.0, 0, 0
    least, most = {}, {}
    for step, batch in enumerate(batches, start=1):
        jstate, want_loss = jstage2.stage2_train_step(
            jb, jstate, jbank, {k: jnp.asarray(v) for k, v in batch.items()},
            "xla")
        loss = stage2.stage2_train_step(
            tb, state, tbank, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
        np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
        for name, p in tb.model.named_parameters():
            if p.grad is not None:
                g = p.grad.abs()
                least[name] = torch.minimum(least.get(name, g), g)
                most[name] = torch.maximum(most.get(name, g), g)
        if step not in (1, 3):
            continue
        want = tgcir_state_dict_from_jax(jax.device_get(jstate.params),
                                         tb.cfg)
        for name, got in tb.model.state_dict().items():
            if _frozen(name):
                assert torch.equal(got, start[name]), name
                assert torch.equal(want[name], start[name]), name
                continue
            got_c, want_c = _comparable(name, got), _comparable(name,
                                                                want[name])
            # (unused embedding rows: exactly zero at every step)
            sure = ((_comparable(name, least[name]) > 3e-6)
                    | (_comparable(name, most[name]) == 0))
            held += int(sure.sum())
            seen += sure.numel()
            np.testing.assert_allclose(got_c[sure].numpy(),
                                       want_c[sure].numpy(),
                                       err_msg=f"{name} after {step}",
                                       **PARAM_TOL)
            assert (got_c - want_c).abs().max() <= 2.1 * LR * step, name
            moved = max(moved, (got_c - _comparable(name, start[name]))
                        .abs().max().item())
    assert moved > 50 * PARAM_TOL["atol"], moved
    assert held > 0.99 * seen, (held, seen)


def test_state_dict_round_trip_is_exact(sides):
    """Port -> the JAX reader of the reference's names -> the JAX tree
    equals the tree the port's weights came from."""
    jb, params, tb = sides
    ref = _reference_state_dict(tb.model.state_dict())
    back = convert_tgcir_state_dict(ref, tb.cfg.vision_layers,
                                    tb.cfg.transformer_layers)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_got)
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]),
                                      np.asarray(want), err_msg=str(path))


def _reference_state_dict(sd):
    """The port's state dict under the reference CIRPlus names: the token
    learner's S slots as separate Conv1d(D -> 1) weights, the gate as
    `s_remain_map.{0,2}`, plus the aliased image backbone and the unused
    maps the loader drops."""
    out = {}
    for name, t in sd.items():
        t = t.clone()
        if name.startswith(("tokenlearn.attn", "tokenlearn_text.attn")):
            branch, leaf = name.split(".")[0], name.split(".")[-1]
            for i in range(t.shape[0]):
                conv = f"backbone.{branch}.tokenizers.{i}.conv.0"
                out[f"{conv}.{leaf}"] = (t[i].reshape(1, -1, 1)
                                         if leaf == "weight"
                                         else t[i].reshape(1))
        elif name.startswith("s_remain."):
            idx = {"fc1": 0, "fc2": 2}[name.split(".")[1]]
            out[f"s_remain_map.{idx}.{name.split('.')[-1]}"] = t
        else:
            out[f"backbone.{name}"] = t
            if name.startswith("clip.visual."):
                out["backbone.image_backbone." + name[len("clip.visual."):]] = t
    out["t_remain_map.0.weight"] = torch.zeros(3, 3)
    out["t_replace_map.0.weight"] = torch.zeros(3, 3)
    out["local_weight"] = torch.zeros(8)
    return out


def test_load_tgcir_checkpoint_reads_the_reference_names(sides, rng,
                                                         tmp_path):
    """A synthesized CIRPlus state dict under the reference's names (random
    values), behind a `state_dict.` prefix: the port's loader and the JAX
    package's `convert_tgcir_state_dict` read the same weights."""
    jb, params, tb = sides
    sd = {k: torch.from_numpy(np.asarray(
              rng.standard_normal(tuple(v.shape)) * 0.02, np.float32))
          for k, v in tb.model.state_dict().items()}
    ref = _reference_state_dict(sd)
    path = tmp_path / "cirplus.pt"
    torch.save({f"state_dict.{k}": v for k, v in ref.items()}, path)
    got = load_tgcir_checkpoint(str(path))
    assert set(got) == set(sd)
    want = tgcir_state_dict_from_jax(
        convert_tgcir_state_dict(ref, tb.cfg.vision_layers,
                                 tb.cfg.transformer_layers), tb.cfg)
    for name in sd:
        assert torch.equal(got[name], sd[name]), name
        assert torch.equal(got[name], want[name]), name
    fresh = TgcirCIR("test-tgcir")
    fresh.model.load_state_dict(got)            # strict: every name


def test_build_backbone_registers_tgcir():
    tb = build_backbone("tgcir", clip_model_name="test-tgcir")
    assert isinstance(tb, TgcirCIR)
    assert (tb.name, tb.extend_suffix, tb.fiq_exclude_reference,
            tb.default_transform, tb.tau) == ("tgcir", "tgcir", False,
                                              "targetpad", 0.02)
    assert tb.cfg.image_resolution == 32 and tb.num_tokens == 12
    with pytest.raises(NotImplementedError, match="stage-1"):
        tb.stage1_loss(None, None, None)
    # the default is ViT-B/16, whose image tower runs the long attention
    assert TgcirCIR.__init__.__defaults__[0] == "ViT-B/16"
    assert attention_kernels.attention_route(197, 64, False, False,
                                             "auto") == "long"
