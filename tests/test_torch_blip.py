"""The port's blip4cir modules against the JAX package, on the CPU.

Small sizes (`BlipViTConfig.tiny`: 32-pixel images, 5 tokens, width 32, 2
layers; `MedConfig.tiny`: hidden 32, 2 layers, 2 heads; `tiny_test_vocab`),
the same weights on both sides (`blip_state_dict_from_jax`), the same numpy
inputs from a seed.

Tolerances: float32 outputs 1e-5 absolute (the sides differ in summation
order and in LayerNorm's variance formula; the outputs are O(1)); bfloat16
by cosine > 0.999 per row (eight-bit mantissas through two layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from spn4cir_tpu.models import blip_vit as jvit
from spn4cir_tpu.models import convert as jconvert
from spn4cir_tpu.models import med as jmed
from spn4cir_tpu.models.api import build_backbone as jax_build_backbone
from spn4cir_tpu.tokenizer import wordpiece as jwordpiece
from spn4cir_tpu.train import stage2 as jstage2
from spn4cir_tpu_torch.models import blip_vit as tvit
from spn4cir_tpu_torch.models import convert
from spn4cir_tpu_torch.models import med as tmed
from spn4cir_tpu_torch.models.api import build_backbone
from spn4cir_tpu_torch.tokenizer import wordpiece
from spn4cir_tpu_torch.train import stage2
from tests.torch_fixtures import (BERT_VOCAB_SIZE, CORPUS,
                                  synthetic_bert_vocab, write_bert_vocab)

torch.set_num_threads(1)

ATOL = 1e-5
CAPTIONS = ["make it more blue", "a red dress with short sleeve",
            "less print, long shirt!", "the"]


def _cos(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def sides():
    jb = jax_build_backbone("blip", blip_size="test-tiny")
    params = jax.device_get(jax.jit(jb.init_params)(jax.random.PRNGKey(0)))
    tb = build_backbone("blip", blip_size="test-tiny")
    tb.model.load_state_dict(
        convert.blip_state_dict_from_jax(params, tb.vit_cfg, tb.med_cfg))
    tb.eval()
    return jb, params, tb


def _bf16_port(tb):
    b = build_backbone("blip", blip_size="test-tiny", dtype=torch.bfloat16)
    b.model.load_state_dict(tb.model.state_dict())
    return b.eval()


# ---- the ViT ----

def test_blip_vit_matches_jax(rng):
    cfg = jvit.BlipViTConfig.tiny()
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    jmod = jvit.BlipViT(cfg)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(2),
                                      jnp.asarray(images)))
    # flax draws zero biases: give every leaf noise so that each is compared
    leaves, tree = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(tree, [
        l + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
        for l in leaves])
    want = np.asarray(jmod.apply(params, jnp.asarray(images)))
    tmod = tvit.BlipViT(tvit.BlipViTConfig.tiny())
    tmod.load_state_dict(convert.blip_vit_state_dict(params["params"], ""))
    with torch.inference_mode():
        got = tmod(torch.from_numpy(images))
    assert got.shape == (3, cfg.num_tokens, cfg.width) == (3, 5, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    names = set(tmod.state_dict())
    assert {"patch_embed.proj.weight", "patch_embed.proj.bias", "cls_token",
            "pos_embed", "blocks.0.norm1.weight", "blocks.1.attn.qkv.bias",
            "blocks.0.attn.proj.weight", "blocks.1.mlp.fc1.weight",
            "blocks.0.mlp.fc2.bias", "norm.bias"} <= names
    assert tmod.cls_token.shape == (1, 1, 32)
    assert tmod.pos_embed.shape == (1, 5, 32)


def test_patch_embedding_is_the_strided_convolution(rng):
    """The matmul over flattened patches against `F.conv2d` with the same
    OIHW weight and bias."""
    embed = tvit.PatchEmbed(24, 16)
    images = torch.from_numpy(
        rng.standard_normal((2, 48, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        want = F.conv2d(images.permute(0, 3, 1, 2), embed.proj.weight,
                        embed.proj.bias, stride=16)
        got = embed(images)
    np.testing.assert_allclose(
        got.numpy(), want.flatten(2).transpose(1, 2).numpy(), atol=1e-5)


@pytest.mark.parametrize("name,shape", [
    ("base", (577, 768, 12, 12)), ("large", (577, 1024, 24, 16)),
    ("tiny", (5, 32, 2, 2))])
def test_blip_vit_configs_equal_jax(name, shape):
    t = getattr(tvit.BlipViTConfig, name)()
    j = getattr(jvit.BlipViTConfig, name)()
    assert (t.num_tokens, t.width, t.layers, t.heads) == shape
    assert (j.num_tokens, j.width, j.layers, j.heads) == shape
    assert (t.image_size, t.patch_size) == (j.image_size, j.patch_size)


# ---- MED ----

def _med_pair(rng, type_vocab_size=0):
    cfg_kw = dict(type_vocab_size=type_vocab_size)
    jcfg = jmed.MedConfig.tiny(64, **cfg_kw)
    ids = rng.randint(0, 64, (3, 9)).astype(np.int32)
    mask = np.ones((3, 9), np.int32)
    mask[0, 5:] = 0
    mask[2, 7:] = 0
    enc = rng.standard_normal((3, 6, 32)).astype(np.float32)
    enc_mask = np.ones((3, 6), np.int32)
    enc_mask[1, 4:] = 0
    jmod = jmed.MedBert(jcfg)
    params = jax.device_get(jmod.init(
        jax.random.PRNGKey(3), jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(enc), jnp.asarray(enc_mask)))
    leaves, tree = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(tree, [
        l + 0.05 * rng.standard_normal(l.shape).astype(np.float32)
        for l in leaves])
    tmod = tmed.MedBert(tmed.MedConfig.tiny(64, **cfg_kw)).eval()
    tmod.load_state_dict(convert.med_state_dict(params["params"], ""))
    return jmod, params, tmod, (ids, mask, enc, enc_mask)


@pytest.mark.parametrize("cross,masked,causal", [
    (False, False, False), (False, True, False), (True, True, False),
    (True, False, False), (False, True, True)])
def test_med_bert_matches_jax(cross, masked, causal, rng):
    jmod, params, tmod, (ids, mask, enc, enc_mask) = _med_pair(rng)
    jargs = dict(attention_mask=jnp.asarray(mask) if masked else None,
                 encoder_hidden_states=jnp.asarray(enc) if cross else None,
                 encoder_attention_mask=(jnp.asarray(enc_mask)
                                         if cross and masked else None),
                 causal=causal)
    want = np.asarray(jmod.apply(params, jnp.asarray(ids), **jargs))
    targs = {k: (None if v is None else v if isinstance(v, bool)
                 else torch.from_numpy(np.array(v)))
             for k, v in jargs.items()}
    with torch.inference_mode():
        got = tmod(torch.from_numpy(ids), **targs)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_med_bert_token_type_table_matches_jax(rng):
    jmod, params, tmod, (ids, mask, _, _) = _med_pair(rng, type_vocab_size=2)
    want = np.asarray(jmod.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.inference_mode():
        got = tmod(torch.from_numpy(ids), torch.from_numpy(mask))
    assert "embeddings.token_type_embeddings.weight" in tmod.state_dict()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_med_names_are_the_checkpoints():
    names = set(tmed.MedBert(tmed.MedConfig.tiny(16)).state_dict())
    layer = "encoder.layer.1."
    want = {"embeddings.word_embeddings.weight",
            "embeddings.position_embeddings.weight",
            "embeddings.LayerNorm.weight"}
    for att in ("attention", "crossattention"):
        for leaf in ("self.query.weight", "self.key.bias", "self.value.weight",
                     "output.dense.weight", "output.LayerNorm.bias"):
            want.add(f"{layer}{att}.{leaf}")
    want |= {layer + "intermediate.dense.weight", layer + "output.dense.bias",
             layer + "output.LayerNorm.weight"}
    assert want <= names
    assert not any("token_type" in n for n in names)
    base = tmed.MedConfig()
    assert (base.vocab_size, base.hidden_size, base.num_layers,
            base.num_heads, base.intermediate_size, base.encoder_width) == (
        30524, 768, 12, 12, 3072, 768)
    assert base == tmed.MedConfig(**{
        f: getattr(jmed.MedConfig(), f)
        for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "intermediate_size", "max_position_embeddings",
                  "encoder_width", "type_vocab_size", "dropout_rate")})


def test_masks_match_jax(rng):
    mask = (rng.rand(3, 7) > 0.4).astype(np.int32)
    np.testing.assert_array_equal(
        tmed.additive_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(jmed.additive_mask(jnp.asarray(mask))))
    np.testing.assert_array_equal(
        tmed.causal_additive_mask(6).numpy(),
        np.asarray(jmed.causal_additive_mask(6)))


# ---- the backbone ----

def test_index_features_fuse_and_encode_text_match_jax(sides, rng):
    jb, params, tb = sides
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    jids, tids = jb.tokenize(CAPTIONS), tb.tokenize(CAPTIONS)
    np.testing.assert_array_equal(jids, tids)
    assert tids.shape == (4, 2, 35) and tids.dtype == np.int32
    assert (tids[:, 0, 0] == tb.tokenizer.enc_token_id).all()
    want = jb.index_features(params, jnp.asarray(images))
    with torch.inference_mode():
        got = tb.index_features(torch.from_numpy(images))
        fused = tb.fuse(got["refer"], torch.from_numpy(tids))
        text = tb.encode_text(torch.from_numpy(tids))
        pooled = tb.gallery_features(torch.from_numpy(images))
        refer, target = tb.bank_features(torch.from_numpy(images))
    assert got["refer"].shape == (4, 5, 32) and got["target"].shape == (4, 256)
    for key in ("target", "refer"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)
    assert torch.equal(pooled, got["target"]) and torch.equal(
        target, got["target"]) and torch.equal(refer, got["refer"])
    np.testing.assert_allclose(
        fused.numpy(),
        np.asarray(jb.fuse(params, want["refer"], jnp.asarray(jids))),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        text.numpy(), np.asarray(jb.encode_text(params, jnp.asarray(jids))),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(fused.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_bfloat16_backbone_matches_jax_by_cosine(sides, rng):
    jb, params, tb = sides
    jb16 = jax_build_backbone("blip", blip_size="test-tiny",
                              dtype=jnp.bfloat16)
    tb16 = _bf16_port(tb)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    tids = tb.tokenize(CAPTIONS)
    want = jb16.index_features(params, jnp.asarray(images))
    want_q = jb16.fuse(params, want["refer"], jnp.asarray(tids))
    with torch.inference_mode():
        got = tb16.index_features(torch.from_numpy(images))
        got_q = tb16.fuse(got["refer"], torch.from_numpy(tids))
    assert got["refer"].dtype == torch.bfloat16
    assert got["target"].dtype == got_q.dtype == torch.float32
    for a, b in ((got["refer"].float(), want["refer"].astype(jnp.float32)),
                 (got["target"], want["target"]), (got_q, want_q)):
        assert _cos(a.numpy(), np.asarray(b)).min() > 0.999


def test_backbone_surface(sides):
    jb, params, tb = sides
    spec = tb.bank_spec()
    assert (spec.refer_shape, spec.target_shape) == ((5, 32), (256,))
    assert tuple(jb.bank_spec().refer_shape) == spec.refer_shape
    assert (tb.name, tb.extend_suffix, tb.fiq_exclude_reference,
            tb.replace_extended, tb.input_dim, tb.embed_dim) == (
        "blip", "blip", False, False, 32, 256)
    assert (jb.name, jb.extend_suffix, jb.fiq_exclude_reference) == (
        "blip", "blip", False)
    import inspect

    assert "generator" in inspect.signature(tb.stage2_loss).parameters
    assert "generator" in inspect.signature(tb.stage1_loss).parameters
    assert isinstance(tb.model.tau, torch.nn.Parameter)
    assert tb.model.tau.shape == () and abs(tb.model.tau.item() - 0.03) < 1e-7
    with pytest.raises(NotImplementedError, match="not ported"):
        build_backbone("tgcir")


def test_stage2_freeze_mask_equals_jax(sides):
    """The ViT and vision_proj are frozen, MED, text_proj and tau train:
    leaf for leaf the JAX mask, carried through the converter."""
    jb, params, tb = sides
    mask = stage2.trainable_mask(tb)
    for name, trains in mask.items():
        frozen = name.startswith(("model.visual_encoder.",
                                  "model.vision_proj."))
        assert trains == (not frozen), name
    assert mask["model.tau"] and mask["model.text_proj.weight"]
    jmask = jstage2.trainable_mask(params, jb.trainable_filter)
    marked = jax.tree_util.tree_map(
        lambda p, m: np.full(np.shape(p), 0.0 if m else np.nan, np.float32),
        params, jmask)
    for name, t in convert.blip_state_dict_from_jax(marked).items():
        assert bool(torch.isnan(t).all()) == (not mask["model." + name]), name
    state = stage2.create_train_state(tb, 1e-3)
    assert len(state.optimizer.param_groups) == 1       # tau decays with the rest
    in_opt = {id(p) for p in state.optimizer.param_groups[0]["params"]}
    assert id(tb.model.tau) in in_opt
    for name, p in tb.named_parameters():
        assert p.requires_grad == mask[name] == (id(p) in in_opt), name


# ---- conversion ----

def test_convert_blip_retrieval_gives_back_the_jax_tree(sides):
    """The JAX package's own converter, applied to the port's state dict
    (which has the checkpoint's names), returns the tree the weights came
    from, bit for bit; with the CIRPlus `blip.` prefix too."""
    jb, params, tb = sides
    sd = {k: v.numpy() for k, v in tb.model.state_dict().items()}
    for wrapped in (sd, {f"blip.{k}": v for k, v in sd.items()}):
        back = jconvert.convert_blip_retrieval(wrapped, 2, 2)
        want = jax.tree_util.tree_leaves_with_path(params)
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]),
                                          np.asarray(leaf),
                                          err_msg=jax.tree_util.keystr(path))


def test_blip_state_dict_checks_depth_and_owns_its_memory(sides):
    jb, params, tb = sides
    with pytest.raises(ValueError, match="depth"):
        convert.blip_state_dict_from_jax(params, tvit.BlipViTConfig.base())
    sd = convert.blip_state_dict_from_jax(params)
    src = params["params"]["text_proj"]["bias"]
    sd["text_proj.bias"].add_(1.0)
    assert not np.shares_memory(sd["text_proj.bias"].numpy(), src)
    assert set(sd) == set(tb.model.state_dict())


def test_load_blip_checkpoint_strips_prefix_and_resamples(sides, tmp_path, rng):
    jb, params, tb = sides
    sd = {f"blip.{k}": v.clone() for k, v in tb.model.state_dict().items()}
    sd["blip.text_encoder.embeddings.position_ids"] = torch.arange(512)[None]
    sd["blip.visual_encoder_m.cls_token"] = torch.zeros(1, 1, 32)
    sd["idx_queue"] = torch.zeros(3)
    path = str(tmp_path / "blip4cir.pth")
    torch.save({"model": sd}, path)
    back = convert.load_blip_checkpoint(path, num_tokens=5)
    assert set(back) == set(tb.model.state_dict())
    for k, v in tb.model.state_dict().items():
        assert torch.equal(back[k], v), k
    # a 3x3 grid resampled to 2x2: the JAX package's (numpy) function
    pos = rng.standard_normal((1, 10, 32)).astype(np.float32)
    want = jconvert.interpolate_pos_embed(pos, 5)
    got = convert.interpolate_pos_embed(torch.from_numpy(pos), 5)
    assert got.shape == (1, 5, 32)
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-6)
    with pytest.raises(ValueError, match="square"):
        convert.interpolate_pos_embed(torch.from_numpy(pos), 7)


# ---- WordPiece ----

@pytest.fixture(scope="module")
def tokenizers():
    vocab = synthetic_bert_vocab(600)
    return (jwordpiece.BertTokenizer(vocab=vocab),
            wordpiece.BertTokenizer(vocab=vocab))


def test_wordpiece_ids_equal_jax_on_fixture_captions(tokenizers):
    jt, tt = tokenizers
    texts = list(CORPUS) + CAPTIONS + [
        "cap 3 a.", "cap 12 b?", "make it like number 42", "ext cirr 5 v2",
        "llm cirr rewrite 7", "", "Émile's  CAFÉ — naïve\tdress\n",
        "x" * 120, "汉字 dress"]
    for kw in (dict(max_length=35, replace_cls_with_enc=True),
               dict(max_length=12), dict(max_length=4)):
        for a, b in zip(jt(texts, **kw), tt(texts, **kw)):
            np.testing.assert_array_equal(a, b)
    ids, mask = tt(["make it like number 7"], max_length=10,
                   replace_cls_with_enc=True)
    assert ids[0, 0] == tt.enc_token_id == tt.vocab_size - 1
    assert tt.unk_id not in ids and mask.sum() == 7
    assert tt.decode(ids[0]) == jt.decode(ids[0]) == "make it like number 7"
    assert wordpiece.tiny_test_vocab() == jwordpiece.tiny_test_vocab()
    assert wordpiece.basic_tokenize("A.b,c") == ["a", ".", "b", ",", "c"]


@settings(max_examples=60, deadline=None)
@given(st.text(max_size=40))
def test_wordpiece_ids_equal_jax_on_any_string(tokenizers, text):
    jt, tt = tokenizers
    assert jt.encode(text) == tt.encode(text)
    assert (wordpiece.basic_tokenize(text)
            == jwordpiece.basic_tokenize(text))


def test_synthetic_vocabulary_has_the_real_size(tmp_path, monkeypatch):
    vocab = synthetic_bert_vocab()
    assert len(vocab) == len(set(vocab)) == BERT_VOCAB_SIZE == 30522
    path = write_bert_vocab(str(tmp_path / "vocab.txt"))
    monkeypatch.setenv("SPN4CIR_BERT_VOCAB", path)
    tok = wordpiece.BertTokenizer()           # reads the environment
    assert tok.vocab_size == 30524 == tmed.MedConfig().vocab_size
    assert (tok.dec_token_id, tok.enc_token_id) == (30522, 30523)
    assert tok.unk_id not in tok.encode(" ".join(CORPUS))
    monkeypatch.delenv("SPN4CIR_BERT_VOCAB")
    with pytest.raises(FileNotFoundError, match="SPN4CIR_BERT_VOCAB"):
        wordpiece.BertTokenizer()


# ---- dropout ----

def test_dropout_off_is_exact_and_on_draws_from_the_generator(sides, rng):
    jb, params, tb = sides
    drop = build_backbone("blip", blip_size="test-tiny", dropout=0.5)
    assert drop.med_cfg.dropout_rate == 0.5 and tb.med_cfg.dropout_rate == 0.0
    drop.model.load_state_dict(tb.model.state_dict())
    refer = torch.from_numpy(rng.standard_normal((4, 5, 32)).astype(np.float32))
    tids = torch.from_numpy(tb.tokenize(CAPTIONS))
    with torch.no_grad():
        want = tb.fuse(refer, tids)
        drop.eval()                 # a rate, but not in train(): exact
        assert torch.equal(drop.fuse(refer, tids), want)
        tb.train()                  # train(), but no rate: exact
        assert torch.equal(tb.fuse(refer, tids), want)
        tb.eval()
        drop.train()
        seeded = lambda s: torch.Generator().manual_seed(s)
        state = torch.get_rng_state()
        a = drop.fuse(refer, tids, generator=seeded(1))
        b = drop.fuse(refer, tids, generator=seeded(1))
        c = drop.fuse(refer, tids, generator=seeded(2))
        # the noise came from the given generator, not the global one
        assert torch.equal(torch.get_rng_state(), state)
        g = seeded(1)
        before = g.get_state()
        drop.fuse(refer, tids, generator=g)
        assert not torch.equal(g.get_state(), before)
    assert torch.equal(a, b)
    assert (a - want).abs().max() > 1e-3 and (a - c).abs().max() > 1e-3
    # inverted dropout keeps the expectation
    d = tmed.Dropout(0.25, True, seeded(0))
    x = torch.ones(200, 200)
    y = d(x)
    assert y.unique().tolist() == pytest.approx([0.0, 1.0 / 0.75])
    assert abs(y.mean().item() - 1.0) < 0.02
    assert tmed.Dropout(0.25, False)(x) is x
