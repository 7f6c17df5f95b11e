"""The port's blip24cir modules against the JAX package, on the CPU.

Small sizes (`EvaViTConfig.tiny`: 28-pixel images, 5 tokens, width 32, 2
layers; `QFormerConfig.tiny`: hidden 32, 2 layers, 2 heads, 8 query tokens;
`tiny_test_vocab`), the same weights on both sides
(`blip2_state_dict_from_jax`, every leaf given noise so that each is
compared; the key third of EVA's fused qkv bias stays zero, as EVA has
none), the same numpy inputs from a seed. The EVA-shaped stack (257 tokens,
heads of 88) runs the JAX side through its Pallas attention kernel in
interpret mode, as tests/test_torch_long_attention.py does for ViT-L/14.

Tolerances: float32 outputs 1e-5 absolute (the sides differ in summation
order and in LayerNorm's variance formula; the outputs are O(1)); the
EVA-shaped stack 2e-5 (257-token softmaxes, width 176); bfloat16 by cosine
> 0.999 per row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.models import blip24cir as jblip2
from spn4cir_tpu.models import convert as jconvert
from spn4cir_tpu.models import layers as jlayers
from spn4cir_tpu.models import qformer as jqformer
from spn4cir_tpu.models.api import build_backbone as jax_build_backbone
from spn4cir_tpu.train import stage2 as jstage2
from spn4cir_tpu_torch.models import convert
from spn4cir_tpu_torch.models import eva_vit as teva
from spn4cir_tpu_torch.models import qformer as tqformer
from spn4cir_tpu_torch.models.api import build_backbone
from spn4cir_tpu_torch.models.layers import run_blocks
from spn4cir_tpu_torch.ops import attention_kernels
from spn4cir_tpu_torch.train import stage2

torch.set_num_threads(1)

ATOL = 1e-5
CAPTIONS = ["make it more blue", "a red dress with short sleeve",
            "less print, long shirt!", "the"]


def _cos(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _noisy(params, rng, scale=0.05):
    """Noise on every leaf but the key third of a fused qkv bias (EVA's key
    has no bias) and the temperature."""
    def leaf(path, x):
        keys = [getattr(p, "key", None) for p in path]
        x = np.array(x)
        if "tau" in keys:
            return x
        noise = scale * rng.standard_normal(x.shape).astype(np.float32)
        if keys[-2:] == ["qkv", "bias"]:
            third = x.shape[-1] // 3
            noise[..., third:2 * third] = 0.0
        return x + noise
    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def sides():
    rng = np.random.RandomState(7)
    jb = jax_build_backbone("blip2", blip2_size="test-tiny")
    params = _noisy(jax.device_get(jax.jit(jb.init_params)(
        jax.random.PRNGKey(0))), rng)
    tb = build_backbone("blip2", blip2_size="test-tiny")
    tb.model.load_state_dict(
        convert.blip2_state_dict_from_jax(params, tb.vit_cfg, tb.q_cfg))
    tb.eval()
    return jb, params, tb


def _bf16_port(tb):
    b = build_backbone("blip2", blip2_size="test-tiny", dtype=torch.bfloat16)
    b.model.load_state_dict(tb.model.state_dict())
    return b.eval()


# ---- EVA ----

def test_eva_vit_tiny_matches_jax(rng):
    cfg = jblip2.EvaViTConfig.tiny()
    images = rng.standard_normal((3, 28, 28, 3)).astype(np.float32)
    jmod = jblip2.EvaViT(cfg)
    params = _noisy(jax.device_get(jmod.init(jax.random.PRNGKey(2),
                                             jnp.asarray(images))), rng)
    want = np.asarray(jmod.apply(params, jnp.asarray(images)))
    tmod = teva.EvaViT(teva.EvaViTConfig.tiny())
    tmod.load_state_dict(convert.eva_vit_state_dict(params["params"], ""))
    with torch.inference_mode():
        got = tmod(torch.from_numpy(images))
    assert got.shape == (3, 5, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    names = set(tmod.state_dict())
    assert {"patch_embed.proj.weight", "patch_embed.proj.bias", "cls_token",
            "pos_embed", "blocks.0.norm1.weight", "blocks.1.attn.qkv.weight",
            "blocks.1.attn.q_bias", "blocks.0.attn.v_bias",
            "blocks.0.attn.proj.weight", "blocks.1.mlp.fc1.weight",
            "blocks.0.mlp.fc2.bias", "blocks.1.norm2.bias"} <= names
    assert "blocks.0.attn.qkv.bias" not in names and "norm.weight" not in names
    # a key bias in the JAX tree has no place in EVA: refused, not dropped
    bad = jax.tree_util.tree_map(np.array, params["params"])
    bad["blocks"]["blocks"]["block"]["attn"]["qkv"]["bias"][:, 40] = 1.0
    with pytest.raises(ValueError, match="key"):
        convert.eva_vit_state_dict(bad, "")


def test_eva_shaped_stack_matches_jax_pallas_route(rng):
    """Two EVA blocks at S=257, heads of 88 (width 176), exact GELU, MLP
    ratio 4.3637, LN eps 1e-6: the JAX stack forced through its Pallas
    attention kernel (interpret mode), the port through `long_attention`'s
    route (its plain version on the CPU)."""
    x = rng.standard_normal((2, 257, 176)).astype(np.float32)
    jmod = jlayers.Transformer(2, 2, act=jblip2._gelu, mlp_mult=4.3637,
                               ln_eps=1e-6, fused="pallas")
    params = _noisy(jax.device_get(jax.jit(jmod.init)(
        jax.random.PRNGKey(1), jnp.asarray(x))), rng, 0.02)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    cfg = teva.EvaViTConfig(image_size=224, patch_size=14, width=176,
                            layers=2, heads=2)
    assert cfg.num_tokens == 257
    tmod = teva.EvaViT(cfg)
    sd = convert.eva_vit_state_dict({
        "cls_token": np.zeros((1, 1, 176), np.float32),
        "pos_embed": np.zeros((257, 176), np.float32),
        "patch_embed": {"kernel": np.zeros((14, 14, 3, 176), np.float32),
                        "bias": np.zeros(176, np.float32)},
        "blocks": params["params"]}, "")
    tmod.load_state_dict(sd)
    assert tmod.blocks[0].mlp.fc1.out_features == 768
    calls = []
    orig = attention_kernels.attention_route

    def route(*a):
        calls.append(orig(*a))
        return calls[-1]

    import spn4cir_tpu_torch.models.layers as tlayers
    tlayers.attention_route = route
    try:
        with torch.inference_mode():
            got = run_blocks(tmod.blocks, torch.from_numpy(x))
    finally:
        tlayers.attention_route = orig
    assert calls == ["long", "long"]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name,shape", [
    ("full", (257, 1408, 39, 16, 6144)), ("tiny", (5, 32, 2, 2, 128))])
def test_eva_configs_equal_jax(name, shape):
    t = teva.EvaViTConfig() if name == "full" else teva.EvaViTConfig.tiny()
    j = jblip2.EvaViTConfig() if name == "full" else jblip2.EvaViTConfig.tiny()
    for c in (t, j):
        assert (c.num_tokens, c.width, c.layers, c.heads,
                int(c.width * c.mlp_ratio)) == shape
    assert dataclasses_equal(t, j)


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


# ---- the Q-Former ----

def _qformer_pair(rng):
    jcfg = jqformer.QFormerConfig.tiny(64)
    ids = rng.randint(0, 64, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[0, 4:] = 0
    queries = rng.standard_normal((3, 8, 32)).astype(np.float32)
    enc = rng.standard_normal((3, 6, 32)).astype(np.float32)
    jmod = jqformer.QFormer(jcfg)
    full = np.concatenate([np.ones((3, 8), np.int32), mask], 1)
    params = _noisy(jax.device_get(jmod.init(
        jax.random.PRNGKey(3), jnp.asarray(ids), jnp.asarray(queries),
        jnp.asarray(full), jnp.asarray(enc))), rng)
    tmod = tqformer.QFormer(tqformer.QFormerConfig.tiny(64)).eval()
    tmod.load_state_dict(convert.qformer_state_dict(params["params"], "bert"))
    return jmod, params, tmod, (ids, full, queries, enc)


@pytest.mark.parametrize("mode", ["query-only", "query-only-masked", "fusion",
                                  "text-reread"])
def test_qformer_matches_jax(mode, rng):
    jmod, params, tmod, (ids, full, queries, enc) = _qformer_pair(rng)
    enc_mask = np.ones((3, 6), np.int32)
    enc_mask[1, 3:] = 0
    kw = {"query_embeds": queries}
    if mode.startswith("query-only"):
        kw["encoder_hidden_states"] = enc
        if mode.endswith("masked"):
            kw["encoder_attention_mask"] = enc_mask
    elif mode == "fusion":
        kw.update(input_ids=ids, attention_mask=full,
                  encoder_hidden_states=enc)
    else:
        kw.update(input_ids=ids, attention_mask=full)
    want = np.asarray(jmod.apply(params, **{k: jnp.asarray(v)
                                            for k, v in kw.items()}))
    with torch.inference_mode():
        got = tmod(**{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_qformer_names_are_lavis():
    names = set(tqformer.QFormer(tqformer.QFormerConfig.tiny(16)).state_dict())
    want = {"bert.embeddings.word_embeddings.weight",
            "bert.embeddings.position_embeddings.weight",
            "bert.embeddings.LayerNorm.weight"}
    for i in (0, 1):
        layer = f"bert.encoder.layer.{i}."
        for leaf in ("self.query.weight", "self.key.bias",
                     "self.value.weight", "output.dense.weight",
                     "output.LayerNorm.bias"):
            want.add(f"{layer}attention.{leaf}")
        for ffn in ("", "_query"):
            want |= {f"{layer}intermediate{ffn}.dense.weight",
                     f"{layer}output{ffn}.dense.bias",
                     f"{layer}output{ffn}.LayerNorm.weight"}
    want.add("bert.encoder.layer.0.crossattention.self.key.weight")
    assert want <= names
    # cross-attention on the even layers only (cross_attention_freq 2)
    assert not any(n.startswith("bert.encoder.layer.1.crossattention")
                   for n in names)
    full = tqformer.QFormerConfig()
    assert (full.vocab_size, full.hidden_size, full.num_layers,
            full.num_heads, full.intermediate_size, full.encoder_width,
            full.num_query_tokens) == (30523, 768, 12, 12, 3072, 1408, 32)
    assert dataclasses_equal(full, jqformer.QFormerConfig())


def test_qformer_ffn_split_is_gated_on_the_image(rng):
    """With encoder states the query positions take the `_query` FFN in
    every layer, the cross-less odd layer too; without them none does."""
    _, _, tmod, (ids, full, queries, enc) = _qformer_pair(rng)
    seen = []
    hooks = [m.register_forward_hook(lambda mod, i, o, n=n: seen.append(n))
             for n, m in tmod.named_modules()
             if n.endswith(("intermediate_query", "intermediate"))]
    try:
        with torch.inference_mode():
            tmod(torch.from_numpy(ids), torch.from_numpy(queries),
                 torch.from_numpy(full), torch.from_numpy(enc))
            with_image = list(seen)
            seen.clear()
            tmod(torch.from_numpy(ids), torch.from_numpy(queries),
                 torch.from_numpy(full))
    finally:
        for h in hooks:
            h.remove()
    assert with_image == [
        "bert.encoder.layer.0.intermediate_query",
        "bert.encoder.layer.0.intermediate",
        "bert.encoder.layer.1.intermediate_query",
        "bert.encoder.layer.1.intermediate"]
    assert seen == ["bert.encoder.layer.0.intermediate",
                    "bert.encoder.layer.1.intermediate"]


# ---- the backbone ----

def test_index_fuse_bank_and_scores_match_jax(sides, rng):
    jb, params, tb = sides
    images = rng.standard_normal((4, 28, 28, 3)).astype(np.float32)
    jids, tids = jb.tokenize(CAPTIONS), tb.tokenize(CAPTIONS)
    np.testing.assert_array_equal(jids, tids)
    assert tids.shape == (4, 2, 32) and tids.dtype == np.int32
    want = jb.index_features(params, jnp.asarray(images))
    with torch.inference_mode():
        got = tb.index_features(torch.from_numpy(images))
        fused = tb.fuse(got["refer"], torch.from_numpy(tids))
        gallery = tb.gallery_features(torch.from_numpy(images))
        bank_refer, bank_target = tb.fusion_bank_features(
            torch.from_numpy(images), torch.from_numpy(tids))
        scores = tb.score_queries(fused, got["target"])
    assert got["refer"].shape == (4, 5, 32)
    assert got["target"].shape == (4, 8, 256)
    for key in ("target", "refer"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)
    assert torch.equal(gallery, got["target"])
    want_q = jb.fuse(params, want["refer"], jnp.asarray(jids))
    np.testing.assert_allclose(fused.numpy(), np.asarray(want_q), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(fused.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    jr, jt = jb.fusion_bank_features(params, jnp.asarray(images),
                                     jnp.asarray(jids))
    assert bank_refer.shape == (4, 8, 32)
    np.testing.assert_allclose(bank_refer.numpy(), np.asarray(jr), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(bank_target.numpy(), np.asarray(jt),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        scores.numpy(), np.asarray(jb.score_queries(want_q, want["target"])),
        atol=ATOL, rtol=0)
    with pytest.raises(NotImplementedError, match="caption"):
        tb.bank_features(torch.from_numpy(images))
    with pytest.raises(NotImplementedError):
        tb.encode_text(torch.from_numpy(tids))


def test_bfloat16_backbone_matches_jax_by_cosine(sides, rng):
    jb, params, tb = sides
    jb16 = jax_build_backbone("blip2", blip2_size="test-tiny",
                              dtype=jnp.bfloat16)
    tb16 = _bf16_port(tb)
    images = rng.standard_normal((4, 28, 28, 3)).astype(np.float32)
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


@pytest.mark.parametrize("neg", [False, True])
def test_stage2_loss_matches_jax(sides, rng, neg):
    """The full-bank loss (the plain max-query version on the CPU) and the
    sampled-negatives loss, with their gradients of the trainable copy."""
    jb, params, tb = sides
    b, m = 5, 23
    refer = rng.standard_normal((b, 8, 32)).astype(np.float32)
    bank = rng.standard_normal((m, 8, 256)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    labels = rng.randint(0, m, b).astype(np.int64)
    tids = tb.tokenize(CAPTIONS + ["more red"])
    neg_idx = (np.stack([rng.choice(np.delete(np.arange(m), l), 4, False)
                         for l in labels]) if neg else None)
    jkw = {"neg_idx": jnp.asarray(neg_idx)} if neg else {"impl": "xla"}
    want, jgrads = jax.value_and_grad(lambda p: jb.stage2_loss(
        p, jnp.asarray(refer), jnp.asarray(tids), jnp.asarray(bank),
        jnp.asarray(labels), **jkw))(params)
    tkw = {"neg_idx": torch.from_numpy(neg_idx)} if neg else {}
    tb.zero_grad(set_to_none=True)
    loss = tb.stage2_loss(torch.from_numpy(refer), torch.from_numpy(tids),
                          torch.from_numpy(bank), torch.from_numpy(labels),
                          **tkw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), atol=ATOL, rtol=0)
    grads = convert.blip2_state_dict_from_jax(jax.device_get(jgrads))
    for name in ("text_proj_q.weight", "temp",
                 "Qformer_query.bert.embeddings.word_embeddings.weight",
                 "Qformer_query.bert.encoder.layer.1.output.dense.weight",
                 "Qformer_query.bert.encoder.layer.0.attention.self.query.bias"):
        p = tb.model.get_parameter(name)
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   atol=2e-5, rtol=2e-3, err_msg=name)
    tb.zero_grad(set_to_none=True)


def test_backbone_surface(sides):
    jb, params, tb = sides
    spec = tb.bank_spec()
    assert (spec.refer_shape, spec.target_shape) == ((8, 32), (8, 256))
    assert tuple(jb.bank_spec().refer_shape) == spec.refer_shape
    assert (tb.name, tb.extend_suffix, tb.fiq_exclude_reference,
            tb.default_transform, tb.input_dim, tb.embed_dim) == (
        "blip2", "blip2", False, "targetpad", 28, 256)
    assert (jb.name, jb.extend_suffix, jb.fiq_exclude_reference) == (
        "blip2", "blip2", False)
    assert tb.optimizer_kwargs() == jb.optimizer_kwargs()
    assert isinstance(tb.model.temp, torch.nn.Parameter)
    assert tb.model.temp.shape == () and tb.model.temp.item() == pytest.approx(
        0.05)
    assert tb.pre_caption("A Dress!! (red); long.  ") == jb.pre_caption(
        "A Dress!! (red); long.  ") == "a dress red long"
    with pytest.raises(NotImplementedError, match="stage-1"):
        tb.stage1_loss(None, None, None)


def test_stage2_freeze_mask_equals_jax(sides):
    """Only Qformer_query, text_proj_q and temp train: leaf for leaf the JAX
    mask, carried through the converter. The port's Qformer_query keeps
    LAVIS's cross-attention (the JAX tree has none); it is in the optimizer
    but never gets a gradient."""
    jb, params, tb = sides
    mask = stage2.trainable_mask(tb)
    for name, trains in mask.items():
        assert trains == name.startswith(("model.Qformer_query.",
                                          "model.text_proj_q.",
                                          "model.temp")), name
    jmask = jstage2.trainable_mask(params, jb.trainable_filter)
    marked = jax.tree_util.tree_map(
        lambda p, m: np.full(np.shape(p), 0.0 if m else np.nan, np.float32),
        params, jmask)
    # EVA's absent key bias is the one exact zero the converter checks
    qkv = marked["params"]["visual_encoder"]["blocks"]["blocks"]["block"][
        "attn"]["qkv"]
    qkv["bias"][:, 32:64] = 0.0
    for name, t in convert.blip2_state_dict_from_jax(marked).items():
        if name.startswith("Qformer_query.") and ".crossattention." in name:
            continue        # copied from the frozen Qformer's
        assert bool(torch.isnan(t).all()) == (not mask["model." + name]), name


# ---- conversion ----

def test_convert_blip2_cir_gives_back_the_jax_tree(sides):
    """The JAX package's own converter, applied to the port's state dict
    (which has LAVIS's names), returns the tree the weights came from, bit
    for bit; with the `blip_model.` prefix too."""
    jb, params, tb = sides
    sd = {k: v.numpy() for k, v in tb.model.state_dict().items()}
    for wrapped in (sd, {f"blip_model.{k}": v for k, v in sd.items()}):
        back = jconvert.convert_blip2_cir(wrapped, 2, 2)
        want = jax.tree_util.tree_leaves_with_path(params)
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]),
                                          np.asarray(leaf),
                                          err_msg=jax.tree_util.keystr(path))


def test_blip2_state_dict_checks_depth_and_owns_its_memory(sides):
    jb, params, tb = sides
    with pytest.raises(ValueError, match="depth"):
        convert.blip2_state_dict_from_jax(params, teva.EvaViTConfig())
    sd = convert.blip2_state_dict_from_jax(params)
    src = params["params"]["text_proj_q"]["bias"]
    sd["text_proj_q.bias"].add_(1.0)
    assert not np.shares_memory(sd["text_proj_q.bias"].numpy(), src)
    assert set(sd) == set(tb.model.state_dict())
    # the port's copy's cross-attention is the frozen Qformer's
    for k in sd:
        if k.startswith("Qformer_query.") and ".crossattention." in k:
            assert torch.equal(sd[k], sd["Qformer." + k[len("Qformer_query."):]])


def test_load_blip2_checkpoint_fills_the_stage2_copies(sides, tmp_path, rng):
    """A stage-1 LAVIS checkpoint: `blip_model.` prefix, the Q-Former's
    `cls` head, `position_ids`, no Qformer_query / text_proj_q /
    prompt_tokens / temp. The loader fills the copies from their sources
    (the init_stage2 surgery) and resamples the EVA position grid."""
    jb, params, tb = sides
    src = tb.model.state_dict()
    sd = {f"blip_model.{k}": v.clone() for k, v in src.items()
          if not k.startswith(("Qformer_query.", "text_proj_q.", "temp",
                               "prompt_tokens"))}
    sd["blip_model.Qformer.cls.predictions.bias"] = torch.zeros(3)
    sd["blip_model.Qformer.bert.embeddings.position_ids"] = torch.arange(9)
    path = str(tmp_path / "blip2_stage1.pth")
    torch.save({"model": sd}, path)
    back = convert.load_blip2_checkpoint(path, num_tokens=5)
    assert set(back) == set(src) - {"temp"}
    for k, v in back.items():
        if k.startswith("Qformer_query."):
            assert torch.equal(v, src["Qformer." + k[len("Qformer_query."):]])
        elif k.startswith("text_proj_q."):
            assert torch.equal(v, src["text_proj." + k[len("text_proj_q."):]])
        elif k == "prompt_tokens":
            assert not v.any() and v.shape == src["query_tokens"].shape
        else:
            assert torch.equal(v, src[k]), k
    # the port's own checkpoint loads as it is; a 3x3 grid resamples to 2x2
    torch.save({"epoch": 0, "state_dict": src}, path)
    again = convert.load_blip2_checkpoint(path)
    assert all(torch.equal(again[k], v) for k, v in src.items())
    big = {k: v.clone() for k, v in src.items()}
    big["visual_encoder.pos_embed"] = torch.from_numpy(
        rng.standard_normal((1, 10, 32)).astype(np.float32))
    torch.save(big, path)
    got = convert.load_blip2_checkpoint(path, num_tokens=5)
    np.testing.assert_allclose(
        got["visual_encoder.pos_embed"][0].numpy(),
        jconvert.interpolate_pos_embed(big["visual_encoder.pos_embed"].numpy(),
                                       5), atol=1e-6)


def test_init_params_draws_on_the_parameters_device():
    """`init_params` seeds a generator of the parameters' device from the
    given CPU generator: the same seed gives the same weights."""
    a = build_backbone("blip2", blip2_size="test-tiny")
    b = build_backbone("blip2", blip2_size="test-tiny")
    a.init_params(torch.Generator().manual_seed(3))
    b.init_params(torch.Generator().manual_seed(3))
    for (name, x), y in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(x, y), name
    m = a.model
    assert m.temp.item() == pytest.approx(0.05)
    assert torch.equal(m.ln_vision.weight, torch.ones(32))
    assert not m.visual_encoder.blocks[0].attn.q_bias.any()
    assert torch.equal(m.Qformer.bert.embeddings.LayerNorm.weight,
                       torch.ones(32))
    assert 0.01 < m.query_tokens.std().item() < 0.03
