"""The port's CLIP layers, towers and clip4cir backbone against the JAX
package, with the same weights (converted by `clip_state_dict_from_jax`) and
the same numpy inputs from a seed, on the CPU in float32.

Tolerance: atol 1e-4 on tower outputs (float32, summation order and
LayerNorm variance formula differ); the weight round trip is exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.models import clip as jclip
from spn4cir_tpu.models import layers as jlayers
from spn4cir_tpu.models.clip4cir import ClipCIR as JaxClipCIR
from spn4cir_tpu.models.convert import convert_clip_state_dict
from spn4cir_tpu.tokenizer.bpe import tokenize
from spn4cir_tpu_torch.models import clip as tclip
from spn4cir_tpu_torch.models import layers as tlayers
from spn4cir_tpu_torch.models.clip4cir import ClipCIR
from spn4cir_tpu_torch.models.convert import (clip_state_dict_from_jax,
                                              transformer_state_dict)
from spn4cir_tpu_torch.ops.attention_kernels import short_attention
from tests.torch_fixtures import synthetic_tokenizer

torch.set_num_threads(1)

ATOL = 1e-4

# 2 layers at the real sequence lengths and head width: ViT/32 at 224
# (S=50), text S=77, head_dim 64 in both towers
D64 = dict(embed_dim=64, image_resolution=224, vision_layers=2,
           vision_width=128, vision_patch_size=32, transformer_width=128,
           transformer_heads=2, transformer_layers=2)
CONFIGS = {
    "test-tiny": (jclip.CLIP_CONFIGS["test-tiny"],
                  tclip.CLIP_CONFIGS["test-tiny"]),
    "d64": (jclip.CLIPConfig(**D64), tclip.CLIPConfig(**D64)),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(jax model, jax params as numpy, port model) with shared weights."""
    jcfg, tcfg = CONFIGS[request.param]
    jmodel = jclip.CLIP(jcfg)
    images = jnp.zeros((1, jcfg.image_resolution, jcfg.image_resolution, 3))
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), images, jnp.zeros((1, 77), jnp.int32)))
    tmodel = tclip.CLIP(tcfg)
    tmodel.load_state_dict(clip_state_dict_from_jax(params, tcfg))
    return jmodel, params, tmodel


def _text_ids(rng, b, vocab):
    ids = np.zeros((b, 77), np.int32)
    for row in range(b):
        n = rng.randint(1, 60)
        ids[row, 0] = vocab - 2                         # SOT
        ids[row, 1:n + 1] = rng.randint(1, vocab - 2, n)
        ids[row, n + 1] = vocab - 1                     # EOT: the argmax
    return ids


def test_state_dict_round_trip_is_exact(pair):
    jmodel, params, tmodel = pair
    cfg = tmodel.cfg
    back = convert_clip_state_dict(tmodel.state_dict(), cfg.vision_layers,
                                   cfg.transformer_layers, is_vit=True)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_got)
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]),
                                      np.asarray(want), err_msg=str(path))


def test_vision_tower_matches_jax(pair, rng):
    jmodel, params, tmodel = pair
    res = tmodel.cfg.image_resolution
    images = rng.standard_normal((2, res, res, 3)).astype(np.float32)
    want = jax.jit(functools.partial(jmodel.apply, method="encode_image"))(
        params, jnp.asarray(images))
    with torch.inference_mode():
        got = tmodel.encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_text_tower_matches_jax(pair, rng):
    jmodel, params, tmodel = pair
    ids = _text_ids(rng, 3, tmodel.cfg.vocab_size)
    want = jax.jit(functools.partial(jmodel.apply, method="encode_text"))(
        params, jnp.asarray(ids))
    with torch.inference_mode():
        got = tmodel.encode_text(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("s,causal,masked", [
    (50, False, False), (77, True, False), (130, False, False),
    (50, False, True)])
def test_transformer_matches_jax(s, causal, masked, rng):
    """Two pre-LN blocks at width 128, 2 heads of 64. S=130 exceeds the
    short-attention limit and an explicit additive mask is not the
    kernel's to take: both run the plain path."""
    x = rng.standard_normal((2, s, 128)).astype(np.float32)
    mask = None
    if masked:  # -inf at random key positions, never on the diagonal
        mask = np.where(rng.rand(s, s) < 0.3, -np.inf, 0.0).astype(np.float32)
        np.fill_diagonal(mask, 0.0)
    jmask = None if mask is None else jnp.asarray(mask)
    jmod = jlayers.Transformer(2, 2, causal=causal)
    params = jax.device_get(jax.jit(jmod.init)(jax.random.PRNGKey(1),
                                                jnp.asarray(x)))
    want = jax.jit(jmod.apply)(params, jnp.asarray(x), jmask)
    tmod = tlayers.Transformer(128, 2, 2, causal=causal)
    tmod.load_state_dict(transformer_state_dict(params["params"]))
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x),
                   None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_computes_in_f32_and_casts_back(dtype, rng):
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    jmod = jlayers.LayerNorm()
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    ln = tlayers.LayerNorm(16)
    got = ln(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().detach().numpy(), want,
                               atol=1e-5 if dtype == torch.float32 else 2e-2)


def test_quick_gelu_matches_jax(rng):
    x = rng.standard_normal(64).astype(np.float32) * 3
    want = np.asarray(jlayers.quick_gelu(jnp.asarray(x)))
    np.testing.assert_allclose(tlayers.quick_gelu(torch.from_numpy(x)).numpy(),
                               want, atol=1e-6)


def test_plain_attention_route_matches_short_attention_route(pair, rng):
    """fused='plain' (the einsum path) and 'auto' (short_attention, here its
    plain version) compute the same function."""
    _, _, tmodel = pair
    ids = torch.from_numpy(_text_ids(rng, 2, tmodel.cfg.vocab_size))
    with torch.inference_mode():
        auto = tmodel.encode_text(ids)
        tlayers.set_attention_impl(tmodel, "plain")
        try:
            plain = tmodel.encode_text(ids)
        finally:
            tlayers.set_attention_impl(tmodel, "auto")
    torch.testing.assert_close(plain, auto, atol=1e-5, rtol=1e-5)


def test_rn50x4_state_dict_names_are_exactly_openais():
    """RN50x4 on the meta device has OpenAI's state-dict names, no more and
    no fewer (tests/test_torch_resnet.py holds the shapes)."""
    with torch.device("meta"):
        names = set(ClipCIR("RN50x4").model.state_dict())
    bn = ("weight", "bias", "running_mean", "running_var",
          "num_batches_tracked")
    want = {"positional_embedding", "text_projection", "logit_scale",
            "token_embedding.weight", "ln_final.weight", "ln_final.bias",
            "visual.attnpool.positional_embedding"}
    want |= {f"visual.attnpool.{p}_proj.{w}" for p in "qkvc"
             for w in ("weight", "bias")}
    for i in range(12):
        pre = f"transformer.resblocks.{i}"
        want |= {f"{pre}.attn.in_proj_weight", f"{pre}.attn.in_proj_bias"}
        want |= {f"{pre}.{m}.{w}" for w in ("weight", "bias")
                 for m in ("attn.out_proj", "ln_1", "ln_2", "mlp.c_fc",
                           "mlp.c_proj")}
    blocks = ["visual"] + [f"visual.layer{s + 1}.{b}"
                           for s, n in enumerate((4, 6, 10, 6))
                           for b in range(n)]
    for pre in blocks:
        want |= {f"{pre}.conv{j}.weight" for j in (1, 2, 3)}
        want |= {f"{pre}.bn{j}.{w}" for j in (1, 2, 3) for w in bn}
        if pre.endswith(".0"):
            want.add(f"{pre}.downsample.0.weight")
            want |= {f"{pre}.downsample.1.{w}" for w in bn}
    assert names == want


def test_clipcir_index_and_fuse_match_jax(rng):
    tok = synthetic_tokenizer()
    jb = JaxClipCIR("test-tiny")
    params = jax.device_get(jax.jit(jb.init_params)(jax.random.PRNGKey(3)))
    tb = ClipCIR("test-tiny", tokenizer=tok)
    tb.model.load_state_dict(clip_state_dict_from_jax(params, tb.cfg))
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    want = jax.jit(jb.index_features)(params, jnp.asarray(images))
    with torch.inference_mode():
        got = tb.index_features(torch.from_numpy(images))
    for key in ("target", "refer"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0)

    captions = ["make it like number 7 but red", "a zebra on the beach",
                "is darker and has longer sleeves", "same shirt in blue"]
    ids = tb.tokenize(captions)
    np.testing.assert_array_equal(
        ids, tokenize(captions, truncate=True, tokenizer=tok))
    refer = np.array(want["refer"])
    want_q = jax.jit(jb.fuse)(params, jnp.asarray(refer), jnp.asarray(ids))
    with torch.inference_mode():
        got_q = tb.fuse(torch.from_numpy(refer), torch.from_numpy(ids))
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got_q.numpy(), axis=-1), 1.0,
                               atol=1e-5)


def test_bf16_towers_track_f32(pair, rng):
    """bf16 activations over f32 params: features stay within cosine
    0.99 of the f32 features (bf16 keeps ~3 significant digits)."""
    _, _, tmodel = pair
    res = tmodel.cfg.image_resolution
    images = torch.from_numpy(
        rng.standard_normal((2, res, res, 3)).astype(np.float32))
    bf16 = tclip.CLIP(tmodel.cfg, dtype=torch.bfloat16)
    bf16.load_state_dict(tmodel.state_dict())
    before = short_attention.launches
    with torch.inference_mode():
        want = tmodel.encode_image(images)
        got = bf16.encode_image(images)
    assert got.dtype == torch.bfloat16
    assert short_attention.launches == before  # CPU: no kernel launches
    cos = torch.nn.functional.cosine_similarity(got.float(), want, dim=-1)
    assert cos.min() > 0.99, cos


def test_clip_configs_cover_the_released_vits():
    for name in ("ViT-B/32", "ViT-B/16", "ViT-L/14", "test-tiny"):
        jcfg, tcfg = jclip.CLIP_CONFIGS[name], tclip.CLIP_CONFIGS[name]
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
