"""The port's ModifiedResNet tower (the RN50x4 family) against the JAX
package: the same weights and running statistics (converted by
`clip_state_dict_from_jax` with `batch_stats`) and the same numpy inputs
from a seed, on the CPU.

The configuration is a narrow one built here (width 8, one block per stage,
64-pixel images, embedding 64), with running means and variances drawn at
random so that the BatchNorms are not the identity. Tolerances: float32
within atol = rtol = 1e-5 (summation order only); bfloat16 activations
within cosine 0.999 of the JAX package's bfloat16 features (the two
frameworks round at different places).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.models import clip as jclip
from spn4cir_tpu.models.convert import convert_clip_state_dict
from spn4cir_tpu_torch.models import clip as tclip
from spn4cir_tpu_torch.models.clip4cir import ClipCIR
from spn4cir_tpu_torch.models.convert import clip_state_dict_from_jax

torch.set_num_threads(1)

RN = dict(embed_dim=64, image_resolution=64, vision_layers=(1, 1, 1, 1),
          vision_width=8, vision_patch_size=None, context_length=77,
          transformer_width=64, transformer_heads=1, transformer_layers=2)
# two blocks in a stage: the second has no downsample path
RN_DEEP = dict(RN, vision_layers=(2, 1, 2, 1), image_resolution=96)


def _variables(jcfg, seed=0):
    """JAX variables with non-trivial running statistics and BatchNorm
    scales and biases, as numpy."""
    jmodel = jclip.CLIP(jcfg)
    res = jcfg.image_resolution
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, res, res, 3)),
        jnp.zeros((1, 77), jnp.int32)))
    rng = np.random.RandomState(seed + 1)

    def stat(path, leaf):
        kind = jax.tree_util.keystr(path)
        if kind.endswith("['var']"):
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    def affine(path, leaf):
        kind = jax.tree_util.keystr(path)
        if "['bn']['scale']" in kind:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if "['bn']['bias']" in kind:
            return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return np.asarray(leaf)

    return jmodel, {
        "params": jax.tree_util.tree_map_with_path(affine,
                                                   variables["params"]),
        "batch_stats": jax.tree_util.tree_map_with_path(
            stat, variables["batch_stats"])}


@pytest.fixture(scope="module", params=["rn", "rn_deep"])
def pair(request):
    kw = RN if request.param == "rn" else RN_DEEP
    jmodel, variables = _variables(jclip.CLIPConfig(**kw))
    tcfg = tclip.CLIPConfig(**kw)
    tmodel = tclip.CLIP(tcfg)
    tmodel.load_state_dict(clip_state_dict_from_jax(variables, tcfg))
    return jmodel, variables, tmodel.eval()


def _images(rng, cfg, b=2):
    res = cfg.image_resolution
    return rng.standard_normal((b, res, res, 3)).astype(np.float32)


def test_resnet_tower_matches_jax_float32(pair, rng):
    jmodel, variables, tmodel = pair
    images = _images(rng, tmodel.cfg)
    want = jax.jit(functools.partial(jmodel.apply, method="encode_image"))(
        variables, jnp.asarray(images))
    with torch.inference_mode():
        got = tmodel.encode_image(torch.from_numpy(images))
    assert got.shape == (2, tmodel.cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_resnet_tower_is_the_same_in_train_mode(pair, rng):
    """The tower always normalises with the running statistics and never
    updates them: train() computes what eval() computes."""
    _, _, tmodel = pair
    images = torch.from_numpy(_images(rng, tmodel.cfg))
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    with torch.no_grad():
        want = tmodel.encode_image(images)
        tmodel.train()
        try:
            got = tmodel.encode_image(images)
        finally:
            tmodel.eval()
    assert torch.equal(got, want)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_resnet_tower_bf16_tracks_jax_bf16(pair, rng):
    jmodel, variables, tmodel = pair
    images = _images(rng, tmodel.cfg, 3)
    jb16 = jclip.CLIP(jmodel.cfg, dtype=jnp.bfloat16)
    want = np.array(jax.jit(functools.partial(
        jb16.apply, method="encode_image"))(
            variables, jnp.asarray(images)).astype(jnp.float32))
    tb16 = tclip.CLIP(tmodel.cfg, dtype=torch.bfloat16)
    tb16.load_state_dict(tmodel.state_dict())
    with torch.inference_mode():
        got = tb16.encode_image(torch.from_numpy(images))
        f32 = tmodel.encode_image(torch.from_numpy(images))
    assert got.dtype == torch.bfloat16
    for other in (torch.from_numpy(want), f32):
        cos = torch.nn.functional.cosine_similarity(got.float(), other, dim=-1)
        assert cos.min() > 0.999, cos


def test_resnet_state_dict_round_trip_is_exact(pair):
    """Port state dict -> the JAX package's converter -> the variables the
    state dict was made from, params and batch_stats alike."""
    _, variables, tmodel = pair
    back = convert_clip_state_dict(tmodel.state_dict(), 0,
                                   tmodel.cfg.transformer_layers, is_vit=False)
    for coll in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[coll])
        got = dict(jax.tree_util.tree_leaves_with_path(back[coll]))
        assert len(want) == len(got)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]),
                                          np.asarray(leaf), err_msg=str(path))


def test_converter_takes_batch_stats_apart_and_needs_them(pair):
    _, variables, tmodel = pair
    whole = clip_state_dict_from_jax(variables, tmodel.cfg)
    apart = clip_state_dict_from_jax(variables["params"], tmodel.cfg,
                                     batch_stats=variables["batch_stats"])
    assert whole.keys() == apart.keys()
    for k in whole:
        assert torch.equal(whole[k], apart[k]), k
    # strict load: the converted dict has no num_batches_tracked entries
    assert not any(k.endswith("num_batches_tracked") for k in whole)
    tclip.CLIP(tmodel.cfg).load_state_dict(whole, strict=True)
    # ... and a reference checkpoint, which has them, loads strictly too
    tclip.CLIP(tmodel.cfg).load_state_dict(tmodel.state_dict(), strict=True)
    with pytest.raises(ValueError, match="batch_stats"):
        clip_state_dict_from_jax(variables["params"], tmodel.cfg)


def test_attention_pool_matches_jax(rng):
    """The pool alone, at RN50x4's head width (64) with 3 heads."""
    x = rng.standard_normal((2, 3, 3, 192)).astype(np.float32)
    jmod = jclip.AttentionPool2d(3, 40)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    tmod = tclip.AttentionPool2d(3, 192, 3, 40)
    p = params["params"]
    sd = {"positional_embedding": torch.from_numpy(
        np.array(p["positional_embedding"]))}
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        sd[f"{name}.weight"] = torch.from_numpy(np.array(p[name]["kernel"]).T)
        sd[f"{name}.bias"] = torch.from_numpy(np.array(p[name]["bias"]))
    tmod.load_state_dict(sd)
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_rn50x4_names_and_shapes_are_openais():
    """RN50x4 on the meta device: OpenAI's parameter and buffer names with
    the released shapes, 40 pool heads, and a 640-wide bank."""
    with torch.device("meta"):
        backbone = ClipCIR("RN50x4")
    sd = backbone.model.state_dict()
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    assert shapes["visual.conv1.weight"] == (40, 3, 3, 3)
    assert shapes["visual.conv3.weight"] == (80, 40, 3, 3)
    assert shapes["visual.bn3.running_var"] == (80,)
    assert shapes["visual.bn1.num_batches_tracked"] == ()
    assert shapes["visual.layer1.0.downsample.0.weight"] == (320, 80, 1, 1)
    assert shapes["visual.layer1.0.downsample.1.running_mean"] == (320,)
    assert "visual.layer1.1.downsample.0.weight" not in shapes
    assert shapes["visual.layer4.5.conv3.weight"] == (2560, 640, 1, 1)
    assert shapes["visual.attnpool.positional_embedding"] == (82, 2560)
    assert shapes["visual.attnpool.c_proj.weight"] == (640, 2560)
    assert shapes["visual.attnpool.q_proj.bias"] == (2560,)
    assert shapes["transformer.resblocks.11.attn.in_proj_weight"] == (1920, 640)
    assert shapes["text_projection"] == (640, 640)
    blocks = [sum(1 for k in shapes
                  if k.startswith(f"visual.layer{s}.") and k.endswith(
                      ".conv1.weight")) for s in (1, 2, 3, 4)]
    assert blocks == [4, 6, 10, 6]
    assert backbone.model.visual.attnpool.num_heads == 40
    assert backbone.bank_spec().target_shape == (640,)
    assert backbone.input_dim == 288
    n_params = sum(v.numel() for k, v in sd.items()
                   if not k.endswith(("running_mean", "running_var",
                                      "num_batches_tracked")))
    assert n_params == 178_300_601      # OpenAI's RN50x4 parameter count


def test_init_weights_fills_a_resnet_model():
    cfg = tclip.CLIPConfig(**RN)
    model = tclip.CLIP(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        assert torch.isfinite(p).all(), name
    assert torch.equal(model.visual.bn1.weight, torch.ones(4))
    assert torch.equal(model.visual.bn1.running_var, torch.ones(4))
    assert model.visual.layer2[0].conv2.weight.std() > 0
    with torch.inference_mode():
        out = model.encode_image(torch.randn(2, 64, 64, 3))
    assert torch.isfinite(out).all() and out.std() > 0
