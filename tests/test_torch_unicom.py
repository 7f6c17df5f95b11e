"""The port's Unicom ViT (models/unicom.py) against the JAX package's.

Weights: the JAX `UnicomViT` initialises them from a seed and
`unicom_state_dict_from_jax` carries them into the port's timm names, the
BatchNorm running statistics redrawn away from (0, 1) so that the head's
inference-mode normalisation is exercised. Images are numpy arrays from a
seed, handed to both sides. At `tiny` (28 px, patch 14: 4 tokens) the
port's attention wrapper routes S = 4 to the short kernel's plain version
on the CPU; the float32 attention and head agree with the JAX einsum path
to 1e-5 (summation order only).

`vit_l14` is held by its parameter count against the JAX tree's abstract
shapes (no forward: its head alone is 268 M parameters), and a
reference-named (`module.`-prefixed, half-precision) state dict loads
strictly through `load_unicom_checkpoint`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.models import unicom as ju
from spn4cir_tpu_torch.models import layers
from spn4cir_tpu_torch.models import unicom as tu
from spn4cir_tpu_torch.models.convert import (load_unicom_checkpoint,
                                              unicom_state_dict_from_jax)

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
_CACHE = {}


def _jax_params(seed=0):
    """The JAX tiny tree with its BatchNorm statistics redrawn; built once
    per seed (read only)."""
    if seed not in _CACHE:
        _CACHE[seed] = _draw_jax_params(seed)
    return _CACHE[seed]


def _draw_jax_params(seed):
    model = ju.UnicomViT(ju.UnicomConfig.tiny())
    params = jax.device_get(model.init(jax.random.PRNGKey(seed),
                                       jnp.zeros((1, 28, 28, 3))))
    rng = np.random.RandomState(seed + 100)
    for bn in ("feature_bn1", "feature_bn2"):
        node = params["params"][bn]
        n = node["mean"].shape[0]
        node["mean"] = rng.randn(n).astype(np.float32) * 0.1
        node["var"] = rng.rand(n).astype(np.float32) + 0.5
        node["scale"] = rng.rand(n).astype(np.float32) + 0.5
        node["bias"] = rng.randn(n).astype(np.float32) * 0.1
    return model, params


def _port(params):
    model = tu.UnicomViT(tu.UnicomConfig.tiny())
    model.load_state_dict(unicom_state_dict_from_jax(params, model.cfg))
    return model.eval()


@pytest.mark.parametrize("seed", [0, 1])
def test_tiny_matches_jax(seed):
    jmodel, params = _jax_params(seed)
    imgs = np.random.RandomState(seed).rand(3, 28, 28, 3).astype(np.float32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(imgs)))
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(imgs))
    assert got.shape == (3, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_state_dict_names_are_the_reference_checkpoints():
    _, params = _jax_params()
    sd = unicom_state_dict_from_jax(params)
    model = tu.UnicomViT(tu.UnicomConfig.tiny())
    assert set(sd) == set(model.state_dict())
    assert "blocks.1.attn.qkv.weight" in sd
    assert "blocks.0.attn.qkv.bias" not in sd           # qkv has no bias
    assert sd["pos_embed"].shape == (1, 4, 32)          # no class token
    assert sd["feature.0.weight"].shape == (32, 4 * 32)
    assert sd["feature.1.running_var"].shape == (32,)


def test_depth_mismatch_raises():
    _, params = _jax_params()
    with pytest.raises(ValueError, match="blocks"):
        unicom_state_dict_from_jax(
            params, tu.UnicomConfig(input_size=28, patch_size=14, dim=32,
                                    embedding_size=16, depth=3, num_heads=2))


def test_vit_l14_parameter_count_equals_the_jax_trees():
    shapes = jax.eval_shape(
        lambda: ju.UnicomViT(ju.UnicomConfig.vit_l14()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        model = tu.UnicomViT(tu.UnicomConfig.vit_l14())
    got = sum(v.numel() for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked"))
    assert got == want == 572_332_032
    assert model.feature[0].weight.shape == (1024, 256 * 1024)


def test_reference_checkpoint_loads_strictly(tmp_path):
    """A DDP half-precision save under the reference's names (`module.`
    prefix, BatchNorm step counts) loads strictly, in float32."""
    _, params = _jax_params()
    sd = unicom_state_dict_from_jax(params)
    path = str(tmp_path / "FP16-ViT-tiny.pt")
    torch.save({f"module.{k}": (v.half() if v.is_floating_point() else v)
                for k, v in sd.items()}, path)
    loaded = load_unicom_checkpoint(path)
    model = tu.UnicomViT(tu.UnicomConfig.tiny())
    model.load_state_dict(loaded)              # strict
    assert loaded["pos_embed"].dtype == torch.float32
    assert loaded["feature.1.num_batches_tracked"].dtype == torch.int64
    torch.testing.assert_close(model.pos_embed.data,
                               sd["pos_embed"].half().float())


def test_bf16_tower_keeps_float32_attention(monkeypatch):
    """Built in bf16, the blocks hand the attention core float32 q, k, v:
    a bf16 Unicom never reaches the bf16 attention route."""
    _, params = _jax_params()
    model = tu.UnicomViT(tu.UnicomConfig.tiny(), dtype=torch.bfloat16)
    model.load_state_dict(unicom_state_dict_from_jax(params))
    seen = []
    attend = layers.SelfAttention.attend

    def spy(self, qkv, mask=None):
        seen.append(qkv.dtype)
        return attend(self, qkv, mask)

    monkeypatch.setattr(layers.SelfAttention, "attend", spy)
    imgs = torch.from_numpy(np.random.RandomState(3).rand(2, 28, 28, 3)
                            .astype(np.float32))
    with torch.no_grad():
        out = model(imgs)
    assert seen == [torch.float32] * 2
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_init_weights_draws_a_finite_unit_head():
    model = tu.UnicomViT(tu.UnicomConfig.tiny())
    model.init_weights(torch.Generator().manual_seed(0))
    assert torch.equal(model.feature[1].weight, torch.ones(32))
    assert torch.equal(model.feature[1].running_var, torch.ones(32))
    with torch.no_grad():
        out = model.eval()(torch.rand(2, 28, 28, 3))
    assert out.shape == (2, 16) and torch.isfinite(out).all()
