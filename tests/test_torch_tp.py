"""Tensor parallelism of the port (`parallel/tp.py`) on the CPU: the towers
and the LLaMA / LLaVA decoders cut over two gloo ranks
(`torch_dist.DistPool`, each task under a 120 s watchdog) against one
process, and the CLIP encode against the JAX package.

Both sides start from the same weights (the JAX CLIP parameters through
`models/convert.py`; the port's own random weights for the EVA and MED
towers and the decoders). Held: the encodes in float32 within 1e-5 (the
row-parallel projections sum two partial products over the ranks), the
greedy tokens of the dense and int8 LLaMA, the tiny rewriter and the tiny
LLaVA captioner identical, the weights really split, blocks whose heads do
not divide the model size left whole, and the gathered state dict equal to
the one the ranks started from. Mirrors `tests/test_tp.py:26-256`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.models.api import build_backbone as jax_build_backbone
from spn4cir_tpu_torch.models import convert
from spn4cir_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                            llama_generate,
                                            quantize_llama_weights)
from torch_dist import Pools
import torch_dist_workers as W

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def pool():
    p = Pools()
    yield p(2)
    p.close()


@pytest.fixture(scope="module")
def clip_world():
    jb = jax_build_backbone("clip", clip_model_name="test-tiny")
    params = jax.jit(jb.init_params)(jax.random.PRNGKey(0))
    tb = W.build("clip")
    sd = {k: v.numpy() for k, v in
          convert.clip_state_dict_from_train_state(params, tb.cfg).items()}
    rng = np.random.RandomState(0)
    s = tb.input_dim
    inputs = {"images": rng.randn(4, s, s, 3).astype(np.float32),
              "text_ids": tb.tokenize(["a red dress", "make it blue",
                                       "longer", "a hat"])}
    return jb, params, sd, inputs


def _random_state(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return {k: v.numpy().copy() for k, v in module.state_dict().items()}


def test_tp_clip_encode_matches_one_process_and_jax(pool, clip_world):
    jb, params, sd, inputs = clip_world
    outs = pool.run("torch_dist_workers:tp_encode", "clip", sd, inputs)
    tb = W.build("clip", sd)
    with torch.no_grad():
        image = tb.gallery_features(torch.from_numpy(inputs["images"]))
        text = tb.encode_text(torch.from_numpy(inputs["text_ids"]))
    want_image = np.asarray(jb.gallery_features(
        params, jnp.asarray(inputs["images"])))
    for o in outs:
        np.testing.assert_allclose(o["out"]["image"], image.numpy(), **TOL)
        np.testing.assert_allclose(o["out"]["text"], text.numpy(), **TOL)
        np.testing.assert_allclose(o["out"]["image"], want_image, atol=1e-5,
                                   rtol=1e-4)
        assert o["full_state_gap"] == 0.0


@pytest.mark.parametrize("shape", [(1, 1, 2), (2, 1, 1)])
def test_extract_index_features_over_a_mesh(pool, clip_world, tmp_path,
                                            shape):
    """The gallery encode of every mesh entry point: at model 2 the towers
    run tensor-parallel for the pass and come out whole (the same
    parameters, nothing left to all-reduce, so rank 0 can go on alone, as
    `cli.serve` and `cli.validate_case` do); at data 2 each rank decodes
    half of every batch. The index is the single process's."""
    from spn4cir_tpu_torch.data.datasets import CIRDataset
    from spn4cir_tpu_torch.data.transforms import ImageTransform
    from spn4cir_tpu_torch.eval.retrieval import extract_index_features
    from tests.fixtures import make_cirr

    _, _, sd, _ = clip_world
    root = make_cirr(str(tmp_path / "cirr"), n_images=10, extended=False)
    outs = pool.run("torch_dist_workers:tp_index", shape, sd, root)
    tb = W.build("clip", sd).eval()
    ds = CIRDataset("cirr", "val", "classic",
                    ImageTransform("targetpad", tb.input_dim, 1.25), root)
    want = extract_index_features(tb, ds, 4, num_workers=0)
    with torch.no_grad():
        alone = tb.gallery_features(torch.from_numpy(
            np.random.RandomState(0).randn(
                2, tb.input_dim, tb.input_dim, 3).astype(np.float32)))
    cut = {"ColumnParallel", "RowParallel"} <= set(outs[0]["ran"])
    assert cut == (shape[2] == 2), outs[0]["ran"]
    for o in outs:
        np.testing.assert_allclose(o["target"], want.target.numpy(), **TOL)
        np.testing.assert_allclose(o["refer"], want.refer, **TOL)
        assert o["whole"]
    np.testing.assert_array_equal(outs[0]["alone"], alone.numpy())


def test_tp_params_actually_sharded(pool, clip_world):
    """Every attention and MLP matrix holds half its rows (column-parallel)
    or half its columns (row-parallel) on each rank; the rest stays whole.
    test-tiny's ViT has one head of 64, which does not divide 2: its
    attention stays whole on both ranks and only its MLP is cut."""
    _, _, sd, inputs = clip_world
    o = pool.run("torch_dist_workers:tp_encode", "clip", sd, inputs)[0]
    sizes, sliced = o["sizes"], set(o["sliced"])
    for name, shape in sizes.items():
        full = sd[name.removeprefix("model.")].shape
        if name.startswith("model.visual.") and ".attn." in name:
            assert shape == full and name not in sliced, name
        elif name.endswith(("attn.in_proj_weight", "mlp.c_fc.weight")):
            assert shape == (full[0] // 2, full[1]), name
        elif name.endswith(("attn.out_proj.weight", "mlp.c_proj.weight")):
            assert shape == (full[0], full[1] // 2), name
        elif name.endswith(("attn.in_proj_bias", "mlp.c_fc.bias")):
            assert shape == (full[0] // 2,), name
        else:
            assert shape == full, name
            assert name not in sliced, name
    # 6 tensors x 2 text layers, the MLP's 3 x 2 vision layers
    assert len(sliced) == 6 * 2 + 3 * 2


@pytest.mark.parametrize("kind", ["eva", "med", "med3"])
def test_tp_tower_matches_one_process(pool, kind, rng):
    """EVA ViT (fused qkv without its key bias, q_bias / v_bias cut by
    heads) and MED with cross-attention; med3's 3 heads do not divide 2,
    so its attention stays whole and only its FFN is cut."""
    module = W.tower(kind)
    sd = _random_state(module, 3)
    if kind == "eva":
        inputs = {"images": rng.randn(2, 28, 28, 3).astype(np.float32)}
        with torch.no_grad():
            want = module(torch.from_numpy(inputs["images"]))
    else:
        inputs = {"ids": rng.randint(0, 100, (2, 7)),
                  "enc": rng.randn(2, 5, 32).astype(np.float32)}
        with torch.no_grad():
            want = module(torch.from_numpy(inputs["ids"]),
                          encoder_hidden_states=torch.from_numpy(
                              inputs["enc"]))
    outs = pool.run("torch_dist_workers:tp_encode", kind, sd, inputs)
    for o in outs:
        got = next(iter(o["out"].values()))
        np.testing.assert_allclose(got, want.numpy(), **TOL)
        assert o["full_state_gap"] == 0.0
    sliced = outs[0]["sliced"]
    if kind == "med3":
        assert sliced and not any("attention" in n for n in sliced), sliced
        assert all(".intermediate." in n or ".output.dense." in n
                   for n in sliced), sliced
    else:
        assert any("attention" in n or "attn" in n for n in sliced)


@pytest.fixture(scope="module")
def tiny_llama():
    cfg = LlamaConfig.tiny()
    lm = LlamaForCausalLM(cfg)
    lm.init_weights(torch.Generator().manual_seed(0))
    return cfg, lm, {k: v.numpy().copy() for k, v in lm.state_dict().items()}


@pytest.mark.parametrize("quant", [False, True])
def test_tp_llama_generate_matches_one_process(pool, tiny_llama, quant, rng):
    """Greedy tokens of a left-padded ragged batch; the local geometry
    holds half the heads, kv heads and FFN at the model's head_dim; q/k/v
    and gate/up are column slices, o/down row slices SUMmed over the ranks,
    lm_head a column slice gathered to the full vocabulary."""
    cfg, lm, sd = tiny_llama
    emb = rng.randn(2, 6, cfg.hidden_size).astype(np.float32)
    mask = np.ones((2, 6), np.int64)
    mask[1, :2] = 0
    params = quantize_llama_weights(lm) if quant else lm
    want = llama_generate(params, cfg, torch.from_numpy(emb), eos_id=1,
                          pad_id=1, max_new_tokens=8,
                          attention_mask=torch.from_numpy(mask)).numpy()
    outs = pool.run("torch_dist_workers:tp_generate", {}, sd, emb, quant, 8,
                    mask)
    for o in outs:
        np.testing.assert_array_equal(o["tokens"], want)
        assert o["cfg"] == (cfg.num_heads // 2, cfg.kv_heads // 2,
                            cfg.intermediate_size // 2, cfg.head_dim)
    shapes = outs[0]["shapes"]
    q = "model.layers.0.self_attn.q_proj.weight"
    o_ = "model.layers.0.self_attn.o_proj.weight"
    d, hq = cfg.hidden_size, cfg.num_heads * cfg.head_dim // 2
    if quant:  # QuantKernel values (in, out)
        assert shapes[q] == (d, hq) and shapes[o_] == ("combined", hq, d)
    else:      # HF (out, in)
        assert shapes[q] == (hq, d) and shapes[o_] == ("combined", d, hq)
    assert shapes["lm_head.weight"][0] == "combined"


def test_tp_rewriter_matches_one_process(pool):
    pairs = [("a red dress", "a blue dress"), ("a cat", "two dogs"),
             ("shirt", "a long shirt")]
    outs = pool.run("torch_dist_workers:tp_rewrite", pairs, 2)
    want = W.tp_rewrite(0, 1, pairs, 2)
    assert outs[0] == outs[1] == want


def test_tp_llava_captioner_matches_one_process(pool, rng):
    images = rng.randn(2, 28, 28, 3).astype(np.float32)
    outs = pool.run("torch_dist_workers:tp_caption", images)
    want = W.tp_caption(0, 1, images)
    assert outs[0] == outs[1] == want
