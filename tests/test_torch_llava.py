"""The port's LLaVA-v1 captioner (models/llava.py) against the JAX package's.

Weights: the JAX `LlavaModule` initialises them from a seed and
`llava_state_dict_from_jax` carries them into the port's
`LlavaLlamaForCausalLM` (HF names). Images are numpy arrays from a seed,
handed to both sides. The JAX decode steps run its einsum path at these
head dims (its Pallas kernel needs lane-wide heads); the port's wrappers
take their plain versions on CPU tensors.

Config: `LlavaConfig.tiny` over the byte tokenizer's 258 ids (tower 3
blocks of width 32 at 28 px, so 2 effective blocks and 4 patches; LM 2
layers of width 32).

Tolerances: the tower's feature tap 1e-5 (float32); the multimodal logits
1e-4 (two towers and two LM layers of float32 in another order); token ids
and the prompt layout identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.models import llama as jl
from spn4cir_tpu.models import llava as jv
from spn4cir_tpu_torch.models import llama as tl
from spn4cir_tpu_torch.models import llava as tv
from spn4cir_tpu_torch.models.convert import (LLAVA_TOWER,
                                              LLAVA_TOWER_PREFIXES,
                                              llava_state_dict_from_jax,
                                              load_llava_checkpoint)
from spn4cir_tpu_torch.tokenizer.bytelevel import ByteTokenizer

torch.set_num_threads(1)

TOK = ByteTokenizer()
PROMPT = "please briefly describe the image in 10 words"
_CACHE = {}


def _pair(seed=0):
    """(JAX captioner, its params, port captioner), the port's weights
    carried from the JAX tree; built once per seed."""
    if seed not in _CACHE:
        jcap = jv.LlavaCaptioner(jv.LlavaConfig.tiny(TOK.vocab_size), TOK)
        params = jax.device_get(jcap.init_params(jax.random.PRNGKey(seed)))
        cap = tv.LlavaCaptioner(tv.LlavaConfig.tiny(TOK.vocab_size), TOK)
        cap.model.load_state_dict(llava_state_dict_from_jax(params, cap.cfg))
        _CACHE[seed] = (jcap, params, cap)
    return _CACHE[seed]


def _images(seed, b=2):
    return np.random.RandomState(seed).rand(b, 28, 28, 3).astype(np.float32)


def test_state_dict_covers_every_parameter():
    _, params, cap = _pair()
    sd = llava_state_dict_from_jax(params, cap.cfg)
    assert set(sd) == {n for n, _ in cap.model.named_parameters()}
    tower = "model.vision_tower.vision_tower.vision_model.encoder.layers."
    assert {k.split(".")[6] for k in sd if k.startswith(tower)} == {"0", "1"}


def test_tower_feature_tap_matches_jax():
    _, params, cap = _pair()
    imgs = _images(1)
    want = jv.LlavaVisionTower(jv.LlavaVisionConfig.tiny()).apply(
        {"params": params["params"]["vision_tower"]}, jnp.asarray(imgs))
    with torch.no_grad():
        got = cap.model.model.vision_tower.vision_tower.vision_model(
            torch.from_numpy(imgs))
    assert got.shape == (2, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_multimodal_logits_match_jax():
    jcap, params, cap = _pair()
    imgs = _images(2)
    ids = [TOK.bos_token_id, 5, 7, jv.IMAGE_TOKEN_INDEX, 9, 11]
    mod = jv.LlavaModule(jcap.cfg)
    feats = mod.apply(params, jnp.asarray(imgs),
                      method=jv.LlavaModule.encode_images)
    embeds = jv.splice_image_embeds(
        params["params"]["language_model"]["embed_tokens"], ids, feats)
    want = mod.apply(params, embeds, method=jv.LlavaModule.lm_logits)
    with torch.no_grad():
        tfeats = cap.model.encode_images(torch.from_numpy(imgs))
        tembeds = tv.splice_image_embeds(
            cap.model.model.embed_tokens.weight, ids, tfeats)
        got = cap.model(inputs_embeds=tembeds)
    np.testing.assert_allclose(tfeats.numpy(), np.asarray(feats), atol=1e-5,
                               rtol=1e-5)
    assert got.shape == (2, 3 + 4 + 2, TOK.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("prompt", ["ab<image>cd", "ab", "<image>x",
                                    jv.build_llava_v1_prompt(PROMPT)])
def test_prompt_and_image_token_match_jax(prompt):
    assert tv.build_llava_v1_prompt(PROMPT) == jv.build_llava_v1_prompt(PROMPT)
    assert (tv.tokenizer_image_token(prompt, TOK.encode, TOK.bos_token_id)
            == jv.tokenizer_image_token(prompt, TOK.encode,
                                        TOK.bos_token_id))


def test_caption_prompt_is_227_byte_ids_and_one_image_token():
    _, _, cap = _pair()
    ids = cap.prompt_ids(PROMPT)
    assert ids.count(tv.IMAGE_TOKEN_INDEX) == 1 and len(ids) == 228
    assert ids[0] == TOK.bos_token_id


@pytest.mark.parametrize("quant", [False, True])
def test_splice_layout_matches_jax(quant):
    table = np.random.RandomState(0).randn(10, 4).astype(np.float32)
    feats = np.random.RandomState(1).randn(3, 5, 4).astype(np.float32)
    ids = [1, 2, tv.IMAGE_TOKEN_INDEX, 3]
    jtable, ttable = table, torch.from_numpy(table)
    if quant:
        ttable = tl._quant_table(ttable)
        jtable = jl.QuantKernel(jnp.asarray(ttable.values.numpy()),
                                jnp.asarray(ttable.scales.numpy()))
    want = np.asarray(jv.splice_image_embeds(jtable, ids, jnp.asarray(feats)))
    got = tv.splice_image_embeds(ttable, ids, torch.from_numpy(feats))
    assert got.shape == (3, 2 + 5 + 1, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(got[:, 2:7].numpy(), feats)


def _jax_ids(jcap, params, imgs, cache, max_new):
    """The JAX captioner's generated ids (its caption path without the
    decode to text)."""
    ids = jcap.prompt_ids(PROMPT)
    mod = jv.LlavaModule(jcap.cfg)
    feats = mod.apply(params, jnp.asarray(imgs),
                      method=jv.LlavaModule.encode_images)
    lm = params["params"]["language_model"]
    embeds = jv.splice_image_embeds(lm["embed_tokens"], ids, feats)
    return np.asarray(jl.llama_generate(
        lm, jcap.cfg.llama, embeds, eos_id=TOK.eos_token_id,
        pad_id=TOK.eos_token_id, max_new_tokens=max_new, do_sample=True,
        temperature=0.01, top_p=0.01, rng=jax.random.PRNGKey(0),
        cache_dtype=cache))


def _port_ids(cap, imgs, cache, max_new):
    with torch.inference_mode():
        feats = cap.model.encode_images(torch.from_numpy(imgs))
        embeds = tv.splice_image_embeds(
            tl._flat(cap.lm_params)["model.embed_tokens.weight"],
            cap.prompt_ids(PROMPT), feats)
        return tl.llama_generate(
            cap.lm_params, cap.cfg.llama, embeds, eos_id=TOK.eos_token_id,
            pad_id=TOK.eos_token_id, max_new_tokens=max_new, do_sample=True,
            temperature=0.01, top_p=0.01, cache_dtype=cache).numpy()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_caption_tokens_match_jax(seed, cache):
    jcap, params, cap = _pair(seed)
    imgs = _images(10 + seed)
    want = _jax_ids(jcap, params, imgs, getattr(jnp, cache), 10)
    got = _port_ids(cap, imgs, getattr(torch, cache), 10)
    np.testing.assert_array_equal(got, want)
    # and the caption strings, decoded and stripped, of the whole path
    jcaps = jcap.caption(params, jnp.asarray(imgs), PROMPT,
                         max_new_tokens=10, cache_dtype=getattr(jnp, cache))
    caps = cap.caption(imgs, PROMPT, max_new_tokens=10,
                       cache_dtype=getattr(torch, cache))
    assert caps == jcaps


def test_tiny_caption_cache_defaults_to_float32(monkeypatch):
    _, _, cap = _pair()
    seen = {}
    real = tl.init_llama_state

    def spy(cfg, batch, length, dtype=torch.float32, device=None):
        seen["dtype"], seen["length"] = dtype, length
        return real(cfg, batch, length, dtype=dtype, device=device)

    monkeypatch.setattr(tl, "init_llama_state", spy)
    cap.caption(_images(3), PROMPT, max_new_tokens=4)
    # 227 prompt ids + 4 patches + 4 new tokens
    assert seen == {"dtype": torch.float32, "length": 227 + 4 + 4}


def _hf_llava_state_dict(cap, prefix):
    """A synthetic HF LlavaLlamaForCausalLM state dict at the tiny geometry
    from a seed: the tower under `prefix` with all 3 of its blocks, its
    post_layernorm and position_ids, and the LM's rotary buffers."""
    rng = np.random.RandomState(0)
    sd = {}
    for k, v in cap.model.state_dict().items():
        if k.startswith(LLAVA_TOWER):
            k = prefix + k[len(LLAVA_TOWER):]
        sd[k] = torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
    block = f"{prefix}encoder.layers.1."
    for k in [k for k in sd if k.startswith(block)]:
        sd[k.replace(".layers.1.", ".layers.2.")] = sd[k] + 1.0
    sd[prefix + "post_layernorm.weight"] = torch.ones(32)
    sd[prefix + "embeddings.position_ids"] = torch.arange(5)[None]
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(4)
    return sd


@pytest.mark.parametrize("prefix", LLAVA_TOWER_PREFIXES)
def test_checkpoint_loader_matches_jax_converter(prefix, tmp_path):
    from spn4cir_tpu.models.convert import convert_llava_state_dict

    _, _, cap = _pair()
    sd = _hf_llava_state_dict(cap, prefix)
    path = str(tmp_path / "llava.pt")
    torch.save({"state_dict": sd}, path)
    got = load_llava_checkpoint(path, cap.cfg)
    want = llava_state_dict_from_jax(convert_llava_state_dict(
        sd, cap.cfg.llama.num_layers, cap.cfg.vision.effective_layers),
        cap.cfg)
    assert set(got) == set(want) == set(cap.model.state_dict())
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-6, err_msg=k)
    with pytest.raises(ValueError):
        load_llava_checkpoint(path, tv.LlavaConfig(
            llama=tl.LlamaConfig.tiny(num_layers=3), vision=cap.cfg.vision))
