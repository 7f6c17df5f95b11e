"""The port's LLaMA decoder (models/llama.py) against the JAX package's.

Weights: the JAX `LlamaLM` initialises them from a seed and
`llama_state_dict_from_jax` carries them into the port's
`LlamaForCausalLM` (HF names). Inputs are numpy arrays from a seed, handed
to both sides. Where the JAX function reaches a Pallas kernel
(`attn_kernel` at a lane-tiled geometry, `quant_kernel`), it runs in
interpret mode on this CPU host, as the JAX package's own tests run it; the
port's wrappers take their plain versions on CPU tensors.

Configs: `LlamaConfig.tiny()` (head_dim 8), a GQA variant (2 kv heads for 4
heads) and the JAX kernel gate's geometry (hidden 256, 2 heads of 128).

Tolerances: float32 logits 1e-5; a bf16 cache 2e-2 (one bf16 rounding of
the cached keys and values); an int8 cache 1e-4 (float32 arithmetic on the
same int8 rows; a row whose rounding falls the other way is a test
failure, not noise); greedy token streams identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.models import llama as jl
from spn4cir_tpu.models.convert import convert_llama_state_dict
from spn4cir_tpu_torch.models import llama as tl
from spn4cir_tpu_torch.models.convert import llama_state_dict_from_jax

torch.set_num_threads(1)

CFGS = {
    "tiny": tl.LlamaConfig.tiny(),
    "gqa": tl.LlamaConfig.tiny(num_kv_heads=2),
    "lane": tl.LlamaConfig(vocab_size=96, hidden_size=256, num_layers=2,
                           num_heads=2, intermediate_size=96,
                           max_position_embeddings=256),
}
F32 = dict(atol=1e-5, rtol=1e-5)


def _jcfg(cfg):
    return jl.LlamaConfig(**{f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "num_kv_heads", "intermediate_size", "max_position_embeddings",
        "rope_theta", "rms_eps")})


_CACHE = {}


def _models(name):
    """(torch cfg, JAX cfg, JAX params (numpy), port model), built once."""
    if name not in _CACHE:
        cfg = CFGS[name]
        jcfg = _jcfg(cfg)
        params = jax.device_get(jl.LlamaLM(jcfg).init(
            jax.random.PRNGKey(0),
            input_ids=jnp.zeros((1, 4), jnp.int32))["params"])
        model = tl.LlamaForCausalLM(cfg)
        model.load_state_dict(llama_state_dict_from_jax(params, cfg))
        _CACHE[name] = (cfg, jcfg, params, model.eval())
    return _CACHE[name]


def _emb(seed, b, p, d, mask=None):
    x = np.random.RandomState(seed).randn(b, p, d).astype(np.float32) * 0.1
    return x if mask is None else x * mask[..., None]


def _t(x):
    return torch.from_numpy(np.array(x))


RAGGED = np.array([[0, 0, 0, 1, 1, 1, 1, 1, 1, 1],
                   [1] * 10, [0] * 6 + [1] * 4], np.int32)


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("masked", [False, True])
def test_teacher_forced_logits_match_jax(name, masked):
    cfg, jcfg, params, model = _models(name)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (3, 10))
    mask = RAGGED if masked else None
    want = jl.LlamaLM(jcfg).apply(
        {"params": params}, input_ids=jnp.asarray(ids),
        attention_mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = model(input_ids=_t(ids),
                    attention_mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("name", ["tiny", "gqa"])
@pytest.mark.parametrize("chunk", [None, 3])
def test_prefill_logits_and_cache_match_jax(name, chunk):
    cfg, jcfg, params, model = _models(name)
    emb = _emb(2, 3, 10, cfg.hidden_size, RAGGED)
    am = RAGGED
    positions = np.clip(np.cumsum(am, 1) - 1, 0, None)
    jstate = jl.init_llama_state(jcfg, 3, 14)
    state = tl.init_llama_state(cfg, 3, 14)
    kw = dict(positions=positions, pad_mask=am)
    if chunk:
        want, jstate = jl.llama_prefill_chunked(
            params, jcfg, jstate, jnp.asarray(emb), chunk=chunk,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        got, state = tl.llama_prefill_chunked(
            model, cfg, state, _t(emb), chunk=chunk,
            **{k: _t(v) for k, v in kw.items()})
    else:
        want, jstate = jl.llama_prefill(
            params, jcfg, jstate, jnp.asarray(emb),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        got, state = tl.llama_prefill(model, cfg, state, _t(emb),
                                      **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(state.k.numpy(), np.asarray(jstate.k), **F32)
    np.testing.assert_allclose(state.v.numpy(), np.asarray(jstate.v), **F32)


@pytest.mark.parametrize("cache,tol", [("float32", F32),
                                       ("bfloat16", dict(atol=2e-2, rtol=2e-2)),
                                       ("int8", dict(atol=1e-4, rtol=1e-4))])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("attn_kernel", [False, True])
def test_decode_step_matches_jax(cache, tol, ragged, attn_kernel):
    """A prefill then one decode step at position P, dense or left-padded
    (per-row rope_pos, key_mask): logits and the written cache row."""
    cfg, jcfg, params, model = _models("tiny")
    b, p, length = 3, 10, 13
    am = RAGGED if ragged else np.ones((b, p), np.int32)
    emb = _emb(3, b, p, cfg.hidden_size, am)
    positions = np.clip(np.cumsum(am, 1) - 1, 0, None)
    jstate = jl.init_llama_state(jcfg, b, length, dtype=getattr(jnp, cache))
    state = tl.init_llama_state(cfg, b, length, dtype=getattr(torch, cache))
    _, jstate = jl.llama_prefill(params, jcfg, jstate, jnp.asarray(emb),
                                 positions=jnp.asarray(positions),
                                 pad_mask=jnp.asarray(am))
    _, state = tl.llama_prefill(model, cfg, state, _t(emb),
                                positions=_t(positions), pad_mask=_t(am))
    x = np.random.RandomState(4).randn(b, cfg.hidden_size).astype(
        np.float32) * 0.1
    valid = np.concatenate([am, np.ones((b, length - p), np.int32)], 1)
    rope_pos = am.sum(1) if ragged else None
    jkw = dict(rope_pos=None if rope_pos is None else jnp.asarray(rope_pos),
               key_mask=jnp.asarray(valid) if ragged else None)
    want, jstate = jl.llama_decode_step(params, jcfg, jstate, jnp.asarray(x),
                                        jnp.int32(p), **jkw)
    got, state = tl.llama_decode_step(
        model, cfg, state, _t(x), p, attn_kernel=attn_kernel,
        rope_pos=None if rope_pos is None else _t(rope_pos),
        key_mask=_t(valid) if ragged else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(state.k[:, :, p].float().numpy(),
                               np.asarray(jstate.k[:, :, p], np.float32),
                               **(F32 if cache == "float32" else
                                  dict(atol=1, rtol=0) if cache == "int8"
                                  else tol))


def _generate(name, emb, mask=None, *, params=None, tparams=None,
              jax_kw=None, torch_kw=None, **kw):
    cfg, jcfg, jparams, model = _models(name)
    want = jl.llama_generate(
        jparams if params is None else params, jcfg, jnp.asarray(emb),
        attention_mask=None if mask is None else jnp.asarray(mask),
        **kw, **(jax_kw or {}))
    got = tl.llama_generate(
        model if tparams is None else tparams, cfg, _t(emb),
        attention_mask=None if mask is None else _t(mask), **kw,
        **(torch_kw or {}))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got


@pytest.mark.parametrize("name,ragged,chunk,attn", [
    ("tiny", False, None, True), ("tiny", True, 3, True),
    ("tiny", True, None, False), ("gqa", True, 4, True),
    ("lane", True, 4, True), ("lane", False, None, False)])
def test_greedy_streams_match_jax(name, ragged, chunk, attn):
    cfg = CFGS[name]
    mask = RAGGED if ragged else None
    emb = _emb(5, 3, 10, cfg.hidden_size, mask)
    _generate(name, emb, mask, eos_id=cfg.vocab_size - 1, pad_id=0,
              max_new_tokens=6, prefill_chunk=chunk, attn_kernel=attn)


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_greedy_streams_over_narrow_caches_match_jax(cache):
    cfg = CFGS["tiny"]
    emb = _emb(6, 3, 10, cfg.hidden_size, RAGGED)
    _generate("tiny", emb, RAGGED, eos_id=cfg.vocab_size - 1, pad_id=0,
              max_new_tokens=6, prefill_chunk=4,
              jax_kw=dict(cache_dtype=getattr(jnp, cache)),
              torch_kw=dict(cache_dtype=getattr(torch, cache)))


def test_quantize_llama_weights_matches_jax():
    """Values identical, scales within 1e-7 relative; the JAX int8 tree
    converts to the port's quantized dict."""
    cfg, jcfg, params, model = _models("gqa")
    jq = jax.device_get(jl.quantize_llama_weights(params))
    ours = tl.quantize_llama_weights(model)
    conv = llama_state_dict_from_jax(jq, cfg)
    assert set(ours) == set(conv)
    for name, got in ours.items():
        want = conv[name]
        if isinstance(got, tl.QuantKernel):
            assert got.values.dtype == torch.int8
            assert torch.equal(got.values, want.values), name
            torch.testing.assert_close(got.scales, want.scales, atol=0,
                                       rtol=1e-7)
        else:
            assert torch.equal(got, want), name


@pytest.mark.parametrize("quant_kernel", [False, True])
def test_int8_weight_streams_match_jax(quant_kernel):
    """int8 weights through each route of `_mm` (dequant-after-matmul, and
    kernel #12's module), each against the same JAX route."""
    cfg, jcfg, params, _ = _models("tiny")
    jq = jl.quantize_llama_weights(params)
    tq = llama_state_dict_from_jax(jax.device_get(jq), cfg)
    ids = np.random.RandomState(7).randint(0, cfg.vocab_size, (3, 10))
    emb = np.asarray(jl._embed_rows(jq["embed_tokens"], jnp.asarray(ids)))
    np.testing.assert_array_equal(
        tl.embed_tokens(tq, _t(ids)).numpy(), emb)
    _generate("tiny", emb, RAGGED, params=jq, tparams=tq,
              eos_id=cfg.vocab_size - 1, pad_id=0, max_new_tokens=6,
              quant_kernel=quant_kernel, prefill_chunk=4)


def test_int8_weight_decode_step_logits_match_jax():
    cfg, jcfg, params, _ = _models("tiny")
    jq = jl.quantize_llama_weights(params)
    tq = llama_state_dict_from_jax(jax.device_get(jq), cfg)
    emb = _emb(8, 2, 6, cfg.hidden_size)
    jstate = jl.init_llama_state(jcfg, 2, 8)
    state = tl.init_llama_state(cfg, 2, 8)
    _, jstate = jl.llama_prefill(jq, jcfg, jstate, jnp.asarray(emb))
    _, state = tl.llama_prefill(tq, cfg, state, _t(emb))
    x = _emb(9, 1, 2, cfg.hidden_size)[0]
    for qk in (False, True):
        want, _ = jl.llama_decode_step(jq, jcfg, jstate, jnp.asarray(x),
                                       jnp.int32(6), quant_kernel=qk)
        got, _ = tl.llama_decode_step(tq, cfg, state.clone(), _t(x), 6,
                                      quant_kernel=qk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_state_dict_round_trips_through_the_jax_converter():
    """llama_state_dict_from_jax, then the JAX package's
    convert_llama_state_dict, gives back the JAX tree bit for bit."""
    cfg, _, params, model = _models("gqa")
    sd = llama_state_dict_from_jax(params, cfg)
    assert set(sd) == set(model.state_dict())
    back = convert_llama_state_dict(sd, cfg.num_layers)["params"]
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        other = np.asarray(flat_b[path])
        assert other.dtype == leaf.dtype and np.array_equal(other, leaf), path


def test_load_llama_checkpoint_reads_an_hf_state_dict(tmp_path):
    cfg, _, _, model = _models("tiny")
    sd = dict(model.state_dict())
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(4)
    path = str(tmp_path / "llama.pt")
    torch.save({"state_dict": sd}, path)
    from spn4cir_tpu_torch.models.convert import load_llama_checkpoint

    fresh = tl.LlamaForCausalLM(cfg)
    fresh.load_state_dict(load_llama_checkpoint(path, cfg))
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v)
    with pytest.raises(ValueError, match="3-layer"):
        load_llama_checkpoint(path, tl.LlamaConfig.tiny(num_layers=3))


def test_sampled_streams_repeat_from_a_seed():
    """A seeded generator gives the same sampled stream twice; another seed
    gives another (the JAX package's keys cannot be matched, so sampling is
    held to itself)."""
    cfg, _, _, model = _models("tiny")
    emb = _t(_emb(10, 2, 6, cfg.hidden_size))
    kw = dict(eos_id=cfg.vocab_size - 1, pad_id=0, max_new_tokens=12,
              do_sample=True, top_k=20, top_p=0.9, temperature=1.3)
    a = tl.llama_generate(model, cfg, emb,
                          generator=torch.Generator().manual_seed(3), **kw)
    b = tl.llama_generate(model, cfg, emb,
                          generator=torch.Generator().manual_seed(3), **kw)
    c = tl.llama_generate(model, cfg, emb,
                          generator=torch.Generator().manual_seed(4), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
