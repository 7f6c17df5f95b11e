"""The port's MED text decoder (models/med.py `BertLMHeadModel`) and its
generation loops (models/generation.py) against the JAX package's
`MedLMModel` and `spn4cir_tpu/models/generation.py`.

Weights: the JAX `MedLMModel` gives the tree's structure; every leaf is
then drawn from a numpy seed at scale 0.12 (as the JAX package's own
decoder tests do: at 0.02 the post-LN logits are nearly input-independent
and the generation oracles would compare near-ties), and
`med_lm_state_dict` carries the tree into the port. Encoder states and
prompts are numpy arrays from a seed.

Config: `MedConfig.tiny(64)` (hidden 32, 2 layers, 2 heads) over 5 image
tokens of width 32.

Tolerances: teacher-forced logits and the cached decode 1e-5 (float32 in
another order); greedy and beam token ids identical, a forced score tie
included; nucleus sampling by its filter's properties (the two packages'
random streams differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.models import generation as jg
from spn4cir_tpu.models.med import MedConfig as JaxMedConfig
from spn4cir_tpu.models.med import MedLMModel
from spn4cir_tpu_torch.models import generation as tg
from spn4cir_tpu_torch.models.convert import med_lm_state_dict
from spn4cir_tpu_torch.models.med import BertLMHeadModel, MedConfig

torch.set_num_threads(1)

F32 = dict(atol=1e-5, rtol=1e-5)
EOS, PAD = 3, 0
PROMPT = np.array([[2, 11, 12], [2, 14, 15]], np.int64)


def _redraw(tree, seed, scale=0.12):
    """Every leaf of `tree` replaced by normal(0, scale) numpy draws."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (rng.randn(*np.shape(x)) * scale).astype(np.float32), tree)


_CACHE = {}


def _lm(tie=False):
    """(JAX params, port BertLMHeadModel) of MedConfig.tiny(64). With `tie`,
    vocabulary rows 5 and 6 of the head are the same vector with a +4
    bias, so their logits are equal and lead: the tie order is tested."""
    if tie not in _CACHE:
        cfg = JaxMedConfig.tiny(vocab_size=64)
        tree = MedLMModel(cfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
            jnp.ones((1, 4), jnp.int32), jnp.zeros((1, 5, 32)),
            jnp.ones((1, 5), jnp.int32))["params"]
        params = _redraw(jax.device_get(tree), 0)
        if tie:
            dec = params["lm_head"]["decoder"]
            dec["kernel"][:, 6] = dec["kernel"][:, 5]
            dec["bias"][5] = dec["bias"][6] = 4.0
        model = BertLMHeadModel(MedConfig.tiny(vocab_size=64))
        model.load_state_dict(med_lm_state_dict(params, prefix=""))
        _CACHE[tie] = (jax.tree_util.tree_map(jnp.asarray, params),
                       model.eval())
    return _CACHE[tie]


def _enc(seed, b=2):
    return np.random.RandomState(seed).randn(b, 5, 32).astype(np.float32)


def test_lm_state_dict_covers_every_parameter():
    params, model = _lm()
    sd = med_lm_state_dict(params, prefix="")
    assert set(sd) == set(model.state_dict())


def test_teacher_forced_logits_match_jax():
    params, model = _lm()
    ids = np.random.RandomState(1).randint(1, 60, (2, 7))
    enc = _enc(2)
    mask = np.ones((2, 7), np.int64)
    want = MedLMModel(JaxMedConfig.tiny(vocab_size=64)).apply(
        {"params": params}, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
        jnp.asarray(enc), jnp.ones((2, 5), jnp.int32))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    torch.from_numpy(enc), torch.ones(2, 5, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_cached_decode_matches_full_forward_and_jax():
    params, model = _lm()
    cfg = MedConfig.tiny(vocab_size=64)
    ids = np.random.RandomState(3).randint(1, 60, (2, 6))
    enc = _enc(4)
    with torch.no_grad():
        full = model(torch.from_numpy(ids), None, torch.from_numpy(enc))
    state = tg.init_decode_state(model, cfg, torch.from_numpy(enc), 6)
    jstate = jg.init_decode_state(params, JaxMedConfig.tiny(vocab_size=64),
                                  jnp.asarray(enc), 6)
    for t in range(6):
        got, state = tg.decode_step(model, cfg, state,
                                    torch.from_numpy(ids[:, t]), t)
        want, jstate = jg.decode_step(params, JaxMedConfig.tiny(64), jstate,
                                      jnp.asarray(ids[:, t], jnp.int32),
                                      jnp.int32(t))
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(), **F32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(state.self_k.numpy(), np.asarray(jstate.self_k),
                               **F32)


def test_repetition_penalty_and_min_length_match_jax():
    logits = np.array([[2.0, -1.0, 0.5, 3.0]], np.float32)
    tokens = np.array([[0, 1, 1, 3]])
    valid = np.array([[True, True, True, False]])
    got = tg.apply_repetition_penalty(torch.from_numpy(logits),
                                      torch.from_numpy(tokens),
                                      torch.from_numpy(valid), 2.0)
    np.testing.assert_allclose(got.numpy()[0], [1.0, -2.0, 0.5, 3.0])
    want = jg.apply_repetition_penalty(jnp.asarray(logits),
                                       jnp.asarray(tokens),
                                       jnp.asarray(valid), 2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for cur in (2, 4, 5):
        got = tg.suppress_eos(torch.from_numpy(logits), 1, cur, 4)
        want = jg.suppress_eos(jnp.asarray(logits), 1, cur, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jgen(params, enc, **kw):
    return np.asarray(jg.generate(
        params, JaxMedConfig.tiny(vocab_size=64), jnp.asarray(enc),
        jnp.asarray(PROMPT, jnp.int32), eos_id=EOS, pad_id=PAD,
        enc_mask=jnp.ones((2, 5), jnp.int32), **kw))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("rep,min_len", [(1.0, 5), (1.3, 5), (1.0, 11)])
def test_greedy_ids_match_jax(seed, rep, min_len):
    params, model = _lm()
    enc = _enc(100 + seed)
    kw = dict(max_length=12, min_length=min_len, repetition_penalty=rep)
    want = _jgen(params, enc, **kw)
    got = tg.generate(model, MedConfig.tiny(vocab_size=64),
                      torch.from_numpy(enc), torch.from_numpy(PROMPT),
                      eos_id=EOS, pad_id=PAD,
                      enc_mask=torch.ones(2, 5, dtype=torch.long), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("rep", [1.0, 1.3])
def test_beam_ids_match_jax(seed, rep):
    params, model = _lm()
    enc = _enc(200 + seed)
    kw = dict(num_beams=3, max_length=12, min_length=5,
              repetition_penalty=rep)
    want = np.asarray(jg.beam_generate(
        params, JaxMedConfig.tiny(vocab_size=64), jnp.asarray(enc),
        jnp.asarray(PROMPT, jnp.int32), eos_id=EOS, pad_id=PAD,
        enc_mask=jnp.ones((2, 5), jnp.int32), **kw))
    got = tg.beam_generate(model, MedConfig.tiny(vocab_size=64),
                           torch.from_numpy(enc), torch.from_numpy(PROMPT),
                           eos_id=EOS, pad_id=PAD,
                           enc_mask=torch.ones(2, 5, dtype=torch.long), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("beams", [1, 3])
def test_tied_scores_come_in_jax_order(beams):
    """Tokens 5 and 6 score exactly alike and lead every step: greedy and
    beam search must resolve the tie as the JAX package does."""
    params, model = _lm(tie=True)
    cfg = MedConfig.tiny(vocab_size=64)
    enc = _enc(7)
    with torch.no_grad():
        logits, _ = tg.decode_step(
            model, cfg, tg.init_decode_state(model, cfg,
                                             torch.from_numpy(enc), 4),
            torch.from_numpy(PROMPT[:, 0]), 0)
    assert torch.equal(logits[:, 5], logits[:, 6])
    kw = dict(max_length=10, min_length=4, repetition_penalty=1.0)
    if beams == 1:
        want = _jgen(params, enc, **kw)
        got = tg.generate(model, cfg, torch.from_numpy(enc),
                          torch.from_numpy(PROMPT), eos_id=EOS, pad_id=PAD,
                          **kw)
    else:
        want = np.asarray(jg.beam_generate(
            params, JaxMedConfig.tiny(vocab_size=64), jnp.asarray(enc),
            jnp.asarray(PROMPT, jnp.int32), eos_id=EOS, pad_id=PAD,
            num_beams=3, **kw))
        got = tg.beam_generate(model, cfg, torch.from_numpy(enc),
                               torch.from_numpy(PROMPT), eos_id=EOS,
                               pad_id=PAD, num_beams=3, **kw)
    assert {5, 6} & set(want[:, 3:].ravel().tolist())
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_p_filter_keeps_the_nucleus():
    rng = np.random.RandomState(3)
    logits = rng.randn(4, 16).astype(np.float32)
    got = tg.top_p_filter(torch.from_numpy(logits), 0.7).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jg.top_p_filter(jnp.asarray(logits), 0.7)))
    for row_in, row_out in zip(logits, got):
        order = np.argsort(-row_in)
        p = np.exp(row_in - row_in.max())
        cum = np.cumsum((p / p.sum())[order])
        keep = set(order[:int(np.searchsorted(cum, 0.7, side="right")) + 1])
        for tok in range(16):
            assert (row_out[tok] == row_in[tok]) if tok in keep else (
                row_out[tok] <= -1e8)
    # a tie straddling the boundary keeps the top token, and nothing below
    tied = torch.cat([torch.full((1, 10), 5.0), torch.full((1, 20), -5.0)], 1)
    kept = tg.top_p_filter(tied, 0.5)[0] > -1e8
    assert kept[:10].any() and not kept[10:].any()
    assert (tg.top_p_filter(torch.zeros(1, 8), 0.3) > -1e8).sum() >= 1


def test_nucleus_sampling_draws_inside_the_filter():
    """Every sampled token lies in the nucleus of its step's processed
    logits; the prompt is kept, and a fixed generator repeats the draw."""
    params, model = _lm()
    cfg = MedConfig.tiny(vocab_size=64)
    enc = torch.from_numpy(_enc(9))
    kw = dict(eos_id=EOS, pad_id=PAD, max_length=10, min_length=3,
              do_sample=True, top_p=0.9, repetition_penalty=1.1)
    out = tg.generate(model, cfg, enc, torch.from_numpy(PROMPT),
                      generator=torch.Generator().manual_seed(7), **kw)
    again = tg.generate(model, cfg, enc, torch.from_numpy(PROMPT),
                        generator=torch.Generator().manual_seed(7), **kw)
    assert torch.equal(out, again) and out.shape == (2, 10)
    assert (out[:, :3].numpy() == PROMPT).all()
    state = tg.init_decode_state(model, cfg, enc, 10)
    for t in range(9):
        logits, state = tg.decode_step(model, cfg, state, out[:, t], t)
        if t + 1 < 3:
            continue
        logits = tg.apply_repetition_penalty(
            logits, out, (torch.arange(10) <= t)[None], 1.1)
        logits = tg.suppress_eos(logits, EOS, t + 1, 3)
        kept = tg.top_p_filter(logits, 0.9) > -1e8
        for r in range(2):
            if t > 0 and (out[r, 3:t + 1] == EOS).any():
                assert out[r, t + 1] == PAD
            else:
                assert kept[r, out[r, t + 1]]


