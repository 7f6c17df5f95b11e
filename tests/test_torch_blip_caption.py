"""The port's BLIP captioner (models/blip_caption.py) against the JAX
package's, and its checkpoint loader against the JAX converter.

Weights: the JAX `BlipCaptioner` gives the tree's structure; every leaf is
then drawn from a numpy seed at scale 0.12 (as the JAX package's own
decoder tests do: at 0.02 the post-LN logits are nearly input-independent
and generation would compare near-ties), and
`blip_caption_state_dict_from_jax` carries the tree into the port. Images
are numpy arrays from a seed.

Config: `test-tiny` (ViT 32 px, width 32, 2 layers; MED tiny over
`tiny_test_vocab`). The decoder alone is held in test_torch_med_generate.py.

Tolerances: the image tokens 1e-5 (float32 in another order); caption
token ids and strings identical; the loader's tensors 1e-5 (the bicubic
resampling of the position grid in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.models.blip_caption import BlipCaptioner as JaxCaptioner
from spn4cir_tpu.models.convert import convert_blip_caption
from spn4cir_tpu_torch.models.blip_caption import BlipCaptioner
from spn4cir_tpu_torch.models.convert import (blip_caption_state_dict_from_jax,
                                              load_blip_caption_checkpoint)

torch.set_num_threads(1)

F32 = dict(atol=1e-5, rtol=1e-5)


def _redraw(tree, seed, scale=0.12):
    """Every leaf of `tree` replaced by normal(0, scale) numpy draws."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (rng.randn(*np.shape(x)) * scale).astype(np.float32), tree)


@pytest.fixture(scope="module")
def captioners():
    jcap = JaxCaptioner("test-tiny", prompt="a dress with ")
    params = _redraw(jax.device_get(jcap.init_params(jax.random.PRNGKey(0))),
                     1)
    cap = BlipCaptioner("test-tiny", prompt="a dress with ")
    cap.model.load_state_dict(blip_caption_state_dict_from_jax(params))
    return jcap, jax.tree_util.tree_map(jnp.asarray, params), cap


def test_caption_state_dict_covers_every_parameter(captioners):
    _, params, cap = captioners
    assert set(blip_caption_state_dict_from_jax(params)) == set(
        cap.model.state_dict())


def test_prompt_ids_match_jax(captioners):
    jcap, _, cap = captioners
    np.testing.assert_array_equal(cap.prompt_ids(3), jcap.prompt_ids(3))
    assert (cap.prompt_ids(3)[:, 0] == cap.tokenizer.dec_token_id).all()
    assert cap.tokenizer.sep_id not in cap.prompt_ids(1)[0]


@pytest.mark.parametrize("beams", [3, 1])
def test_captions_match_jax(captioners, beams):
    jcap, params, cap = captioners
    images = np.random.RandomState(beams).rand(
        2, cap.input_dim, cap.input_dim, 3).astype(np.float32)
    kw = dict(num_beams=beams, max_length=12, min_length=4,
              repetition_penalty=1.3)
    embeds = cap.encode(images)
    np.testing.assert_allclose(embeds.numpy(),
                               np.asarray(jcap.encode(params, images)), **F32)
    want = np.asarray(jcap._generate_ids(
        params, jcap.encode(params, images), jnp.asarray(jcap.prompt_ids(2)),
        jax.random.PRNGKey(0), **kw))
    got = cap.generate_ids(embeds, torch.from_numpy(cap.prompt_ids(2)), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert cap.caption(images, **kw) == jcap.caption(params, images, **kw)


def test_nucleus_caption_is_a_string_per_image(captioners):
    _, _, cap = captioners
    images = np.random.RandomState(5).rand(
        3, cap.input_dim, cap.input_dim, 3).astype(np.float32)
    kw = dict(use_nucleus_sampling=True, max_length=12, min_length=4)
    a = cap.caption(images, generator=torch.Generator().manual_seed(1), **kw)
    b = cap.caption(images, generator=torch.Generator().manual_seed(1), **kw)
    assert a == b and len(a) == 3 and all(isinstance(c, str) for c in a)


def _lavis_state_dict(cap):
    """A synthetic LAVIS blip_caption state dict (HF buffers and the tied
    decoder bias included) at the captioner's geometry, from a seed."""
    rng = np.random.RandomState(0)
    sd = {"text_decoder." + k if not k.startswith(("visual_encoder.",
                                                   "text_decoder.")) else k:
          torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
          for k, v in cap.model.state_dict().items()}
    sd["text_decoder.bert.embeddings.position_ids"] = torch.arange(
        512)[None]
    sd["text_decoder.cls.predictions.decoder.bias"] = sd[
        "text_decoder.cls.predictions.bias"].clone()
    return sd


@pytest.mark.parametrize("num_tokens", [None, 5])
def test_checkpoint_loader_matches_jax_converter(captioners, tmp_path,
                                                 num_tokens):
    _, _, cap = captioners
    sd = _lavis_state_dict(cap)
    if num_tokens:  # a checkpoint at another resolution: 3 x 3 patches,
        # resampled to the model's 2 x 2
        sd["visual_encoder.pos_embed"] = torch.from_numpy(
            np.random.RandomState(1).randn(1, 10, 32).astype(np.float32))
    path = os.path.join(tmp_path, "blip_caption.pth")
    torch.save({"model": sd}, path)
    got = load_blip_caption_checkpoint(path, num_tokens=num_tokens)
    want = blip_caption_state_dict_from_jax(convert_blip_caption(
        {k: v for k, v in sd.items()}, cap.vit_cfg.layers,
        cap.med_cfg.num_layers, num_tokens=num_tokens))
    assert set(got) == set(want) == set(cap.model.state_dict())
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **F32,
                                   err_msg=k)
    cap2 = BlipCaptioner("test-tiny")
    cap2.model.load_state_dict(got)
