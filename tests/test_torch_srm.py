"""The port's SRM matcher (models/srm.py, datagen/srm.py, cli/srm_utils.py)
against the JAX package's.

Weights: the JAX `SRMModel(tiny=True)` initialises Unicom and BGE from a
seed; `unicom_state_dict_from_jax` and `bge_state_dict_from_jax` carry them
into the port. Images and features are numpy arrays from fixed seeds. The
encoders and the similarity products agree to 1e-5 (float32, summation
order only). `srm_scores` is held EQUAL to the JAX one on the same
similarity matrices: ranks exactly; hard negatives exactly where no two
values of a row are equal, and otherwise as the same value sequence with
the same index set inside every run of equal values (the JAX order within
a run is not stable; the port takes the lower index first), the run that
the K boundary cuts holding the lowest indices of its value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.datagen import srm as jsrm
from spn4cir_tpu.models import srm as jmodel
from spn4cir_tpu_torch.datagen import srm as tsrm
from spn4cir_tpu_torch.models import srm as tmodel
from spn4cir_tpu_torch.models.convert import (bge_state_dict_from_jax,
                                              load_bge_checkpoint,
                                              unicom_state_dict_from_jax)
from spn4cir_tpu_torch.models.med import MedConfig

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
TEXTS = ["a red dress", "the shirt with long sleeves and a print", "blue",
         "make it more like the dress"]


@pytest.fixture(scope="module")
def pair():
    """(JAX SRMModel, its params, the port's SRMModel with those
    weights)."""
    jm = jmodel.SRMModel(tiny=True)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(1)))
    tm = tmodel.SRMModel(tiny=True)
    tm.visual.load_state_dict(unicom_state_dict_from_jax(params["unicom"],
                                                         tm.unicom_cfg))
    tm.text.load_state_dict(bge_state_dict_from_jax(params["bge"],
                                                    tm.bge_cfg))
    return jm, params, tm.eval()


def _unit(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_encode_image_matches_jax(pair):
    jm, params, tm = pair
    imgs = np.random.RandomState(0).rand(3, 28, 28, 3).astype(np.float32)
    want = np.asarray(jm.encode_image(params, jnp.asarray(imgs)))
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(imgs))
    assert got.shape == (3, tm.visual_dim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               atol=1e-6)


def test_encode_text_matches_jax(pair):
    jm, params, tm = pair
    want = np.asarray(jm.encode_text(params, TEXTS))
    ids, mask = tm.tokenize(TEXTS)
    assert ids.shape == (4, 64) and mask[2].sum() < mask[1].sum()
    with torch.no_grad():
        got = tm.encode_text(TEXTS)
    assert got.shape == (4, tm.text_dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bge_has_no_cross_attention(pair):
    _, _, tm = pair
    assert not any("crossattention" in n for n, _ in
                   tm.text.named_parameters())
    assert hasattr(tm.text.embeddings, "token_type_embeddings")
    cfg = MedConfig.bge_base()
    assert (cfg.vocab_size, cfg.type_vocab_size, cfg.cross_attention) == (
        30522, 2, False)
    with torch.device("meta"):
        bge = tmodel.MedBert(cfg)
    # bert-base-uncased without the pooler: 109,482,240 - 590,592
    assert sum(p.numel() for p in bge.parameters()) == 108_891_648
    with pytest.raises(ValueError, match="cross-attention"):
        tm.text(torch.zeros(1, 4, dtype=torch.long),
                encoder_hidden_states=torch.zeros(1, 2, 32))


def test_bge_checkpoint_loads_strictly(pair, tmp_path):
    """An HF `BertForX` save (`bert.` prefix, pooler, position_ids) loads
    strictly into the cross-attention-free MED."""
    _, params, tm = pair
    sd = {f"bert.{k}": v for k, v in
          bge_state_dict_from_jax(params["bge"]).items()}
    sd["bert.pooler.dense.weight"] = torch.zeros(32, 32)
    sd["bert.pooler.dense.bias"] = torch.zeros(32)
    sd["bert.embeddings.position_ids"] = torch.arange(512)[None]
    path = str(tmp_path / "bge.pt")
    torch.save(sd, path)
    fresh = tmodel.SRMModel(tiny=True)
    fresh.text.load_state_dict(load_bge_checkpoint(path))      # strict
    for (name, a), b in zip(fresh.text.state_dict().items(),
                            tm.text.state_dict().values()):
        assert torch.equal(a, b), name


def test_compute_sims_matches_jax():
    rng = np.random.RandomState(0)
    feats = [_unit(rng, n, 24) for n in (20, 30, 20, 30)]
    want = jsrm.compute_sims(*feats)
    got = tsrm.compute_sims(*map(torch.from_numpy, feats))
    assert set(got) == set(want) == {"i2t", "t2i", "i2i", "t2t"}
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key], **TOL)


def _sims(rng, n_img, n_txt, levels=None):
    """Four similarity matrices; `levels` rounds i2i and t2t to multiples
    of 1/levels, so that rows hold runs of exactly equal values."""
    i2t = rng.uniform(-1, 1, (n_img, n_txt)).astype(np.float32)
    sims = {"i2t": i2t, "t2i": i2t.T.copy(),
            "i2i": rng.uniform(-1, 1, (n_img, n_img)).astype(np.float32),
            "t2t": rng.uniform(-1, 1, (n_txt, n_txt)).astype(np.float32)}
    if levels:
        for key in ("i2i", "t2t"):
            sims[key] = np.round(sims[key] * levels) / levels
    return sims


def _port_scores(sims, refer, target, k, chunk=tsrm.ROW_CHUNK):
    got = tsrm.srm_scores({key: torch.from_numpy(v) for key, v in
                           sims.items()}, refer, target, k, chunk=chunk)
    return {key: v.numpy() for key, v in got.items()}


def _assert_same_up_to_ties(mat, selves, want_idx, got_idx):
    """Row by row: the same values in the same order; inside each run of
    equal values the same index set, except the run the K boundary cuts,
    where the port holds that value's lowest indices."""
    for row, self_, w, g in zip(mat, selves, want_idx, got_idx):
        row = row.copy()
        row[self_] = tsrm.SELF_FILL
        np.testing.assert_array_equal(row[w], row[g])
        vals = row[g]
        starts = np.flatnonzero(np.r_[True, vals[1:] != vals[:-1]])
        ends = np.r_[starts[1:], len(vals)]
        for s, e in zip(starts, ends):
            if e == len(vals) and len(vals) < len(row):
                members = np.flatnonzero(row == vals[s])
                assert list(g[s:e]) == list(members[: e - s])
            else:
                assert set(w[s:e]) == set(g[s:e])
                assert list(g[s:e]) == sorted(g[s:e])


@pytest.mark.parametrize("n_img,n_txt,k", [(40, 30, 10), (40, 30, 1000)])
def test_srm_scores_equal_jax(n_img, n_txt, k):
    rng = np.random.RandomState(n_img + k)
    sims = _sims(rng, n_img, n_txt)
    refer = rng.randint(0, n_img, n_txt)
    target = rng.randint(0, n_img, n_txt)
    want = jsrm.srm_scores(sims, refer, target, k)
    got = _port_scores(sims, refer, target, k)
    for key in want:
        assert got[key].dtype == want[key].dtype == np.int64, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["r_fn"].shape == (n_txt, min(k, n_img))
    assert got["m_fn"].shape == (n_txt, min(k, n_txt))


def test_self_comes_last_when_k_covers_the_row():
    rng = np.random.RandomState(5)
    sims = _sims(rng, 12, 9)
    refer = rng.randint(0, 12, 9)
    target = rng.randint(0, 12, 9)
    got = _port_scores(sims, refer, target, 1000)
    want = jsrm.srm_scores(sims, refer, target, 1000)
    assert (got["m_fn"][:, -1] == np.arange(9)).all()
    assert (got["r_fn"][:, -1] == refer).all()
    assert (got["t_fn"][:, -1] == target).all()
    for key in ("m_fn", "r_fn", "t_fn"):
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("k", [7, 1000])
def test_ties_compare_by_value_and_run(k):
    """i2i and t2t rounded to eighths: rows full of equal values, as
    duplicate images make them."""
    rng = np.random.RandomState(k)
    sims = _sims(rng, 30, 24, levels=8)
    refer = rng.randint(0, 30, 24)
    target = rng.randint(0, 30, 24)
    want = jsrm.srm_scores(sims, refer, target, k)
    got = _port_scores(sims, refer, target, k)
    for key in ("rt", "rm", "mt"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    _assert_same_up_to_ties(sims["i2i"][refer], refer, want["r_fn"],
                            got["r_fn"])
    _assert_same_up_to_ties(sims["i2i"][target], target, want["t_fn"],
                            got["t_fn"])
    _assert_same_up_to_ties(sims["t2t"], np.arange(24), want["m_fn"],
                            got["m_fn"])


def test_chunked_equals_one_chunk():
    rng = np.random.RandomState(9)
    sims = _sims(rng, 25, 23, levels=16)
    refer = rng.randint(0, 25, 23)
    target = rng.randint(0, 25, 23)
    whole = _port_scores(sims, refer, target, 6, chunk=1000)
    # a chunk's negatives hold their K columns only, not the chunk's whole
    # sorted rows (which the chunks would otherwise keep alive)
    rows = tsrm.score_rows({key: torch.from_numpy(v) for key, v in
                            sims.items()}, torch.from_numpy(refer),
                           torch.from_numpy(target), torch.arange(4), 6)
    for key in ("r_fn", "t_fn", "m_fn"):
        assert rows[key].untyped_storage().nbytes() == 4 * 6 * 8, key
    for chunk in (1, 5, 22):
        part = _port_scores(sims, refer, target, 6, chunk=chunk)
        for key in whole:
            np.testing.assert_array_equal(part[key], whole[key])


def test_save_load_and_extract_all_features(tmp_path):
    scores = {"rt": torch.arange(3), "r_fn": torch.arange(6).view(3, 2)}
    path = str(tmp_path / "sub" / "srm.npz")
    tsrm.save_srm(path, scores)
    back = tsrm.load_srm(path)
    assert back["r_fn"].dtype == np.int64
    np.testing.assert_array_equal(back["r_fn"], scores["r_fn"].numpy())

    def batches():
        yield np.array([0, 2, -1]), np.ones((3, 2), np.float32)
        yield np.array([5, -1, -1]), np.full((3, 2), 3.0, np.float32)

    feats = tsrm.extract_all_features(lambda x: x * torch.tensor([1., 0.]),
                                      batches(), "cpu")
    want = np.zeros((6, 2), np.float32)
    want[[0, 2, 5], 0] = 1.0
    np.testing.assert_array_equal(feats.numpy(), want)
