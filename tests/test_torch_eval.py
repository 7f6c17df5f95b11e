"""The port's retrieval metrics and validation loops against the JAX
package, on the CPU.

Metrics: scores are made from a numpy seed and quantized to a few levels, so
that every row holds deliberate ties (with the target's score too); ranks
are integers and must be EQUAL, recalls equal to 1e-5 (a float32 mean of
0/1 values times 100). Validation loops: the same fixture datasets, the
same weights and tokenizer on both sides; query features within atol 1e-4
(float32 towers, summation order), id arrays equal, and the recall
dictionaries equal to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.data.datasets import CIRDataset as JaxCIRDataset
from spn4cir_tpu.data.transforms import ImageTransform as JaxImageTransform
from spn4cir_tpu.eval import metrics as jmetrics
from spn4cir_tpu.eval import retrieval as jretrieval
from spn4cir_tpu.models.api import build_backbone as jax_build_backbone
from spn4cir_tpu.tokenizer.bpe import tokenize as jax_tokenize
from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.eval import metrics, retrieval
from spn4cir_tpu_torch.models.clip4cir import ClipCIR
from spn4cir_tpu_torch.models.convert import clip_state_dict_from_jax
from spn4cir_tpu_torch.ops.bank_kernels import quantize_bank
from tests.fixtures import make_cirr, make_fiq
from tests.torch_fixtures import synthetic_tokenizer

torch.set_num_threads(1)

Q, N, G = 23, 40, 6


def _tied_case(rng, levels):
    """Scores on `levels` distinct values: each row has ~N/levels-way ties."""
    scores = (rng.randint(0, levels, size=(Q, N)) / levels).astype(np.float32)
    target = rng.randint(0, N, Q).astype(np.int64)
    refer = (target + rng.randint(1, N, Q)) % N        # never the target
    members = np.stack([rng.choice(N, G, replace=False) for _ in range(Q)])
    members[:, 0], members[:, 1] = refer, target       # may hold both
    return scores, target, refer, members.astype(np.int64)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("levels", [2, 3, 7, 1000])
def test_ranks_equal_on_tied_scores(levels, rng):
    scores, target, refer, members = _tied_case(rng, levels)
    js, jt, jr, jm = _j(scores, target, refer, members)
    ts, tt, tr, tm = _t(scores, target, refer, members)
    ties = (scores == scores[np.arange(Q), target][:, None]).sum(axis=1)
    if levels <= 7:
        assert ties.min() >= 2 or levels == 7       # the target is tied
        assert ties.max() >= N // (2 * levels)

    np.testing.assert_array_equal(
        metrics.target_ranks(ts, tt, tr).numpy(),
        np.asarray(jmetrics.target_ranks(js, jt, jr)))
    np.testing.assert_array_equal(
        metrics.target_ranks(ts, tt, None).numpy(),
        np.asarray(jmetrics.target_ranks(js, jt, None)))
    np.testing.assert_array_equal(
        metrics.subset_ranks(ts, tt, tr, tm).numpy(),
        np.asarray(jmetrics.subset_ranks(js, jt, jr, jm)))
    # the function leaves its input alone (the exclusion writes to a copy)
    np.testing.assert_array_equal(ts.numpy(), scores)


@pytest.mark.parametrize("levels", [2, 5, 1000])
def test_recalls_equal_on_tied_scores(levels, rng):
    scores, target, refer, members = _tied_case(rng, levels)
    js, jt, jr, jm = _j(scores, target, refer, members)
    ts, tt, tr, tm = _t(scores, target, refer, members)
    for refer_pair in ((tr, jr), (None, None)):
        got = metrics.fiq_metrics(ts, tt, refer_pair[0])
        want = jmetrics.fiq_metrics(js, jt, refer_pair[1])
        assert got.keys() == want.keys() == {"recall_at10", "recall_at50"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5)
    got = metrics.cirr_metrics(ts, tt, tr, tm)
    want = jmetrics.cirr_metrics(js, jt, jr, jm)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    per_type = [{"recall_at10": 10.0, "recall_at50": 40.0},
                {"recall_at10": 30.0, "recall_at50": 60.0}]
    assert metrics.fiq_average(per_type) == jmetrics.fiq_average(per_type)
    ranks = torch.tensor([0, 3, 9, 10, 50])
    np.testing.assert_allclose(
        metrics.recall_at(ranks, 10).item(),
        float(jmetrics.recall_at(jnp.asarray(ranks.numpy()), 10)), atol=1e-5)


@pytest.mark.parametrize("levels", [1, 2, 3, 7, 1000])
@pytest.mark.parametrize("k", [3, 50])
def test_topk_names_order_equal_on_tied_scores(levels, k, rng):
    """Among equal scores the lowest gallery id comes first, as
    `jax.lax.top_k` has it; k past the gallery size is clipped."""
    scores, _, refer, members = _tied_case(rng, levels)
    js, jr, jm = _j(scores, refer, members)
    ts, tr, tm = _t(scores, refer, members)
    got = metrics.topk_names(ts, tr, k)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jmetrics.topk_names(js, jr, k)))
    assert got.shape == (Q, min(k, N))
    if k < N:   # the reference never makes the list
        assert not (got == tr[:, None]).any()
    got = metrics.subset_topk_names(ts, tr, tm, 3)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmetrics.subset_topk_names(js, jr, jm, 3)))
    assert not (got == tr[:, None]).any()
    np.testing.assert_array_equal(ts.numpy(), scores)


def test_topk_names_puts_the_lowest_index_first_among_ties():
    scores = torch.tensor([[0.5, 0.9, 0.5, 0.5, 0.9, 0.1]])
    assert metrics.topk_names(scores, torch.tensor([1]), 4).tolist() == [
        [4, 0, 2, 3]]
    members = torch.tensor([[3, 1, 2, 0, 5]])
    assert metrics.subset_topk_names(scores, torch.tensor([1]), members,
                                     3).tolist() == [[3, 2, 0]]


def test_rank_counts_ties_in_the_targets_favour():
    scores = torch.tensor([[0.5, 0.5, 0.5, 0.9, 0.1]])
    tgt, ref = torch.tensor([1]), torch.tensor([3])
    assert metrics.target_ranks(scores, tgt, None).tolist() == [1]
    assert metrics.target_ranks(scores, tgt, ref).tolist() == [0]
    members = torch.tensor([[3, 1, 0, 2]])
    assert metrics.subset_ranks(scores, tgt, ref, members).tolist() == [0]
    assert metrics.subset_ranks(scores, torch.tensor([4]), ref,
                                members).tolist() == [3]


TF_J = JaxImageTransform("targetpad", 32)
TF_T = ImageTransform("targetpad", 32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tok = synthetic_tokenizer()
    jb = jax_build_backbone("clip", clip_model_name="test-tiny")
    jb.tokenize = lambda texts: jax_tokenize(texts, context_length=77,
                                             truncate=True, tokenizer=tok)
    params = jax.jit(jb.init_params)(jax.random.PRNGKey(0))
    tb = ClipCIR("test-tiny", tokenizer=tok)
    tb.model.load_state_dict(
        clip_state_dict_from_jax(jax.device_get(params), tb.cfg))
    tb.eval()
    base = tmp_path_factory.mktemp("eval")
    return dict(jb=jb, params=params, tb=tb,
                cirr=make_cirr(str(base / "cirr_dataset"), n_images=20,
                               n_val=9, extended=False),
                fiq=make_fiq(str(base / "fiq_dataset")))


@pytest.fixture
def pil_decode(monkeypatch):
    """The port decodes with PIL only; hold the JAX side to the same."""
    monkeypatch.setenv("SPN4CIR_NATIVE", "0")


def test_generate_val_predictions_matches_jax(world, pil_decode):
    jb, params, tb, root = (world[k] for k in ("jb", "params", "tb", "cirr"))
    jindex = jretrieval.extract_index_features(
        jb, params, JaxCIRDataset("cirr", "val", "classic", TF_J, root), 4,
        num_workers=0)
    tindex = retrieval.extract_index_features(
        tb, CIRDataset("cirr", "val", "classic", TF_T, root), 4, num_workers=0)
    assert list(jindex.names) == list(tindex.names)
    want = jretrieval.generate_val_predictions(
        jb, params, JaxCIRDataset("cirr", "val", "relative", TF_J, root),
        jindex, 4)
    got = retrieval.generate_val_predictions(
        tb, CIRDataset("cirr", "val", "relative", TF_T, root), tindex, 4)
    assert got.keys() == want.keys() and len(got["pairid"]) == 9
    for k in ("refer_gid", "target_gid", "member_gids", "pairid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["query_feats"], want["query_feats"],
                               atol=1e-4)
    np.testing.assert_allclose(
        retrieval.query_scores(tb, got, tindex).numpy(),
        np.asarray(jretrieval.query_scores(jb, want, jindex)), atol=1e-4)
    # an int8 gallery is scored with the scales after the product, as the
    # JAX package's serving side does
    dense = tindex.target
    tindex.target = quantize_bank(dense)
    from spn4cir_tpu.serve.service import quantized_score_queries as jax_q8
    from spn4cir_tpu.ops.bank_kernels import QuantBank as JaxQuantBank

    q8 = retrieval.query_scores(tb, got, tindex)
    want_q8 = jax_q8(jnp.asarray(got["query_feats"]), JaxQuantBank(
        jnp.asarray(tindex.target.values.numpy()),
        jnp.asarray(tindex.target.scales.numpy())))
    np.testing.assert_allclose(q8.numpy(), np.asarray(want_q8), atol=1e-6)
    assert (q8 - torch.from_numpy(got["query_feats"]) @ dense.T).abs().max() \
        < 0.02


def test_cirr_val_retrieval_matches_jax(world, pil_decode):
    jb, params, tb, root = (world[k] for k in ("jb", "params", "tb", "cirr"))
    want = jretrieval.cirr_val_retrieval(jb, params, root, TF_J, batch_size=4)
    got = retrieval.cirr_val_retrieval(tb, root, TF_T, batch_size=4)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    assert got["arithmetic_mean"] == (got["recall_at5"]
                                      + got["group_recall_at1"]) / 2


@pytest.mark.parametrize("fiq_val_type", [0, 1])
def test_fiq_val_retrieval_matches_jax(fiq_val_type, world, pil_decode):
    jb, params, tb, root = (world[k] for k in ("jb", "params", "tb", "fiq"))
    want = jretrieval.fiq_val_retrieval(jb, params, root, "dress", TF_J,
                                        batch_size=4,
                                        fiq_val_type=fiq_val_type)
    got = retrieval.fiq_val_retrieval(tb, root, "dress", TF_T, batch_size=4,
                                      fiq_val_type=fiq_val_type)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


def test_fiq_reference_exclusion_follows_the_backbone_flag(world, pil_decode):
    tb, root = world["tb"], world["fiq"]
    with_ref = retrieval.fiq_val_retrieval(tb, root, "dress", TF_T, 4)
    tb.fiq_exclude_reference = False
    try:
        without = retrieval.fiq_val_retrieval(tb, root, "dress", TF_T, 4)
    finally:
        del tb.fiq_exclude_reference
    for k in with_ref:
        assert without[k] <= with_ref[k]     # excluding can only help a rank
