"""The port's data-parallel stage-1 / stage-2 steps (`parallel/train.py`)
against the JAX package and against the port's single-process steps, on
the CPU in float32.

The sharded steps run in gloo process groups of 2 and 4 ranks
(`torch_dist.DistPool`, one per world size for the module, each task under
a 120 s watchdog). Both packages start from the same weights: the JAX
parameters go through `models/convert.py` into the port's state dict, which
every rank loads (and, with a model axis, slices). The JAX oracle is
`make_sharded_stage2_step` / `make_sharded_stage1_step` on the 8-device CPU
mesh. Tolerances are `tests/test_torch_stage2.py`'s: losses atol 5e-5,
rtol 1e-5; parameters after the steps atol 3e-5, rtol 1e-3 at LR 1e-3. The
tensors whose gradient is exactly zero (a key bias; the key third of a
fused q/k/v bias) move by Adam's rounding noise on either side and are not
compared; neither are the parts of blip2's Qformer_query the text re-read
never runs (optax decays them, torch's AdamW leaves them).

Dropout: the sharded step draws its noise at the global batch's shape from
a generator seeded alike on every rank (`models.med.GlobalNoise`), so it
equals the single-process port step for the same seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.models.api import build_backbone as jax_build_backbone
from spn4cir_tpu.parallel.loss import pad_bank_rows as jax_pad_bank_rows
from spn4cir_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spn4cir_tpu.parallel.mesh import put_bank, replicate, shard_batch
from spn4cir_tpu.parallel.train import (make_sharded_stage1_step as
                                        jax_stage1_step,
                                        make_sharded_stage2_step as
                                        jax_stage2_step)
from spn4cir_tpu.train import stage1 as jstage1
from spn4cir_tpu.train import stage2 as jstage2
from spn4cir_tpu_torch.models import convert
from spn4cir_tpu_torch.train import stage1, stage2
from torch_dist import Pools
import torch_dist_workers as W

torch.set_num_threads(1)

LR = 1e-3
B, M = 8, 41
LOSS_TOL = dict(atol=5e-5, rtol=1e-5)
PARAM_TOL = dict(atol=3e-5, rtol=1e-3)
CAPTIONS = ["a red dress", "make it blue", "shorter sleeves please",
            "same but darker", "with dots", "no collar", "longer", "a hat"]


@pytest.fixture(scope="module")
def pools():
    p = Pools()
    yield p
    p.close()


def _norm(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _numpy(sd):
    return {k: np.asarray(v, np.float32) if v.dtype != torch.int64
            else np.asarray(v) for k, v in
            ((k, v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in sd.items())}


def _state_dict(kind, params):
    """The port state dict (numpy) of JAX parameters of `kind`."""
    if kind == "clip":
        tb = W.build("clip")
        sd = convert.clip_state_dict_from_train_state(params, tb.cfg)
    elif kind == "blip":
        sd = convert.blip_state_dict_from_jax(jax.device_get(params))
    else:
        sd = convert.blip2_state_dict_from_jax(jax.device_get(params))
    return {k: v.numpy() for k, v in sd.items()}


def _comparable(kind, name):
    """The tensors both sides must agree on after training (see the module
    docstring)."""
    if name.endswith("key.bias"):
        return False
    return not (kind == "blip2" and name.startswith("Qformer_query.") and (
        ".crossattention." in name or ".intermediate_query." in name
        or ".output_query." in name))


def _compare_weights(kind, got, want):
    checked = 0
    for name, w in want.items():
        if not _comparable(kind, name):
            continue
        g, w = np.asarray(got[name]), np.asarray(w)
        if name.endswith(("in_proj_bias", "attn.qkv.bias")):  # not the key
            third = g.shape[0] // 3
            g = np.concatenate([g[:third], g[2 * third:]])
            w = np.concatenate([w[:third], w[2 * third:]])
        np.testing.assert_allclose(g, w, err_msg=name, **PARAM_TOL)
        checked += 1
    assert checked > 10, checked


def _stage2_world(kind, seed):
    """JAX backbone, parameters, the port state dict, the bank and three
    global batches of `kind` (the port tokenizes; both sides take the
    ids)."""
    rng = np.random.RandomState(seed)
    if kind == "clip":
        jb = jax_build_backbone("clip", clip_model_name="test-tiny", tau=0.05)
    elif kind == "blip":
        jb = jax_build_backbone("blip", blip_size="test-tiny")
    else:
        jb = jax_build_backbone("blip2", blip2_size="test-tiny")
    params = jax.jit(jb.init_params)(jax.random.PRNGKey(seed))
    sd = _state_dict(kind, params)
    tb = W.build(kind, sd)
    spec = tb.bank_spec()
    bank = _norm(rng.randn(M, *spec.target_shape))
    batches = [{"refer_feats": rng.randn(B, *spec.refer_shape).astype(
                    np.float32),
                "text_ids": tb.tokenize([CAPTIONS[(i + j) % len(CAPTIONS)]
                                         for j in range(B)]),
                "labels": rng.randint(0, M, B).astype(np.int64)}
               for i in range(3)]
    return jb, params, sd, bank, batches


def _port_single_stage2(kind, sd, bank, batches, dropout=0.0, seed=None,
                        shape=None):
    tb = W.build(kind, sd, dropout)
    state = stage2.create_train_state(tb, LR)
    gen = None
    if dropout:
        tb.train()
        gen = torch.Generator().manual_seed(seed)
    losses = [stage2.stage2_train_step(tb, state, torch.from_numpy(bank),
                                       W._tensors(b), gen).item()
              for b in batches]
    return losses, {k: v.numpy() for k, v in tb.model.state_dict().items()}


@pytest.mark.parametrize("kind", ["clip", "blip", "blip2"])
def test_stage2_step_at_data2_bank2_matches_jax_and_one_process(pools, kind):
    """Three steps of the sharded stage-2 step over (data 2, bank 2) against
    the JAX package's `make_sharded_stage2_step` on the same mesh shape and
    against the port's single-process `stage2_train_step`; blip4cir trains
    its learnable tau, blip2 its temp through the max-query loss."""
    jb, params, sd, bank, batches = _stage2_world(kind, 3)
    mesh = jax_make_mesh(data=2, bank=2, devices=jax.devices()[:4])
    jstate = replicate(jstage2.create_train_state(jb, params, LR), mesh)
    step = jax_stage2_step(jb, mesh, m_actual=M)
    jbank = put_bank(jax_pad_bank_rows(jnp.asarray(bank), 2), mesh)
    want_losses = []
    for b in batches:
        jstate, loss = step(jstate, jbank, shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}, mesh))
        want_losses.append(float(loss))
    want = _state_dict(kind, jstate.params)

    outs = pools(4).run("torch_dist_workers:stage2_steps", (2, 2, 1), kind,
                        sd, bank, batches, LR, M)
    for o in outs:
        np.testing.assert_allclose(o["losses"], want_losses, **LOSS_TOL)
    _compare_weights(kind, outs[0]["weights"], want)
    single_losses, single = _port_single_stage2(kind, sd, bank, batches)
    np.testing.assert_allclose(outs[0]["losses"], single_losses, **LOSS_TOL)
    _compare_weights(kind, outs[0]["weights"], single)
    if kind != "clip":
        assert outs[0]["tau"] != pytest.approx(
            float(sd["tau" if kind == "blip" else "temp"]), abs=1e-6)


@pytest.mark.parametrize("kind", ["blip", "blip2"])
def test_stage2_step_with_dropout_matches_one_process(pools, kind):
    """Train-mode MED dropout: noise drawn at the global batch's shape from
    a generator seeded alike, each rank keeping its rows, equals the
    single-process step for the same seed (and dropout changes the
    loss)."""
    _, _, sd, bank, batches = _stage2_world(kind, 4)
    outs = pools(4).run("torch_dist_workers:stage2_steps", (2, 2, 1), kind,
                        sd, bank, batches, LR, M, 0.1, 7)
    single_losses, single = _port_single_stage2(kind, sd, bank, batches,
                                                dropout=0.1, seed=7)
    plain_losses, _ = _port_single_stage2(kind, sd, bank, batches[:1])
    assert abs(single_losses[0] - plain_losses[0]) > 1e-6
    for o in outs:
        np.testing.assert_allclose(o["losses"], single_losses, **LOSS_TOL)
    _compare_weights(kind, outs[0]["weights"], single)


def test_composed_tensor_parallel_stage2_step_matches_one_process(pools):
    """(data 1, bank 1, model 2): the text tower cut Megatron-style over two
    ranks inside the sharded stage-2 step; the weights are gathered back
    (`parallel.tp.full_state_dict`) and match the single-process step."""
    _, _, sd, bank, batches = _stage2_world("clip", 5)
    outs = pools(2).run("torch_dist_workers:stage2_steps", (1, 1, 2), "clip",
                        sd, bank, batches, LR, M)
    single_losses, single = _port_single_stage2("clip", sd, bank, batches)
    for o in outs:
        np.testing.assert_allclose(o["losses"], single_losses, **LOSS_TOL)
    _compare_weights("clip", outs[0]["weights"], single)


# --------------------------------------------------------------------------
# stage 1
# --------------------------------------------------------------------------

def _stage1_world(kind, seed, b=4):
    rng = np.random.RandomState(seed)
    if kind == "clip":
        jb = jax_build_backbone("clip", clip_model_name="test-tiny", tau=0.05)
    else:
        jb = jax_build_backbone("blip", blip_size="test-tiny", tau=0.05,
                                dropout=0.1)
    params = jax.jit(jb.init_params)(jax.random.PRNGKey(seed))
    sd = _state_dict(kind, params)
    tb = W.build(kind, sd)
    s = tb.input_dim
    batches = [{"refer_images": rng.randn(b, s, s, 3).astype(np.float32),
                "target_images": rng.randn(b, s, s, 3).astype(np.float32),
                "text_ids": tb.tokenize(CAPTIONS[i:i + b])}
               for i in range(2)]
    return jb, params, sd, batches


def _port_single_stage1(kind, sd, batches, neg_type=0, dropout=0.0,
                        seed=None):
    tb = W.build(kind, sd, dropout)
    state = stage1.create_stage1_state(tb, LR)
    gen = None
    if dropout:
        tb.train()
        gen = torch.Generator().manual_seed(seed)
    losses = [stage1.stage1_train_step(tb, state, W._tensors(b), gen,
                                       neg_type).item() for b in batches]
    return losses, {k: v.numpy() for k, v in tb.model.state_dict().items()}


def test_stage1_step_at_data2_matches_jax_and_one_process(pools):
    """The in-batch InfoNCE over the global batch (every rank's target
    features gathered with their gradient): two steps at (data 2) against
    the JAX `make_sharded_stage1_step` and the port's single process."""
    jb, params, sd, batches = _stage1_world("clip", 6)
    mesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
    jstate = replicate(jstage1.create_stage1_state(jb, params, LR), mesh)
    step = jax_stage1_step(jb, mesh)
    want_losses = []
    for b in batches:
        jstate, loss = step(jstate, shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}, mesh))
        want_losses.append(float(loss))
    want = _state_dict("clip", jstate.params)
    outs = pools(2).run("torch_dist_workers:stage1_steps", (2, 1, 1), "clip",
                        sd, batches, LR)
    for o in outs:
        np.testing.assert_allclose(o["losses"], want_losses, **LOSS_TOL)
    _compare_weights("clip", outs[0]["weights"], want)
    single_losses, single = _port_single_stage1("clip", sd, batches)
    np.testing.assert_allclose(outs[0]["losses"], single_losses, **LOSS_TOL)
    _compare_weights("clip", outs[0]["weights"], single)


@pytest.mark.parametrize("shape,neg_type,kind,dropout", [
    ((2, 1, 2), 0, "clip", 0.0),        # data x tensor parallel
    ((2, 1, 1), 6, "clip", 0.0),        # the negtype ablation's losses
    ((2, 1, 1), 0, "blip", 0.1),        # MED dropout at the global shape
])
def test_stage1_step_variants_match_one_process(pools, shape, neg_type, kind,
                                                dropout):
    _, _, sd, batches = _stage1_world(kind, 7)
    outs = pools(shape[0] * shape[2]).run(
        "torch_dist_workers:stage1_steps", shape, kind, sd, batches, LR,
        neg_type, dropout, 11)
    single_losses, single = _port_single_stage1(kind, sd, batches, neg_type,
                                                dropout, 11)
    for o in outs:
        np.testing.assert_allclose(o["losses"], single_losses, **LOSS_TOL)
    _compare_weights(kind, outs[0]["weights"], single)


def test_epoch_refuses_a_step_built_for_another_objective():
    class Step:
        neg_type, with_dropout, raw_kind = 0, False, None

    with pytest.raises(ValueError, match="built for"):
        stage1.train_epoch_stage1(W.build("clip"), None, iter(()),
                                  neg_type=3, sharded_step=Step())
    with pytest.raises(ValueError, match="full-bank"):
        stage2.train_epoch(W.build("clip"), None, None, iter(()), neg_num=3,
                           sharded_step=object())


@pytest.mark.parametrize("part", [(0, 2), (1, 2), (3, 4)])
def test_iterators_decode_only_their_part(tmp_path, part):
    """`part=(i, n)`: each batch's images (and the training captions) are
    the i-th run of n of the whole batch's, decoded alone; the ids stay
    the whole batch's, padded tail included, so every rank takes the same
    steps and a gathered encode lands on them."""
    from spn4cir_tpu_torch.data.datasets import (CIRDataset, iter_gallery,
                                                 iter_train_images)
    from spn4cir_tpu_torch.data.transforms import ImageTransform
    from tests.fixtures import make_cirr

    root = make_cirr(str(tmp_path / "cirr"), n_images=10, n_train=6,
                     extended=False)
    tf = ImageTransform("targetpad", 32, 1.25)
    i, n = part
    rows = slice(i * 4 // n, (i + 1) * 4 // n)
    val = CIRDataset("cirr", "val", "classic", tf, root)
    whole = list(iter_gallery(val, 4, num_workers=0))
    cut = list(iter_gallery(val, 4, num_workers=0, part=part))
    assert len(cut) == len(whole)
    for (ids, images), (want_ids, want) in zip(cut, whole):
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(images, want[rows])
    train = CIRDataset("cirr", "train", "relative", tf, root)
    kw = dict(num_workers=0, shuffle=True, epoch_seed=3)
    whole = list(iter_train_images(train, 4, **kw))
    cut = list(iter_train_images(train, 4, part=part, **kw))
    assert len(cut) == len(whole) == 2   # 6 triplets: the second padded
    for got, want in zip(cut, whole):
        assert got["captions"] == want["captions"][rows]
        for key in ("refer_images", "target_images"):
            np.testing.assert_array_equal(got[key], want[key][rows])
        for key in ("triplet_idx", "target_id", "target_image_id",
                    "refer_image_id"):
            np.testing.assert_array_equal(got[key], want[key])
