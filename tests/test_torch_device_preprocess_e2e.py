"""End-to-end `--device_preprocess` paths of the port on the CPU, against
the JAX package's and against the port's own host pipeline: raw staging
through the iterators, gallery indexing, bank extraction, a stage-1 step,
the service's live images, and the entry points' flags.

Both packages hold the same test-tiny weights (`clip_state_dict_from_jax`)
and tokenize with the synthetic-merges tokenizer. Tolerances: features
against the JAX package's raw route within 1e-4 (float32; the device
preprocess is within one uint8 step of JAX's, see test_torch_preprocess.py);
against the host pipeline (another resampler) a cosine above 0.99 per row;
one stage-1 loss within 0.05 of the host route's and of the JAX raw route's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spn4cir_tpu.bank.bank import extract_banks as jax_extract_banks
from spn4cir_tpu.data.datasets import CIRDataset as JaxCIRDataset
from spn4cir_tpu.data.datasets import iter_train_images as jax_iter_train_images
from spn4cir_tpu.data.datasets import iter_unique_images as jax_iter_unique
from spn4cir_tpu.data.transforms import RawBatch as JaxRawBatch
from spn4cir_tpu.data.transforms import RawStageTransform as JaxRawStageTransform
from spn4cir_tpu.eval.retrieval import extract_index_features as jax_extract
from spn4cir_tpu.models.api import build_backbone as jax_build_backbone
from spn4cir_tpu.ops.preprocess import absorb_raw as jax_absorb_raw
from spn4cir_tpu.serve import RetrievalService as JaxRetrievalService
from spn4cir_tpu.tokenizer.bpe import tokenize as jax_tokenize
from spn4cir_tpu.train import stage1 as jax_stage1
from spn4cir_tpu_torch.bank.bank import extract_banks
from spn4cir_tpu_torch.cli.serve import serve_main
from spn4cir_tpu_torch.cli.train import train_main
from spn4cir_tpu_torch.cli.validate import validate_main
from spn4cir_tpu_torch.data.datasets import (CIRDataset, iter_gallery,
                                             iter_train_images,
                                             iter_unique_images)
from spn4cir_tpu_torch.data.transforms import (ImageTransform, RawBatch,
                                               RawStageTransform)
from spn4cir_tpu_torch.eval.retrieval import extract_index_features
from spn4cir_tpu_torch.models.clip4cir import ClipCIR
from spn4cir_tpu_torch.models.convert import clip_state_dict_from_jax
from spn4cir_tpu_torch.ops.preprocess import absorb_raw, batch_to_device
from spn4cir_tpu_torch.serve import RetrievalService
from spn4cir_tpu_torch.train.stage1 import (create_stage1_state,
                                            stage1_train_step)
from tests.fixtures import make_cirr, make_fiq
from tests.torch_fixtures import synthetic_tokenizer

torch.set_num_threads(1)
CANVAS = 64


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
    root = make_fiq(str(tmp_path_factory.mktemp("fiq_devpre")))
    cirr = make_cirr(str(tmp_path_factory.mktemp("cirr_devpre")),
                     extended=False)
    return dict(tok=tok, jb=jb, params=params, tb=tb, root=root, cirr=cirr)


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    monkeypatch.delenv("SPN4CIR_NATIVE", raising=False)
    # set, so that the undo restores whatever was there (the CLIs set it)
    monkeypatch.setenv("SPN4CIR_MP_PROCS", "0")


def _datasets(world, split, mode):
    d = world["tb"].input_dim
    kw = dict(data_path=world["root"], dress_types=["dress"])
    return (CIRDataset("fiq", split, mode, ImageTransform("targetpad", d),
                       **kw),
            CIRDataset("fiq", split, mode,
                       RawStageTransform("targetpad", d, CANVAS), **kw),
            JaxCIRDataset("fiq", split, mode,
                          JaxRawStageTransform("targetpad", d, CANVAS), **kw))


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(
        b, axis=-1)


def test_iter_gallery_yields_rawbatch(world):
    _, raw_ds, _ = _datasets(world, "val", "classic")
    ids, batch = next(iter_gallery(raw_ds, 4, num_workers=0))
    assert isinstance(batch, RawBatch)
    assert batch.canvas.dtype == np.uint8
    assert batch.canvas.shape == (4, CANVAS, CANVAS, 3)
    assert batch.extents.shape == (4, 2) and batch.extents.dtype == np.int32
    assert (batch.extents == 40).all()   # 40x40 squares: targetpad pads none


def test_index_features_from_raw_matches_jax_and_host(world):
    host_ds, raw_ds, jax_ds = _datasets(world, "val", "classic")
    got = extract_index_features(world["tb"], raw_ds, 4, num_workers=0)
    want = jax_extract(world["jb"], world["params"], jax_ds, 4, num_workers=0)
    assert got.names == list(want.names)
    np.testing.assert_allclose(got.target.numpy(), np.asarray(want.target),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.refer, np.asarray(want.refer), atol=1e-4,
                               rtol=0)
    host = extract_index_features(world["tb"], host_ds, 4, num_workers=0)
    assert _cos(host.target.numpy(), got.target.numpy()).min() > 0.99


def test_extract_banks_raw(world):
    tb, jb, params = world["tb"], world["jb"], world["params"]
    host_ds, raw_ds, jax_ds = _datasets(world, "train", "relative")
    absorbed = absorb_raw(tb.bank_features, tb.input_dim, "targetpad")
    with torch.no_grad():
        raw_bank = extract_banks(absorbed, iter_unique_images(raw_ds, 4, 0),
                                 raw_ds.num_unique_images)
        host_bank = extract_banks(tb.bank_features,
                                  iter_unique_images(host_ds, 4, 0),
                                  host_ds.num_unique_images)
    jax_fn = jax.jit(lambda imgs: jax_absorb_raw(
        lambda p, im: jb.bank_features(p, im), jb.input_dim,
        "targetpad")(params, imgs))
    jax_bank = jax_extract_banks(jax_fn, jax_iter_unique(jax_ds, 4, 0),
                                 jax_ds.num_unique_images)
    np.testing.assert_allclose(raw_bank.target.numpy(),
                               np.asarray(jax_bank.target), atol=1e-4, rtol=0)
    np.testing.assert_allclose(raw_bank.refer, np.asarray(jax_bank.refer),
                               atol=1e-4, rtol=0)
    assert _cos(host_bank.target.numpy(), raw_bank.target.numpy()).min() > 0.99


def test_stage1_step_on_raw_batches(world):
    tb, jb, params, tok = world["tb"], world["jb"], world["params"], world["tok"]
    host_ds, raw_ds, jax_ds = _datasets(world, "train", "relative")
    sd = {k: v.clone() for k, v in tb.model.state_dict().items()}

    def port_loss(ds, raw_kind):
        tb.model.load_state_dict(sd)
        rows = next(iter_train_images(ds, 4, num_workers=0))
        batch = {"refer_images": batch_to_device(rows["refer_images"], "cpu"),
                 "target_images": batch_to_device(rows["target_images"], "cpu"),
                 "text_ids": torch.from_numpy(tb.tokenize(rows["captions"]))}
        state = create_stage1_state(tb, 1e-5)
        return float(stage1_train_step(tb, state, batch, None, 0, raw_kind))

    try:
        raw_loss = port_loss(raw_ds, "targetpad")
        host_loss = port_loss(host_ds, None)
    finally:
        tb.model.load_state_dict(sd)
        tb.eval()
    rows = next(jax_iter_train_images(jax_ds, 4, num_workers=0))
    jbatch = {side: JaxRawBatch(jnp.asarray(rows[side].canvas),
                                jnp.asarray(rows[side].extents))
              for side in ("refer_images", "target_images")}
    jbatch["text_ids"] = jnp.asarray(jax_tokenize(
        rows["captions"], truncate=True, tokenizer=tok))
    state = jax_stage1.create_stage1_state(jb, params, 1e-5)
    _, jax_loss = jax_stage1.stage1_train_step(jb, state, jbatch, 0, None,
                                               "targetpad")
    assert np.isfinite(raw_loss)
    assert abs(raw_loss - host_loss) < 0.05, (raw_loss, host_loss)
    assert abs(raw_loss - float(jax_loss)) < 0.05, (raw_loss, float(jax_loss))


def test_service_raw_add_images_and_query_by_image(world):
    tb, jb, params = world["tb"], world["jb"], world["params"]
    _, raw_ds, jax_ds = _datasets(world, "val", "classic")
    index = extract_index_features(tb, raw_ds, 4, num_workers=0)
    jax_index = jax_extract(jb, params, jax_ds, 4, num_workers=0)
    svc = RetrievalService(tb, index, preprocess=raw_ds.preprocess)
    jsvc = JaxRetrievalService(jb, params, jax_index,
                               preprocess=jax_ds.preprocess)
    rng = np.random.RandomState(3)
    im = Image.fromarray(rng.randint(0, 256, (50, 44, 3), dtype=np.uint8))
    got = svc.query_by_image(im, "make it red", k=3)
    want = jsvc.query_by_image(im, "make it red", k=3)
    assert [r["name"] for r in got] == [r["name"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], atol=1e-4)
    n0 = len(svc.index.names)
    new = [im, Image.fromarray(rng.randint(0, 256, (40, 60, 3), np.uint8))]
    assert svc.add_images(["new_a", "new_b"], new) == n0 + 2
    jsvc.add_images(["new_a", "new_b"], new)
    np.testing.assert_allclose(svc.index.target[n0:].numpy(),
                               np.asarray(jsvc.index.target)[n0:], atol=1e-4)
    hits = svc.query_by_name("new_a", "same but blue", k=2)
    assert len(hits) == 2 and "new_a" not in [h["name"] for h in hits]


ARGV = ["--dataset", "cirr", "--clip-model-name", "test-tiny", "--device",
        "cpu", "--batch-size", "2", "--seed", "0"]


@pytest.mark.parametrize("flags", [
    ["--device_preprocess"],
    ["--loader_procs", "2"],
    ["--device_preprocess", "--loader_procs", "2", "--device_canvas", "48"],
])
def test_entry_points_take_the_loader_and_device_preprocess(world, flags,
                                                             tmp_path,
                                                             monkeypatch):
    """cli.train (stage 2, then stage 1 on raw canvases), cli.validate and
    cli.serve run with the flags; `--loader_procs` reaches the iterators as
    SPN4CIR_MP_PROCS."""
    argv = ARGV + ["--data_path", world["cirr"]] + flags
    train_main("clip", argv + ["--num-epochs", "1", "--output_path",
                               str(tmp_path / "s2")], tokenizer=world["tok"],
               log_every=0)
    if "--loader_procs" in flags:
        assert os.environ["SPN4CIR_MP_PROCS"] == "2"
    train_main("clip", argv + ["--num-epochs", "1", "--wo_bank",
                               "--output_path", str(tmp_path / "s1")],
               tokenizer=world["tok"], log_every=0)
    results = validate_main("clip", argv, tokenizer=world["tok"])
    assert np.isfinite(results["arithmetic_mean"])
    server, service = serve_main(argv + ["--serve_port", "0",
                                         "--serve_host", "127.0.0.1",
                                         "--no-block"],
                                 tokenizer=world["tok"])
    try:
        want = (RawStageTransform if "--device_preprocess" in flags
                else ImageTransform)
        assert isinstance(service.preprocess, want)
        name = service.index.names[0]
        hits = service.query_by_name(name, "make it red", k=3)
        assert len(hits) == 3 and name not in [h["name"] for h in hits]
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("flags,match", [
    (["--device_preprocess", "--mesh_data", "2"], "--mesh_data"),
    (["--loader_procs", "2", "--mesh_model", "2"], "--mesh_model"),
    (["--device_preprocess", "--loader_procs", "2", "--distributed"],
     "--distributed"),
])
def test_entry_points_still_refuse_meshes_and_distributed(world, flags, match,
                                                          tmp_path,
                                                          monkeypatch):
    """With the host-input flags, a mesh (`match`'s flag) still needs one
    process per GPU: a process started alone is refused."""
    for var in ("SPN4CIR_DIST_NPROCS", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert match in flags
    argv = ARGV + ["--data_path", world["cirr"]] + flags
    with pytest.raises(SystemExit, match="multi-process launch"):
        train_main("clip", argv + ["--output_path", str(tmp_path / "o")],
                   tokenizer=world["tok"])
    with pytest.raises(SystemExit, match="multi-process launch"):
        validate_main("clip", argv, tokenizer=world["tok"])
    with pytest.raises(SystemExit, match="multi-process launch"):
        serve_main(argv + ["--no-block"], tokenizer=world["tok"])


def test_device_canvas_goes_with_device_preprocess(world, tmp_path):
    argv = ARGV + ["--data_path", world["cirr"], "--device_canvas", "448"]
    with pytest.raises(SystemExit, match="--device_preprocess"):
        validate_main("clip", argv, tokenizer=world["tok"])
