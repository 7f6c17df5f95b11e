"""The port's sharded retrieval service (`serve/sharded.py`): the gallery
as row shards over a device list, one process, an exact two-stage top-k.

On the CPU every shard lives on the CPU (the class takes any device list,
repeats allowed). Held against the port's `RetrievalService` on the same
gallery: identical ids and scores, `k` past a shard's rows, padding,
`add_images` re-sharding, batching, int8 and max-query galleries, the
index round trip; against the JAX package's `ShardedRetrievalService`:
the max-query scores and the order of exactly tied scores (lowest global
index first); and `cli.serve --mesh_bank 2 --device cpu` over HTTP.
Mirrors `tests/test_serve_sharded.py:42-348`.
"""

import concurrent.futures
import copy
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spn4cir_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spn4cir_tpu.serve import sharded as jsharded
from spn4cir_tpu_torch.cli.serve import serve_main
from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.eval.retrieval import GalleryIndex, extract_index_features
from spn4cir_tpu_torch.ops import infonce
from spn4cir_tpu_torch.ops.bank_kernels import QuantBank, quantize_bank
from spn4cir_tpu_torch.serve import (RetrievalService,
                                     ShardedBatchingRetrievalService,
                                     ShardedGalleryIndex,
                                     ShardedRetrievalService)
from tests.fixtures import make_fiq
import torch_dist_workers as W

torch.set_num_threads(1)
TF = ImageTransform("targetpad", 32)
SHARDS = ["cpu"] * 8


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(single service, sharded service) over the SAME gallery."""
    root = make_fiq(str(tmp_path_factory.mktemp("fiq")))
    bb = W.build("clip")
    bb.init_params(torch.Generator().manual_seed(0))
    bb.eval()
    classic = CIRDataset("fiq", "val", "classic", TF, root, ["dress"])
    index = extract_index_features(bb, classic, 4, num_workers=0)
    single = RetrievalService(bb, index, preprocess=TF, default_k=5)
    sharded = ShardedRetrievalService(bb, index, SHARDS, preprocess=TF,
                                      default_k=5)
    return single, sharded


def _same(got, want):
    """Identical ids; scores within float32 summation order (a shard's
    product runs over fewer gallery rows than the whole one's)."""
    assert [r["name"] for r in got] == [r["name"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], rtol=1e-6,
                               atol=1e-6)


def test_gallery_not_divisible_is_padded(pair):
    _, sharded = pair
    m = len(sharded.index.names)
    rows = [s.shape[0] for s in sharded.index.shards]
    assert len(rows) == 8 and len(set(rows)) == 1
    assert sum(rows) >= m and sum(rows) % 8 == 0 and m % 8


def test_query_equality(pair):
    single, sharded = pair
    for name in single.index.names[:3]:
        for caption in ["make it blue", "longer sleeves"]:
            got = sharded.query_by_name(name, caption, k=4)
            _same(got, single.query_by_name(name, caption, k=4))
            assert all(r["name"] != name for r in got)


def test_query_k_exceeds_local_shard(pair):
    single, sharded = pair
    m = len(single.index.names)
    name = single.index.names[1]
    _same(sharded.query_by_name(name, "swap the color", k=m - 1),
          single.query_by_name(name, "swap the color", k=m - 1))


def test_query_by_image_equality(pair, rng):
    single, sharded = pair
    img = Image.fromarray(rng.randint(0, 256, (40, 40, 3), dtype=np.uint8))
    _same(sharded.query_by_image(img, "a red dress", k=4),
          single.query_by_image(img, "a red dress", k=4))


def test_add_images_reshards_and_matches(pair, rng):
    single, sharded = pair
    s1 = RetrievalService(single.backbone, copy.copy(single.index),
                          preprocess=TF, default_k=5)
    s2 = ShardedRetrievalService(single.backbone, copy.copy(single.index),
                                 SHARDS, preprocess=TF, default_k=5)
    imgs = [Image.fromarray(rng.randint(0, 256, (40, 40, 3), dtype=np.uint8))
            for _ in range(3)]
    names = [f"new_{i}" for i in range(3)]
    assert s1.add_images(names, imgs) == s2.add_images(names, imgs) == \
        len(single.index.names) + 3
    assert sum(s.shape[0] for s in s2.index.shards) % 8 == 0
    ref = s1.index.names[0]
    _same(s2.query_by_name(ref, "something new", k=6),
          s1.query_by_name(ref, "something new", k=6))
    with pytest.raises(KeyError):
        s2.add_images(["new_0"], imgs[:1])


def test_sharded_index_roundtrip(pair):
    single, sharded = pair
    idx = sharded.index
    assert isinstance(idx, ShardedGalleryIndex)
    assert idx.names == single.index.names
    torch.testing.assert_close(idx.host_target, single.index.target)
    m = len(idx.names)
    torch.testing.assert_close(torch.cat(idx.shards)[:m], idx.host_target)
    np.testing.assert_array_equal(idx.refer, single.index.refer)


def test_sharded_batching_coalesces_and_matches(pair):
    single, sharded = pair
    svc = ShardedBatchingRetrievalService(
        single.backbone, single.index, SHARDS, preprocess=TF, default_k=5,
        max_batch=8, max_delay_s=0.05)
    names = single.index.names[:6]
    with concurrent.futures.ThreadPoolExecutor(6) as ex:
        futs = {n: ex.submit(svc.query_by_name, n, "brighter", 3)
                for n in names}
    for n, fut in futs.items():
        assert [r["name"] for r in fut.result()] == [
            r["name"] for r in single.query_by_name(n, "brighter", k=3)]
    assert svc.metrics()["dispatches"] < len(names)


def test_int8_gallery_matches_dequant_oracle(pair):
    single, _ = pair
    bb = single.backbone
    qbank = quantize_bank(single.index.target)
    q_index = GalleryIndex(target=qbank, refer=single.index.refer,
                           names=single.index.names)
    oracle = RetrievalService(bb, GalleryIndex(
        target=qbank.dequantize(), refer=single.index.refer,
        names=single.index.names), default_k=5)
    svc_q = RetrievalService(bb, q_index, preprocess=TF, default_k=5)
    svc_qs = ShardedRetrievalService(bb, q_index, SHARDS, preprocess=TF,
                                     default_k=5)
    assert svc_qs.index.shards[0].values.dtype == torch.int8
    for name in single.index.names[:3]:
        want = oracle.query_by_name(name, "make it blue", k=4)
        got = svc_q.query_by_name(name, "make it blue", k=4)
        _same(svc_qs.query_by_name(name, "make it blue", k=4), got)
        assert [r["name"] for r in got] == [r["name"] for r in want]
        np.testing.assert_allclose([r["score"] for r in got],
                                   [r["score"] for r in want], atol=1e-5)
    imgs = np.stack([TF(Image.fromarray(np.full((40, 40, 3), v, np.uint8)))
                     for v in (30, 200)])
    assert svc_q.add_images(["q0", "q1"], imgs) == svc_qs.add_images(
        ["q0", "q1"], imgs)
    ref = single.index.names[0]
    _same(svc_qs.query_by_name(ref, "a fresh look", k=6),
          svc_q.query_by_name(ref, "a fresh look", k=6))
    assert svc_qs.metrics()["gallery_dtype"] == "int8"


class _MQBackbone:
    """A blip2-like scorer: max over the query tokens of each image."""

    device = torch.device("cpu")

    def score_queries(self, q, gallery):
        return infonce.max_query_scores(q, gallery)


def _jax_service(backbone, gallery, shards):
    """The JAX package's sharded service (no fusion needed) over `shards`
    CPU devices of the conftest mesh."""
    mesh = jax_make_mesh(data=1, bank=shards,
                         devices=jax.devices()[:shards])
    svc = jsharded.ShardedRetrievalService.__new__(
        jsharded.ShardedRetrievalService)
    svc.mesh, svc._scorer_cache, svc.backbone = mesh, {}, backbone
    m = gallery.shape[0]
    idx = jsharded.ShardedGalleryIndex.from_arrays(
        gallery, np.zeros((m, 1), np.float32), [f"g{i}" for i in range(m)],
        mesh)
    return svc, idx


@pytest.mark.parametrize("quant", [False, True])
def test_maxquery_gallery_shards_match_jax(quant, rng):
    """(M, Q, D) galleries shard row-wise; the two-stage top-k equals the
    JAX package's sharded service and the one-shard service."""
    m, nq, d = 13, 4, 8
    gallery = rng.standard_normal((m, nq, d)).astype(np.float32)
    queries = rng.standard_normal((2, d)).astype(np.float32)
    gids = np.asarray([0, -1])
    target = torch.from_numpy(gallery)
    if quant:
        target = quantize_bank(target)
    bb = _MQBackbone()
    svc = ShardedRetrievalService(bb, GalleryIndex(
        target=target, refer=np.zeros((m, 1), np.float32),
        names=[f"g{i}" for i in range(m)]), ["cpu"] * 4)
    vals, ids = svc._score_topk(svc.index, torch.from_numpy(queries), gids, 5)
    one = RetrievalService(bb, GalleryIndex(
        target=target, refer=np.zeros((m, 1), np.float32),
        names=[f"g{i}" for i in range(m)]))
    v1, i1 = one._score_topk(one.index, torch.from_numpy(queries), gids, 5)
    assert torch.equal(ids, i1)
    torch.testing.assert_close(vals, v1, atol=1e-6, rtol=1e-6)
    if not quant:
        from spn4cir_tpu.ops import infonce as jinfonce

        class JaxMQ:
            def score_queries(self, q, g):
                return jinfonce.max_query_scores(q, g)

        jsvc, jidx = _jax_service(JaxMQ(), gallery, 4)
        jv, ji = jsvc._score_topk(jidx, jnp.asarray(queries), gids, 5)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
        np.testing.assert_allclose(vals.numpy(), np.asarray(jv), atol=1e-6)


def test_ties_come_in_the_jax_order(rng):
    """Rows with equal scores (duplicated gallery rows) come lowest global
    index first, across shards too, as the JAX sharded service orders
    them."""
    base = rng.standard_normal((5, 8)).astype(np.float32)
    gallery = base[[0, 1, 2, 1, 3, 1, 4, 2, 1, 0, 2]]     # 11 rows
    queries = rng.standard_normal((3, 8)).astype(np.float32)
    gids = np.asarray([-1, 4, -1])

    class Dot:
        device = torch.device("cpu")

        def score_queries(self, q, g):
            return q.float() @ g.float().T

    class JaxDot:
        def score_queries(self, q, g):
            return q @ g.T

    svc = ShardedRetrievalService(Dot(), GalleryIndex(
        target=torch.from_numpy(gallery), refer=np.zeros((11, 1), np.float32),
        names=[f"g{i}" for i in range(11)]), ["cpu"] * 4)
    vals, ids = svc._score_topk(svc.index, torch.from_numpy(queries), gids,
                                10)
    jsvc, jidx = _jax_service(JaxDot(), gallery, 4)
    jv, ji = jsvc._score_topk(jidx, jnp.asarray(queries), gids, 10)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    # within each run of equal scores the ids rise
    for row_v, row_i in zip(vals.numpy(), ids.numpy()):
        for a in range(9):
            if row_v[a] == row_v[a + 1]:
                assert row_i[a] < row_i[a + 1]


def test_serve_cli_sharded_over_http(tmp_path):
    """`cli.serve --mesh_bank 2 --device cpu`: the gallery in two shards on
    the CPU, micro-batching, queried over HTTP; the answers are the
    one-shard service's."""
    from torch_fixtures import synthetic_tokenizer

    root = make_fiq(str(tmp_path / "fiq"))
    server, service = serve_main(
        ["--dataset", "fiq", "--data_path", root, "--clip-model-name",
         "test-tiny", "--batch-size", "4", "--dress_types", "dress",
         "--mesh_bank", "2", "--serve_batch", "4", "--serve_host",
         "127.0.0.1", "--serve_port", "0", "--no-block", "--device", "cpu"],
        tokenizer=synthetic_tokenizer())
    try:
        assert isinstance(service, ShardedRetrievalService)
        assert len(service.index.shards) == 2
        port = server.server_address[1]
        name = service.index.names[0]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/retrieve",
            data=json.dumps({"reference_name": name, "caption": "make it red",
                             "k": 3}).encode(),
            headers={"Content-Type": "application/json"})
        results = json.loads(
            urllib.request.urlopen(req, timeout=60).read())["results"]
        one = RetrievalService(service.backbone, GalleryIndex(
            target=service.index.host_target, refer=service.index.refer,
            names=service.index.names))
        assert results == one.query_by_name(name, "make it red", k=3)
    finally:
        server.shutdown()
        server.server_close()
