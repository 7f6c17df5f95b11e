"""The port's serving slice against the JAX package: gallery index,
retrieval service (single and micro-batched), the HTTP front, the int8
gallery and the serving CLI, on a fixture gallery on the CPU.

Both services hold the same weights (converted by `clip_state_dict_from_jax`)
and tokenize with the same synthetic-merges tokenizer (the JAX backbone's
`tokenize` is replaced on the instance). Tolerances: top-k names identical,
scores within 1e-5 (float32). The fixture's features are random and do not
tie; `test_tied_scores_come_in_jax_top_k_order` makes exact ties from
duplicated gallery rows, where the order among equal scores is checked.
The port decodes images with PIL (its copy of the datasets module has no
native loader), so the JAX index is extracted with `SPN4CIR_NATIVE=0` too:
both sides then see the same pixels.
"""

import base64
import io
import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from spn4cir_tpu.data.datasets import CIRDataset
from spn4cir_tpu.data.transforms import ImageTransform
from spn4cir_tpu.eval.retrieval import (GalleryIndex as JaxGalleryIndex,
                                        extract_index_features as jax_extract)
from spn4cir_tpu.models.api import build_backbone as jax_build_backbone
from spn4cir_tpu.ops.bank_kernels import quantize_bank as jax_quantize_bank
from spn4cir_tpu.serve import RetrievalService as JaxRetrievalService
from spn4cir_tpu.tokenizer.bpe import tokenize
from spn4cir_tpu_torch.cli.serve import serve_main
from spn4cir_tpu_torch.data.datasets import CIRDataset as TorchCIRDataset
from spn4cir_tpu_torch.data.transforms import \
    ImageTransform as TorchImageTransform
from spn4cir_tpu_torch.eval.retrieval import GalleryIndex, extract_index_features
from spn4cir_tpu_torch.models.clip4cir import ClipCIR
from spn4cir_tpu_torch.models.convert import clip_state_dict_from_jax
from spn4cir_tpu_torch.ops.bank_kernels import QuantBank, quantize_bank
from spn4cir_tpu_torch.serve import (BatchingRetrievalService,
                                     RetrievalService, serve)
from tests.fixtures import make_cirr, make_fiq
from tests.torch_fixtures import synthetic_tokenizer

torch.set_num_threads(1)

TF = ImageTransform("targetpad", 32)
CAPTIONS = ["make it like number 7 but red", "is darker and has longer sleeves",
            "a zebra on the beach"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX and port backbones with shared weights and one tokenizer, the
    fixture gallery, and both float32 indexes."""
    tok = synthetic_tokenizer()
    root = make_fiq(str(tmp_path_factory.mktemp("fiq")))
    classic = CIRDataset("fiq", "val", "classic", TF, root, ["dress"])
    jb = jax_build_backbone("clip", clip_model_name="test-tiny")
    jb.tokenize = lambda texts: tokenize(texts, context_length=77,
                                         truncate=True, tokenizer=tok)
    params = jax.jit(jb.init_params)(jax.random.PRNGKey(0))
    tb = ClipCIR("test-tiny", tokenizer=tok)
    tb.model.load_state_dict(
        clip_state_dict_from_jax(jax.device_get(params), tb.cfg))
    tb.eval()
    old = os.environ.get("SPN4CIR_NATIVE")
    os.environ["SPN4CIR_NATIVE"] = "0"   # read once per dataset, at first decode
    try:
        jax_index = jax_extract(jb, params, classic, 4, num_workers=0)
    finally:
        if old is None:
            del os.environ["SPN4CIR_NATIVE"]
        else:
            os.environ["SPN4CIR_NATIVE"] = old
    tclassic = TorchCIRDataset("fiq", "val", "classic", TF, root, ["dress"])
    return dict(
        tok=tok, root=root, jb=jb, params=params, tb=tb, jax_index=jax_index,
        index=extract_index_features(tb, tclassic, 4, num_workers=0))


def _names(results):
    return [r["name"] for r in results]


def _assert_same_results(got, want):
    assert _names(got) == _names(want)
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], atol=1e-5, rtol=0)


def test_index_matches_jax(world):
    index, jax_index = world["index"], world["jax_index"]
    assert index.names == jax_index.names
    np.testing.assert_allclose(index.target.numpy(), np.asarray(jax_index.target),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(index.refer, np.asarray(jax_index.refer),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("gallery_dtype", ["float32", "int8"])
def test_query_by_name_matches_jax(world, gallery_dtype):
    index, jax_index = world["index"], world["jax_index"]
    if gallery_dtype == "int8":
        index = GalleryIndex(quantize_bank(index.target), index.refer,
                             index.names)
        jax_index = JaxGalleryIndex(jax_quantize_bank(jax_index.target),
                                    jax_index.refer, jax_index.names)
    ours = RetrievalService(world["tb"], index, preprocess=TF, default_k=5)
    ref = JaxRetrievalService(world["jb"], world["params"], jax_index,
                              preprocess=TF, default_k=5)
    for i, name in enumerate(index.names):
        caption = CAPTIONS[i % len(CAPTIONS)]
        got = ours.query_by_name(name, caption)
        assert len(got) == 5 and name not in _names(got)
        assert all(a["score"] >= b["score"] for a, b in zip(got, got[1:]))
        _assert_same_results(got, ref.query_by_name(name, caption))


def test_tied_scores_come_in_jax_top_k_order(world):
    """A gallery of a few hundred rows in which every image appears many
    times: the scores tie in groups, and the top 16 must hold the same ids
    in the same order as the JAX service's `jax.lax.top_k` (the lower
    gallery id first), the members of a tied group cut at k included."""
    index, jax_index = world["index"], world["jax_index"]
    n = len(index.names)
    m = 300
    rows = np.arange(m) % n
    names = [f"dup{i:03d}_{index.names[r]}" for i, r in enumerate(rows)]
    ours = RetrievalService(world["tb"], GalleryIndex(
        index.target[torch.from_numpy(rows)], index.refer[rows], names),
        preprocess=TF, default_k=16)
    ref = JaxRetrievalService(world["jb"], world["params"], JaxGalleryIndex(
        np.asarray(jax_index.target)[rows], np.asarray(jax_index.refer)[rows],
        names), preprocess=TF, default_k=16)
    for i in (0, 1, n + 2, m - 1):
        caption = CAPTIONS[i % len(CAPTIONS)]
        got = ours.query_by_name(names[i], caption, k=16)
        assert len(got) == 16 and names[i] not in _names(got)
        _assert_same_results(got, ref.query_by_name(names[i], caption, k=16))


def test_int8_gallery_quantizes_like_jax(world):
    ours = quantize_bank(world["index"].target)
    want = jax_quantize_bank(world["jax_index"].target)
    np.testing.assert_allclose(ours.scales.numpy(), np.asarray(want.scales),
                               rtol=1e-4)
    diff = np.abs(ours.values.numpy().astype(int) - np.asarray(want.values))
    assert diff.max() <= 1  # features differ ~1e-7: at most a rounding step
    assert ours.values.dtype == torch.int8


def test_query_by_image_matches_jax(world, rng):
    img = Image.fromarray(rng.randint(0, 256, (40, 40, 3), dtype=np.uint8))
    ours = RetrievalService(world["tb"], world["index"], preprocess=TF)
    ref = JaxRetrievalService(world["jb"], world["params"], world["jax_index"],
                              preprocess=TF)
    _assert_same_results(ours.query_by_image(img, CAPTIONS[0], k=4),
                         ref.query_by_image(img, CAPTIONS[0], k=4))


def test_batching_service_matches_single_queries(world):
    index = world["index"]
    single = RetrievalService(world["tb"], index, default_k=5)
    batching = BatchingRetrievalService(world["tb"], index, max_batch=8,
                                        max_delay_s=0.05, default_k=5)
    jobs = [(name, CAPTIONS[i % 3]) for i, name in enumerate(index.names)]
    results = [None] * len(jobs)

    def ask(i):
        results[i] = batching.query_by_name(*jobs[i])

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for job, got in zip(jobs, results):
        _assert_same_results(got, single.query_by_name(*job))
    assert batching.metrics()["dispatches"] < len(jobs)  # coalesced
    with pytest.raises(KeyError):
        batching.query_by_name("nope", "caption")


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        return json.loads(r.read())


def _b64_png(rng):
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (40, 40, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_http_front(world, rng):
    service = BatchingRetrievalService(world["tb"], world["index"],
                                       preprocess=TF, max_batch=4)
    server = serve(service, host="127.0.0.1", port=0)
    port = server.server_address[1]
    try:
        assert _get(port, "/healthz") == {"status": "ok", "gallery_size": 12}
        name = world["index"].names[3]
        out = _post(port, "/retrieve", {"reference_name": name,
                                        "caption": CAPTIONS[1], "k": 3})
        _assert_same_results(out["results"],
                             service.query_by_name(name, CAPTIONS[1], 3))
        out = _post(port, "/retrieve", {"image_b64": _b64_png(rng),
                                        "caption": CAPTIONS[2], "k": 2})
        assert len(out["results"]) == 2
        added = _post(port, "/gallery/add",
                      {"images": {"new_a": _b64_png(rng),
                                  "new_b": _b64_png(rng)}})
        assert added == {"status": "ok", "gallery_size": 14}
        out = _post(port, "/retrieve", {"reference_name": "new_b",
                                        "caption": CAPTIONS[0], "k": 13})
        assert len(out["results"]) == 13 and "new_b" not in _names(out["results"])
        metrics = _get(port, "/metrics")
        assert metrics["queries"] == 4 and metrics["gallery_size"] == 14
        assert metrics["gallery_dtype"] == "float32"
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, "/retrieve", {"reference_name": "nope", "caption": "x"})
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()


def test_add_images_extends_an_int8_gallery(world, rng):
    index = world["index"]
    qindex = GalleryIndex(quantize_bank(index.target), index.refer, index.names)
    service = RetrievalService(world["tb"], qindex, preprocess=TF)
    images = [Image.fromarray(rng.randint(0, 256, (40, 40, 3), dtype=np.uint8))
              for _ in range(2)]
    assert service.add_images(["x0", "x1"], images) == 14
    target = service.index.target
    assert isinstance(target, QuantBank) and target.values.shape == (14, 32)
    with pytest.raises(KeyError):
        service.add_images(["x0"], images[:1])


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_gallery_index_save_load_round_trip(world, kind, tmp_path):
    index = world["index"]
    target = {"float32": index.target,
              "bfloat16": index.target.to(torch.bfloat16),
              "int8": quantize_bank(index.target)}[kind]
    GalleryIndex(target, index.refer, index.names).save(str(tmp_path / "idx"))
    assert os.path.exists(tmp_path / "idx.npz")  # the .npz suffix rule
    back = GalleryIndex.load(str(tmp_path / "idx"))
    assert back.names == index.names
    np.testing.assert_array_equal(back.refer, index.refer)
    if kind == "int8":
        assert torch.equal(back.target.values, target.values)
        assert torch.equal(back.target.scales, target.scales)
    else:
        assert back.target.dtype == target.dtype
        assert torch.equal(back.target, target)


def _serve_argv(root, *extra):
    return ["--dataset", "cirr", "--data_path", root,
            "--clip-model-name", "test-tiny", "--device", "cpu",
            "--serve_host", "127.0.0.1", "--serve_port", "0", "--no-block",
            "--batch-size", "4", *extra]


def test_serve_main_end_to_end(world, tmp_path):
    root = make_cirr(str(tmp_path / "cirr"))
    ckpt = tmp_path / "clip4cir.pt"
    torch.save({"CLIP": world["tb"].model.state_dict()}, ckpt)
    cache = str(tmp_path / "index")
    server, service = serve_main(
        _serve_argv(root, "--model_path", str(ckpt), "--serve_batch", "4",
                    "--gallery_dtype", "int8", "--index_cache", cache),
        tokenizer=world["tok"])
    port = server.server_address[1]
    try:
        assert isinstance(service, BatchingRetrievalService)
        assert isinstance(service.index.target, QuantBank)
        names = service.index.names
        assert len(names) == 14 and os.path.exists(cache + ".npz")
        results = {}

        def ask(name):
            results[name] = _post(port, "/retrieve", {
                "reference_name": name, "caption": CAPTIONS[0], "k": 5})

        threads = [threading.Thread(target=ask, args=(n,)) for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for name in names:
            got = results[name]["results"]
            assert len(got) == 5 and name not in _names(got)
            assert set(_names(got)) <= set(names)
            assert all(a["score"] >= b["score"] for a, b in zip(got, got[1:]))
    finally:
        server.shutdown()
        server.server_close()

    # the loaded checkpoint holds the fixture weights: same gallery features
    # (decoded as the CLI decodes them, with the port's own transform)
    classic = TorchCIRDataset("cirr", "val", "classic",
                              TorchImageTransform("targetpad", 32), root)
    direct = extract_index_features(world["tb"], classic, 4, num_workers=0)
    np.testing.assert_array_equal(service.index.refer, direct.refer)

    # a restart loads the cached index instead of re-encoding
    server2, service2 = serve_main(_serve_argv(root, "--index_cache", cache),
                                   tokenizer=world["tok"])
    try:
        assert torch.equal(service2.index.target.values,
                           service.index.target.values)
    finally:
        server2.shutdown()
        server2.server_close()


@pytest.mark.parametrize("extra,error", [
    (("--clip-model-name", "test-tiny", "--text_max_len", "40"),
     NotImplementedError),
    (("--clip-model-name", "test-tiny", "--mesh_data", "2"), SystemExit),
    (("--clip-model-name", "test-tiny", "--device_preprocess",
      "--distributed"), SystemExit),
    (("--clip-model-name", "test-tiny", "--device_canvas", "448"),
     SystemExit),
    (("--clip-model-name", "test-tiny", "--dropout", "0.1"),
     NotImplementedError),
    (("--clip-model-name", "test-tiny", "--val_ret_train"),
     NotImplementedError),
])
def test_serve_main_refuses_what_is_not_ported(extra, error, tmp_path):
    argv = ["--dataset", "cirr", "--data_path", str(tmp_path), "--device",
            "cpu", "--no-block", *extra]
    with pytest.raises(error):
        serve_main(argv)


def test_cuda_device_without_cuda_raises():
    from spn4cir_tpu_torch.cli.common import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("0")


def test_port_imports_no_jax(tmp_path):
    """Importing every module of the port, with JAX_PLATFORMS=cpu set in the
    child's environment, leaves neither jax nor the JAX package
    `spn4cir_tpu` in sys.modules: the port keeps its own copies of the host
    modules it needs. Then the child, a script that holds torch, starts the
    multi-process loader: under `-X importtime` (which spawn hands on to
    its children) every import of its workers is logged after the marker,
    and none is of torch, jax or spn4cir_tpu, not even through the parent's
    script, which spawn would run again in each worker as `__mp_main__`."""
    from PIL import Image

    image = str(tmp_path / "im.png")
    Image.fromarray(np.zeros((40, 30, 3), np.uint8)).save(image)
    script = tmp_path / "imports.py"
    script.write_text(
        "import pkgutil, importlib, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import spn4cir_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    spn4cir_tpu_torch.__path__, 'spn4cir_tpu_torch.')]\n"
        "assert len(names) > 20, names\n"
        "for new in ('cli.validate', 'cli.submission', 'eval.submission',\n"
        "            'models.blip4cir', 'models.blip_vit', 'models.med',\n"
        "            'tokenizer.wordpiece', 'train.stage1',\n"
        "            'models.blip24cir', 'models.eva_vit', 'models.qformer',\n"
        "            'ops.maxquery_kernels', 'datagen.llm_rewrite',\n"
        "            'models.llama', 'ops.decode_attn', 'ops.quant_matmul',\n"
        "            'cli.get_cir_data', 'models.llava', 'models.blip_caption',\n"
        "            'models.generation', 'datagen.captioner', 'serve.mllm',\n"
        "            'cli.serve_mllm', 'cli.captioner', 'eval.cases',\n"
        "            'eval.generic_retrieval', 'cli.validate_case',\n"
        "            'cli.analysis_case', 'cli.retrieval', 'native',\n"
        "            'tokenizer.native_bpe', 'data.mploader', 'ops.preprocess',\n"
        "            'parallel.mesh', 'parallel.loss', 'parallel.train',\n"
        "            'parallel.tp', 'serve.sharded'):\n"
        "    assert 'spn4cir_tpu_torch.' + new in names, new\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'spn4cir_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
        "from spn4cir_tpu_torch.data.mploader import MPLoader\n"
        "print('WORKERS-START', file=sys.stderr, flush=True)\n"
        "with MPLoader('clip', 32, batch_size=2, num_procs=2,\n"
        "              threads_per_proc=1) as loader:\n"
        f"    for arr, n in loader.map_batches([[{image!r}] * 2] * 3):\n"
        "        assert n == 2 and arr.shape == (2, 32, 32, 3)\n"
        "print('ok')\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("SPN4CIR_NATIVE", None)
    out = subprocess.run([sys.executable, "-X", "importtime", str(script)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        out.stderr[-3000:]
    workers = out.stderr.split("WORKERS-START", 1)[1].splitlines()
    mods = [line.rsplit("|", 1)[-1].strip() for line in workers
            if line.startswith("import time:")]
    assert "spn4cir_tpu_torch.native" in mods, workers[-20:]
    bad = sorted({m for m in mods if m.split(".")[0] in
                  ("torch", "jax", "jaxlib", "spn4cir_tpu")})
    assert not bad, bad
