"""The port's captioning stage against the JAX package's: the datagen core
(datagen/captioner.py), the caption service (serve/mllm.py) and the two
entry points (cli.captioner, cli.serve_mllm).

Both captioners run at tiny width on the CPU: LLaVA `tiny` (byte tokenizer)
and BLIP `test-tiny`, with the JAX package's random weights carried into
the port (`llava_state_dict_from_jax`, `blip_caption_state_dict_from_jax`).
Images and synthetic dataset trees (tests/fixtures.py) come from seeds.

What must be equal: the it-list files (paths and contents), the sidecar
read with a torn last line, the stub captions, and the captions of
`batched_fn` (LLaVA at T=0.01 / top_p=0.01 with float32 and int8 weights,
BLIP with beam search), which are deterministic in both packages. The
service and the CLIs are held to the JAX tests' contracts.
"""

import base64
import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from spn4cir_tpu.datagen import captioner as jcap
from spn4cir_tpu_torch.cli import captioner as cli_captioner
from spn4cir_tpu_torch.cli import serve_mllm
from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.datagen import captioner as tcap
from spn4cir_tpu_torch.models import llama as tl
from spn4cir_tpu_torch.models.convert import (blip_caption_state_dict_from_jax,
                                              llava_state_dict_from_jax)
from spn4cir_tpu_torch.models.llava import LlavaConfig
from spn4cir_tpu_torch.serve.mllm import CaptionService, serve_captions
from tests.fixtures import make_cirr, make_fiq

torch.set_num_threads(1)


def _images(seed, n, size):
    return list(np.random.RandomState(seed).rand(n, size, size, 3)
                .astype(np.float32))


def _png_b64(rng, size=16):
    img = Image.fromarray((rng.standard_normal((size, size, 3)) * 40 + 128)
                          .clip(0, 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


# ---------------------------------------------------------------------------
# the it-list contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data,kw", [
    ("fiq", {}), ("cirr", {}), ("cirr", {"prefix": "x"}),
    ("zs", {"filename": "cc_it_32_llava_10.json"})])
def test_write_it_list_matches_jax(tmp_path, data, kw):
    it_list = [{"image_id": "a", "caption": "a red dress"},
               {"image_id": "b", "caption": "two dogs"}]
    got = tcap.write_it_list(it_list, data, "llava", 10,
                             out_root=str(tmp_path / "t"), **kw)
    want = jcap.write_it_list(it_list, data, "llava", 10,
                              out_root=str(tmp_path / "j"), **kw)
    assert os.path.relpath(got, tmp_path / "t") == os.path.relpath(
        want, tmp_path / "j")
    with open(got) as f, open(want) as g:
        assert f.read() == g.read()


def test_caption_prompt_and_cc_shard_match_jax(tmp_path):
    assert tcap.caption_prompt("dress", 7) == jcap.caption_prompt("dress", 7)
    path = tmp_path / "part_0.data"
    rows = [{"url": f"u{i}", "image": f"/img/{i}.jpg",
             "caption": {"en": f"caption {i}", "de": "x"}} for i in range(3)]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    assert tcap.load_cc_shard(str(path)) == jcap.load_cc_shard(str(path))


def test_sidecar_with_a_torn_last_line_reads_as_jax(tmp_path):
    path = tmp_path / "side.jsonl"
    path.write_text('{"image_id": "a", "caption": "x"}\n\n'
                    '{"image_id": "b", "caption": "y"}\n'
                    '{"image_id": "c", "capt')
    got = tcap.load_caption_checkpoint(str(path))
    assert got == jcap.load_caption_checkpoint(str(path)) == {"a": "x",
                                                              "b": "y"}
    assert tcap.load_caption_checkpoint(str(tmp_path / "none")) == {}


def test_batched_captions_fill_the_sidecar_and_resume(tmp_path):
    images = _images(0, 5, 4)
    names = [f"n{i}" for i in range(5)]
    calls = []

    def fn(batch):
        calls.append(len(batch))
        return [f"cap {float(b.mean()):.4f}" for b in batch]

    for pkg, side in ((tcap, tmp_path / "t.jsonl"),
                      (jcap, tmp_path / "j.jsonl")):
        out = pkg.caption_images_batched(zip(names, images), fn, batch_size=2,
                                         checkpoint_path=str(side))
        assert [o["image_id"] for o in out] == names
    assert calls == [2, 2, 1, 2, 2, 1]
    assert (tmp_path / "t.jsonl").read_text() == (
        tmp_path / "j.jsonl").read_text()
    done = tcap.load_caption_checkpoint(str(tmp_path / "t.jsonl"))
    rest = tcap.caption_images_batched(
        [(n, i) for n, i in zip(names, images) if n not in done], fn,
        already=done)
    assert len(rest) == 5 and calls == [2, 2, 1, 2, 2, 1]


def test_stub_captions_match_jax():
    rng = np.random.RandomState(3)
    for img in [rng.rand(8, 8, 3), rng.rand(8, 8, 3) * 255,
                np.zeros((4, 4, 3)), np.full((4, 4, 3), 250.0)]:
        assert (tcap.stub_captioner(img, "p")
                == jcap.stub_captioner(img, "p"))


# ---------------------------------------------------------------------------
# the two captioners at tiny width
# ---------------------------------------------------------------------------

def _llava_pair(quantize=False):
    from spn4cir_tpu.models.llava import LlavaCaptioner, LlavaConfig as JCfg
    from spn4cir_tpu.tokenizer.bytelevel import ByteTokenizer as JTok

    params = jax.device_get(LlavaCaptioner(JCfg.tiny(258), JTok()).init_params(
        jax.random.PRNGKey(4)))
    kw = dict(llava_size="tiny", batch_size=2, max_new_tokens=8,
              quantize_weights=quantize)
    _, _, jfn = jcap.make_llava_captioner(params, **kw)
    sd = llava_state_dict_from_jax(params, LlavaConfig.tiny(258))
    cap, transform, tfn = tcap.make_llava_captioner(sd, device="cpu", **kw)
    return jfn, cap, transform, tfn


@pytest.mark.parametrize("quantize", [False, True])
def test_llava_batched_captions_match_jax(quantize, monkeypatch):
    """Three images in batches of 2 (the last padded), float32 weights and
    int8 ones; the int8 products dequantize after the matmul: kernel #12's
    wrapper is never called unless the caller asks for it."""
    jfn, cap, transform, tfn = _llava_pair(quantize)
    calls = []
    real = tl.quant_matmul
    monkeypatch.setattr(tl, "quant_matmul",
                        lambda *a: calls.append(1) or real(*a))
    images = _images(5, 3, 28)
    for prompt in (None, "what color is it"):
        kw = {} if prompt is None else {"prompt": prompt}
        assert tfn(images, **kw) == jfn(images, **kw)
    assert calls == []
    assert cap.quant_kernel is False
    assert isinstance(cap.lm_params, dict) == quantize
    assert transform.kind == "clip" and transform.dim == 28
    if quantize:
        assert cap.model.lm_head.weight.numel() == 0  # the dense LM released
        cap.quant_kernel = True
        tfn(images[:1])
        assert calls


def test_blip_batched_captions_match_jax():
    from spn4cir_tpu.models.blip_caption import BlipCaptioner as JCap

    params = jax.device_get(JCap("test-tiny").init_params(
        jax.random.PRNGKey(2)))
    kw = dict(blip_size="test-tiny", batch_size=2, max_length=20,
              min_length=4)
    _, _, jfn = jcap.make_blip_captioner(params, **kw)
    cap, transform, tfn = tcap.make_blip_captioner(
        blip_caption_state_dict_from_jax(params), device="cpu", **kw)
    images = _images(6, 3, 32)
    assert tfn(images) == jfn(images)
    assert transform.kind == "blip_eval" and cap.input_dim == 32


def test_unported_captioner_options_are_refused():
    with pytest.raises(SystemExit):
        tcap.make_llava_captioner(None, tokenizer_path="tok",
                                  llava_size="tiny", device="cpu")
    with pytest.raises(ValueError):
        tcap.make_llava_captioner(None, mesh=object(), llava_size="tiny",
                                  device="cpu")
    with pytest.raises(ValueError):  # a 7B needs a tokenizer object
        tcap.make_llava_captioner(None, device="cpu")
    for argv in (["--tokenizer_path", "x"], ["--mesh_model", "2"]):
        with pytest.raises(SystemExit):
            cli_captioner.main(["--cir_data", "cirr", "--mllm", "llava",
                                *argv])
        with pytest.raises(SystemExit):
            serve_mllm.main(["--no-block", "--device", "cpu", *argv])


def test_captioners_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default is then valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcap.make_llava_captioner(None, llava_size="tiny")


# ---------------------------------------------------------------------------
# the caption service
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_service():
    _, transform, batched_fn = tcap.make_llava_captioner(
        None, llava_size="tiny", batch_size=2, max_new_tokens=6,
        device="cpu")
    return CaptionService(batched_fn, transform, model_name="llava",
                          max_batch=2, max_delay_s=0.01,
                          default_prompt="describe the image in 5 words")


def test_caption_service_coalesces_concurrent_requests(tiny_service, rng):
    img = Image.fromarray((rng.standard_normal((16, 16, 3)) * 40 + 128)
                          .clip(0, 255).astype(np.uint8))
    caps = tiny_service.caption([img, img])
    assert len(caps) == 2 and all(isinstance(c, str) for c in caps)
    before = tiny_service.metrics()["batches_dispatched"]
    results = {}

    def worker(i):
        results[i] = tiny_service.caption([img])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 2 and results[0] == results[1] == caps[:1]
    assert tiny_service.metrics()["batches_dispatched"] - before <= 2
    m = tiny_service.metrics()
    assert m["images"] >= 4 and m["requests"] >= 3


def test_caption_http_endpoints(tiny_service, rng):
    server = serve_captions(tiny_service, host="127.0.0.1", port=0)
    port = server.server_address[1]
    url = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(f"{url}/healthz") as r:
            assert json.load(r) == {"status": "ok", "model": "llava"}
        for payload, key, n in (
                ({"image_b64": _png_b64(rng)}, "caption", None),
                ({"images_b64": [_png_b64(rng), _png_b64(rng)],
                  "prompt": "what color is the dress"}, "captions", 2)):
            req = urllib.request.Request(
                f"{url}/caption", data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as r:
                out = json.load(r)
            assert (isinstance(out[key], str) if n is None
                    else len(out[key]) == n)
        for payload in ({"nothing": 1}, {"image_b64": "bm90IGFuIGltYWdl"}):
            req = urllib.request.Request(f"{url}/caption",
                                         data=json.dumps(payload).encode())
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req)
            assert err.value.code == 400
        with urllib.request.urlopen(f"{url}/metrics") as r:
            assert json.load(r)["requests"] >= 2
    finally:
        server.shutdown()


def test_caption_prompt_refused_when_unsupported(rng):
    svc = CaptionService(lambda images: ["a picture"] * len(images),
                         lambda im: np.asarray(im), model_name="blip",
                         max_batch=2, max_delay_s=0.001,
                         supports_prompt=False)
    with pytest.raises(ValueError):
        svc.caption([np.zeros((2, 2, 3))], "nope")
    server = serve_captions(svc, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}/caption"
    try:
        req = urllib.request.Request(url, data=json.dumps(
            {"image_b64": _png_b64(rng), "prompt": "nope"}).encode())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req)
        assert err.value.code == 400
        req = urllib.request.Request(url, data=json.dumps(
            {"image_b64": _png_b64(rng)}).encode())
        with urllib.request.urlopen(req) as r:
            assert json.load(r)["caption"] == "a picture"
    finally:
        server.shutdown()


def test_caption_group_failure_is_isolated():
    def batched_fn(images, prompt=None):
        if prompt == "bad":
            raise RuntimeError("boom")
        return ["ok"] * len(images)

    svc = CaptionService(batched_fn, lambda im: np.asarray(im),
                         max_batch=4, max_delay_s=0.05)
    img = np.zeros((4, 4, 3), np.uint8)
    results = {}

    def good():
        results["good"] = svc.caption([img], "fine")

    def bad():
        try:
            svc.caption([img], "bad")
        except RuntimeError as exc:
            results["bad"] = str(exc)

    threads = [threading.Thread(target=good), threading.Thread(target=bad)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == {"good": ["ok"], "bad": "boom"}


@pytest.mark.parametrize("mllm", ["llava", "blip"])
def test_serve_mllm_cli_tiny(mllm, rng):
    # BLIP reads --max_new_tokens as its max_length, prompt included
    size = ["--llava_size", "tiny", "--max_new_tokens", "8"] if (
        mllm == "llava") else ["--blip_size", "test-tiny",
                               "--max_new_tokens", "20"]
    server, service = serve_mllm.main([
        "--mllm", mllm, *size, "--batch_size", "2",
        "--port", "0", "--host", "127.0.0.1", "--device", "cpu",
        "--no-block"])
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/healthz") as r:
            assert json.load(r) == {"status": "ok", "model": mllm}
        req = urllib.request.Request(f"{url}/caption", data=json.dumps(
            {"images_b64": [_png_b64(rng), _png_b64(rng)]}).encode())
        with urllib.request.urlopen(req) as r:
            assert len(json.load(r)["captions"]) == 2
        assert service.supports_prompt == (mllm == "llava")
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# cli.captioner
# ---------------------------------------------------------------------------

def test_captioner_cli_blip_writes_resumes_and_samples(tmp_path, monkeypatch):
    root = make_cirr(str(tmp_path / "cirr"), n_images=6, extended=False)
    monkeypatch.chdir(tmp_path)
    argv = ["--mllm", "blip", "--blip_size", "test-tiny", "--cir_data",
            "cirr", "--data_path", root, "--batch_size", "4", "--device",
            "cpu"]
    out = cli_captioner.main(argv)
    assert os.path.relpath(out, tmp_path) == os.path.join(
        "mm_data", "cirr", "cirr_it_blip_10.json")
    with open(out) as f:
        first = json.load(f)
    names = CIRDataset("cirr", "train", "relative",
                       ImageTransform("targetpad", 224), root).imagenames
    side = (tmp_path / "mm_data" / "cirr"
            / ".cirr_it_blip_10.json.nockpt.partial.jsonl")
    assert set(tcap.load_caption_checkpoint(str(side))) == set(names)
    assert sorted(e["image_id"] for e in first) == sorted(names)
    assert all(isinstance(e["caption"], str) for e in first)

    # a fully resumed run loads no model
    def no_model(*a, **k):
        raise AssertionError("the resumed run loaded a model")

    monkeypatch.setattr(cli_captioner, "make_blip_captioner", no_model)
    cli_captioner.main(argv)
    with open(out) as f:
        assert sorted(map(str, json.load(f))) == sorted(map(str, first))
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    out = cli_captioner.main(argv + ["--nucleus", "--caption_ckpt", ""])
    with open(out) as f:
        assert len(json.load(f)) == len(names)


def test_captioner_cli_llava_fiq_loads_once_with_a_prompt_per_type(
        tmp_path, monkeypatch):
    root = make_fiq(str(tmp_path / "fiq"), dress_types=("dress", "shirt"),
                    n_images=4, n_train=3, extended=False)
    monkeypatch.chdir(tmp_path)
    loads, prompts = [], []
    real = cli_captioner.make_llava_captioner

    def counted(*a, **k):
        loads.append(1)
        cap, tf, fn = real(*a, **k)
        return cap, tf, lambda imgs, prompt=None: (
            prompts.append(prompt) or fn(imgs, prompt=prompt))

    monkeypatch.setattr(cli_captioner, "make_llava_captioner", counted)
    out = cli_captioner.main([
        "--mllm", "llava", "--llava_size", "tiny", "--cir_data", "fiq",
        "--data_path", root, "--dress_types", "dress,shirt", "--k", "5",
        "--max_new_tokens", "4", "--device", "cpu"])
    assert loads == [1]
    assert set(prompts) == {tcap.caption_prompt("dress", 5),
                            tcap.caption_prompt("shirt", 5)}
    assert out.endswith(os.path.join("fiq", "fashioniq_it_llava_5.json"))
    with open(out) as f:
        names = {e["image_id"] for e in json.load(f)}
    assert {n.split("_")[0] for n in names} == {"dress", "shirt"}


def test_captioner_cli_stub_matches_the_jax_core(tmp_path, monkeypatch):
    from spn4cir_tpu.data.datasets import CIRDataset as JaxDataset
    from spn4cir_tpu.data.transforms import ImageTransform as JaxTransform

    root = make_cirr(str(tmp_path / "cirr"), n_images=5, extended=False)
    monkeypatch.chdir(tmp_path)
    out = cli_captioner.main(["--cir_data", "cirr", "--data_path", root,
                              "--device", "cpu"])
    ds = JaxDataset("cirr", "train", "relative", JaxTransform("targetpad", 224),
                    root)
    want = jcap.caption_images(
        ((n, np.asarray(Image.open(p).convert("RGB")))
         for n, p in zip(ds.imagenames, ds.imagepaths)), jcap.stub_captioner)
    with open(out) as f:
        assert json.load(f) == want


def test_a_resume_after_a_torn_line_keeps_every_new_entry(tmp_path):
    side = tmp_path / "side.jsonl"
    side.write_text('{"image_id": "a", "caption": "x"}\n{"image_id": "b", "c')
    done = tcap.load_caption_checkpoint(str(side))
    out = tcap.caption_images_batched(
        [("b", np.zeros((2, 2, 3))), ("c", np.zeros((2, 2, 3)))],
        lambda imgs: ["new"] * len(imgs), batch_size=1,
        checkpoint_path=str(side), already=done)
    assert [e["image_id"] for e in out] == ["a", "b", "c"]
    assert tcap.load_caption_checkpoint(str(side)) == {
        "a": "x", "b": "new", "c": "new"}
