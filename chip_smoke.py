#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 in practice).

    python3 chip_smoke.py

Phases (one line or more each; any failure is an uncaught exception and a
non-zero exit):
  1. device: CUDA must be present; prints the card and its power limit and
     turns TF32 off for the comparisons;
  2. build: compiles the port's CUDA kernels from csrc/ with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the serving path's shapes, in bfloat16 and float32, with times;
  4. slice: `spn4cir_tpu_torch.cli.serve.serve_main` indexes a 2048-image
     synthetic CIRR gallery with ViT-B/32 in bf16 (random weights from seed
     0) and serves it over HTTP; 64 concurrent /retrieve requests (two
     rounds) and 32 sequential ones must return valid, reference-excluded,
     score-ordered results; the launch counter must show the kernel ran in
     every attention layer of both towers; 8 queries re-scored with the
     plain attention must keep their top-1.
The last three lines are the kernels JSON, the card's name and power limit
(nvidia-smi), and {"ok": true, "device": {...}}.

The CLIP merges file is not in the repository: the text goes through the
shared CLIP tokenizer built from a synthetic merges table
(tests/torch_fixtures.py), written to a temporary file that
SPN4CIR_BPE_VOCAB points at.
"""

from __future__ import annotations

import concurrent.futures
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# tolerances of the kernel-vs-plain comparisons (phase 3)
F32_TOL = 1e-5   # float32: only the summation order differs
BF16_TOL = 2e-2  # bf16: P is rounded to bf16 before P·V in both versions

VISION = dict(name="vision", bh=256 * 12, s=50, d=64, causal=False)
TEXT = dict(name="text", bh=32 * 8, s=77, d=64, causal=True)

N_GALLERY = 2048
ENCODE_BATCH = 256
SERVE_BATCH = 32
N_CONCURRENT = 64
N_SEQUENTIAL = 32
K = 10
CAPTIONS = ("make it like number 7 but red", "is darker and has longer sleeves",
            "the dress is shorter with a floral print",
            "change the dog to a cat sitting on the grass")


def load_test_module(name: str):
    """Import tests/<name>.py by path: `tests` is a directory without an
    __init__.py, and an installed package of that name would shadow it."""
    spec = importlib.util.spec_from_file_location(
        f"chip_smoke_{name}", os.path.join(REPO, "tests", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event timings."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernels(ak, device, card):
    """Phase 3: short_attention against its plain version, per shape and
    dtype; returns one record per comparison."""
    g = torch.Generator(device=device).manual_seed(0)
    records = []
    for shape in (VISION, TEXT):
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            bh, s, d, causal = shape["bh"], shape["s"], shape["d"], shape["causal"]
            q, k, v = (torch.randn(bh, s, d, generator=g, device=device,
                                   dtype=dtype) for _ in range(3))
            q = q * d ** -0.5
            with torch.inference_mode():
                got = ak.short_attention(q, k, v, causal)
                torch.cuda.synchronize()
                want = ak.short_attention_reference(q, k, v, causal)
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=tol)
                err = (got.float() - want.float()).abs().max().item()
                ms = median_ms(lambda: ak.short_attention(q, k, v, causal))
                plain_ms = median_ms(
                    lambda: ak.short_attention_reference(q, k, v, causal))
            rec = dict(shape=f"({bh}, {s}, {d})", tower=shape["name"],
                       causal=causal, dtype=str(dtype).replace("torch.", ""),
                       tol=tol, max_abs_err=err, ms=ms, plain_ms=plain_ms)
            records.append(rec)
            phase(f"kernel short_attention {rec['tower']} {rec['shape']} "
                  f"causal={causal} {rec['dtype']}: max_abs_err={err:.3e} "
                  f"(atol=rtol={tol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms [{card}]")
    return records


def post(port: int, payload: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/retrieve", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        body = json.loads(r.read())
    return body["results"], (time.perf_counter() - t0) * 1e3


def check_results(name: str, results, names: set) -> None:
    got = [r["name"] for r in results]
    scores = [r["score"] for r in results]
    assert len(results) == K, (name, len(results))
    assert set(got) <= names, (name, got)
    assert name not in got, f"{name}: reference not excluded"
    assert all(math.isfinite(x) for x in scores), (name, scores)
    assert all(a >= b for a, b in zip(scores, scores[1:])), (name, scores)


def pct(values, q: float) -> float:
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(math.ceil(q * len(vals))) - 1)]


def drive_slice(ak, layers, tmp, card):
    """Phase 4: the serving CLI end to end, then the checks."""
    import numpy as np

    from spn4cir_tpu.data.datasets import CIRDataset
    from spn4cir_tpu_torch.cli.serve import serve_main
    from spn4cir_tpu_torch.eval.retrieval import extract_index_features
    make_cirr = load_test_module("fixtures").make_cirr

    root = make_cirr(os.path.join(tmp, "cirr"), n_images=N_GALLERY,
                     extended=False)
    argv = ["--dataset", "cirr", "--data_path", root,
            "--clip-model-name", "ViT-B/32", "--bf16", "--seed", "0",
            "--batch-size", str(ENCODE_BATCH), "--serve_batch",
            str(SERVE_BATCH), "--default_k", str(K), "--device", "0",
            "--serve_host", "127.0.0.1", "--serve_port", "0", "--no-block"]

    # ---- the main path, counted ----
    ak.short_attention.launches = 0
    t0 = time.perf_counter()
    server, service = serve_main(argv)
    startup_s = time.perf_counter() - t0
    port = server.server_address[1]
    try:
        index = service.index
        names = list(index.names)
        name_set = set(names)
        rng = np.random.RandomState(0)
        rounds = []
        for _ in range(2):
            picks = rng.choice(len(names), N_CONCURRENT, replace=False)
            jobs = [(names[i], CAPTIONS[j % len(CAPTIONS)])
                    for j, i in enumerate(picks)]
            with concurrent.futures.ThreadPoolExecutor(N_CONCURRENT) as pool:
                futs = [pool.submit(post, port, {"reference_name": n,
                                                 "caption": c, "k": K})
                        for n, c in jobs]
                outs = [f.result() for f in futs]
            for (n, _), (results, _) in zip(jobs, outs):
                check_results(n, results, name_set)
            rounds.append([ms for _, ms in outs])
        sequential = []
        for j in range(N_SEQUENTIAL):
            n = names[int(rng.randint(len(names)))]
            results, ms = post(port, {"reference_name": n,
                                      "caption": CAPTIONS[j % len(CAPTIONS)],
                                      "k": K})
            check_results(n, results, name_set)
            sequential.append(ms)
        torch.cuda.synchronize()
        launches = ak.short_attention.launches
        dispatches = service.metrics()["dispatches"]
    finally:
        server.shutdown()
        server.server_close()

    backbone = service.backbone
    cfg = backbone.cfg
    encode_batches = math.ceil(N_GALLERY / ENCODE_BATCH)
    want = (cfg.vision_layers * encode_batches
            + cfg.transformer_layers * dispatches)
    phase(f"slice: {len(names)} images indexed in {encode_batches} encode "
          f"batches, {2 * N_CONCURRENT + N_SEQUENTIAL} queries in "
          f"{dispatches} fuse dispatches; short_attention launches "
          f"{launches} (want {cfg.vision_layers}*{encode_batches} + "
          f"{cfg.transformer_layers}*{dispatches} = {want})")
    assert launches == want, (launches, want)

    # ---- the outputs are right ----
    target = index.target
    assert target.shape == (N_GALLERY, cfg.embed_dim), target.shape
    assert torch.isfinite(target).all()
    norms = target.float().norm(dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-3), norms
    assert index.refer.shape == (N_GALLERY, cfg.embed_dim)

    with torch.inference_mode():
        # 8 queries re-scored with attention forced through the plain version
        gids = np.arange(8) * (N_GALLERY // 8)
        refer = index.refer_rows(gids)
        text = torch.from_numpy(backbone.tokenize(
            [CAPTIONS[j % len(CAPTIONS)] for j in range(8)])).to(refer.device)
        mask = torch.zeros(8, N_GALLERY, device=refer.device)
        mask[torch.arange(8), torch.from_numpy(gids)] = float("-inf")
        kern_scores = backbone.score_queries(backbone.fuse(refer, text),
                                             target) + mask
        layers.set_attention_impl(backbone, "plain")
        try:
            plain_scores = backbone.score_queries(backbone.fuse(refer, text),
                                                  target) + mask
        finally:
            layers.set_attention_impl(backbone, "auto")
        top_k = kern_scores.topk(2, dim=-1)
        top_p = plain_scores.topk(1, dim=-1).indices[:, 0]
        gaps = (top_k.values[:, 0] - top_k.values[:, 1]).tolist()
        phase(f"re-score with plain attention: top-1 kernel "
              f"{top_k.indices[:, 0].tolist()} plain {top_p.tolist()}; "
              f"max |score diff| "
              f"{(kern_scores - plain_scores)[mask == 0].abs().max().item():.3e}"
              f"; top-1/top-2 gaps min {min(gaps):.3e}")
        assert torch.equal(top_k.indices[:, 0], top_p), "top-1 changed"

    # the f32 tower on a small input: kernel route vs plain route
    res = cfg.image_resolution
    f32 = type(backbone.model)(cfg, dtype=torch.float32).to(refer.device)
    f32.load_state_dict(backbone.model.state_dict())
    images = torch.randn(4, res, res, 3,
                         generator=torch.Generator().manual_seed(1))
    images = images.to(refer.device)
    with torch.inference_mode():
        kern = f32.encode_image(images)
        layers.set_attention_impl(f32, "plain")
        plain = f32.encode_image(images)
        err = (kern - plain).abs().max().item()
        phase(f"f32 ViT-B/32 on 4 images, kernel vs plain attention: "
              f"max_abs_err {err:.3e} (atol 1e-4)")
        assert err < 1e-4, err
        del f32

        # device encode rate: one resident batch of ENCODE_BATCH images
        batch = torch.randn(ENCODE_BATCH, res, res, 3, device=refer.device,
                            generator=torch.Generator(refer.device).manual_seed(2))
        encode_ms = median_ms(lambda: backbone.index_features(batch),
                              reps=10, warmup=2)
        fuse_refer = index.refer_rows(np.arange(SERVE_BATCH))
        fuse_text = text[:1].expand(SERVE_BATCH, -1).contiguous()
        fuse_ms = median_ms(lambda: backbone.fuse(fuse_refer, fuse_text),
                            reps=20, warmup=3)

    # wall rate of the whole gallery index (host decode + resize included)
    classic = CIRDataset("cirr", "val", "classic", service.preprocess, root)
    t0 = time.perf_counter()
    extract_index_features(backbone, classic, ENCODE_BATCH, num_workers=0)
    index_s = time.perf_counter() - t0

    stats = dict(
        startup_s=startup_s,
        encode_device_img_s=ENCODE_BATCH / (encode_ms / 1e3),
        encode_batch_ms=encode_ms,
        index_wall_img_s=N_GALLERY / index_s,
        fuse_batch32_ms=fuse_ms,
        concurrent_round1_p50_ms=statistics.median(rounds[0]),
        concurrent_round1_p99_ms=pct(rounds[0], 0.99),
        concurrent_p50_ms=statistics.median(rounds[1]),
        concurrent_p99_ms=pct(rounds[1], 0.99),
        sequential_p50_ms=statistics.median(sequential),
        sequential_p99_ms=pct(sequential, 0.99),
        dispatches=dispatches)
    phase(f"ViT-B/32 bf16 encode: {stats['encode_device_img_s']:.1f} images/s "
          f"on the device (batch {ENCODE_BATCH}, {encode_ms:.3f} ms/batch); "
          f"whole-gallery index incl. host decode "
          f"{stats['index_wall_img_s']:.1f} images/s [{card}]")
    phase(f"query latency, {N_CONCURRENT} concurrent (second round): p50 "
          f"{stats['concurrent_p50_ms']:.2f} ms, p99 "
          f"{stats['concurrent_p99_ms']:.2f} ms; sequential: p50 "
          f"{stats['sequential_p50_ms']:.2f} ms, p99 "
          f"{stats['sequential_p99_ms']:.2f} ms; fuse of {SERVE_BATCH} "
          f"queries {fuse_ms:.3f} ms on the device [{card}]")
    phase("slice stats " + json.dumps(stats))
    return launches


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke runs "
                         "only on an NVIDIA GPU")
    # spn4cir_tpu/__init__.py imports jax when JAX_PLATFORMS is set; the
    # port and this script run without JAX
    os.environ.pop("JAX_PLATFORMS", None)
    sys.path.insert(0, REPO)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # the tokenizer module reads SPN4CIR_BPE_VOCAB when it is imported
        merges = os.path.join(tmp, "bpe_synthetic.txt.gz")
        os.environ["SPN4CIR_BPE_VOCAB"] = merges
        load_test_module("torch_fixtures").write_merges_file(merges)
        from spn4cir_tpu_torch.models import layers
        from spn4cir_tpu_torch.ops import attention_kernels as ak
        from spn4cir_tpu_torch.ops import cuda_build

        device = torch.device("cuda:0")
        card = card_line()
        phase(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
              f"torch {torch.__version__}, CUDA {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase("TF32 off for matmul and cuDNN (float32 comparisons)")

        # phase 2: build
        t0 = time.perf_counter()
        lib = cuda_build.build_library("short_attention",
                                       ["short_attention.cu"], force=True)
        phase(f"built {os.path.relpath(lib, REPO)} in "
              f"{time.perf_counter() - t0:.2f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                phase("ptxas: " + line.strip())

        # phase 3: kernels against their plain versions
        records = check_kernels(ak, device, card)

        # phase 4: the slice
        launches = drive_slice(ak, layers, tmp, card)

        assert not any(m.split(".")[0] in ("jax", "jaxlib", "flax")
                       for m in sys.modules), "JAX was imported"
        vis_bf16 = next(r for r in records
                        if r["tower"] == "vision" and r["dtype"] == "bfloat16")
        print(json.dumps({"kernels": [{
            "name": "short_attention",
            "route": "cuda",
            "source": "spn4cir_tpu_torch/csrc/short_attention.cu",
            "replaces": "spn4cir_tpu/ops/attention_kernels.py:257",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in records
                               if r["dtype"] == "bfloat16"),
            "ms": vis_bf16["ms"],
            "plain_ms": vis_bf16["plain_ms"],
            "ms_at": "vision (3072, 50, 64) bfloat16",
            "checks": records,
        }]}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
