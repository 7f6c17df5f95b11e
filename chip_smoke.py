#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 in practice).

    python3 chip_smoke.py

Phases (one line or more each; any failure is an uncaught exception and a
non-zero exit):
  1. device: CUDA must be present; prints the card and its power limit and
     turns TF32 off for the comparisons;
  2. build: compiles the port's CUDA sources from csrc/ with nvcc, one nvcc
     per source, started together;
  3. kernels: each of the ten kernels against its plain PyTorch version
     on the card at the shapes of the serving, training, flagship, blip and
     blip2 paths (short attention in bfloat16 and float32 at the ViT-B/32
     towers' slices and at RN50x4's 10-head text tower; the bank InfoNCE
     over float32, bfloat16 and int8 banks at D = 512, 640 and 768, with a
     ragged case each; the long attention, forward and backward, at BLIP's
     (1536, 577, 64) and (384, 577, 64), at EVA-g's extraction slice
     (512, 257, 88) and (256, 257, 88), at ViT-L/14's and ViT-B/16's
     slices and a ragged one; the max-over-query InfoNCE at blip2's
     B=32, M=65,536, Q=32, D=256 over float32, bfloat16 and int8 banks and
     a ragged B=5, M=1,000, Q=8; two launches giving the same bits), with
     the
     kernel's time, the plain version's, the time of the PyTorch library
     call that computes the same function (a yardstick only) and the bound
     (the larger of bytes / 3.35 TB/s and operations / peak);
  4. serving slice: `spn4cir_tpu_torch.cli.serve.serve_main` indexes a
     1024-image synthetic CIRR gallery with ViT-B/32 in bf16 (random weights
     from seed 0) and serves it over HTTP; concurrent and sequential
     /retrieve requests must return valid, reference-excluded,
     score-ordered results; the launch counter must show the kernel ran in
     every attention layer of both towers; 8 queries re-scored with the
     plain attention must keep their top-1;
  5. training slice, entry point: `spn4cir_tpu_torch.cli.train.train_main`
     on the same fixture (ViT-B/32 bf16, batch 256): bank extraction on the
     card, one epoch of optimizer steps, a validation, the best checkpoint
     written and read back. The loss of the first batch must fall, the
     image tower and logit_scale must come out bit-identical, the text side
     must move, and the launch counters must equal 12 attention forwards +
     12 backwards + 1 bank forward + 1 bank backward per step (plus the
     forwards of extraction and validation);
  6. flagship slice, entry points: `train_main` with RN50x4 (image 288,
     embedding 640) in bf16 and `--bank_dtype int8` on a second, smaller
     synthetic CIRR tree, checked as phase 5 is, with the counters showing
     12 + 12 attention launches and 1 + 1 launches of the int8 bank kernels
     per step and none of the dense bank kernels; then `validate_main` on
     the best checkpoint and `submission_main` (both JSON files parse, 50
     and 3 names per pair, no reference in its own list), and the RN50x4
     bank-extraction rate on the device;
  7. recipe scale: `train_epoch` over a synthetic bank of 65,536 unit rows
     at batch 256, for ViT-B/32 (bfloat16 bank) and for RN50x4 (int8 bank,
     then float32): ms/step, then a profiler window over further steps
     (device busy, idle share, device operations per step, and the device
     time of the bank and attention kernels cut from the step's own trace);
  8. one loss and gradient computed twice in float32, through the kernels
     and through the plain versions, over a dense and over an int8 bank,
     must agree; so must one blip stage-1 loss (two layers deep at BLIP
     base width) through the long-attention kernels, and one blip2 stage-2
     loss (the Q-Former at full width) through the max-query kernels over
     a dense and an int8 bank;
  9. blip4cir at BLIP base width (ViT-B/16 at 384: 577 tokens, width 768, 12
     layers; MED: hidden 768, 12 layers, cross-attention in each; embedding
     256; bf16 over float32 weights, random from seed 0) on a 512-image
     synthetic CIRR tree: `serve_main(backbone_name="blip")` with concurrent
     and sequential /retrieve requests (12 launches of the long attention
     per encode batch; 8 references re-encoded with plain attention keep
     their queries' top-1); `train_main("blip")` at batch 128 for 4 steps
     (extraction through the long attention, 1 + 1 dense bank launches a
     step at D=256 and no attention launch inside the steps; the ViT and
     vision_proj bit-identical, MED, text_proj and tau moved, the first
     batch's loss lower), `validate_main("blip")` and
     `submission_main("blip")` on its checkpoint; `train_main("blip",
     ["--wo_bank"])` at batch 32 for 4 steps (24 + 24 long-attention
     launches a step, no bank launch, the ViT moved, the loss lower) and
     again with `--grad_ckpt` (the same first loss, 48 + 24 a step); the
     blip stage-2 step at batch 128 against a 65,536 x 256 bank and a
     2,048-image host refer pool (ms/step, host gather, host-to-device
     copy, device busy, idle share) and the extraction rate;
 10. blip24cir at full width (EVA ViT-g at 224: 257 tokens, width 1408, 39
     layers, 16 heads of 88; Q-Former: hidden 768, 12 layers, 32 queries;
     embedding 256; bf16 over float32 weights, random from seed 0) on a
     256-image synthetic CIRR tree: `train_main("blip2")` at batch 32 for 8
     steps (the caption-aware fusion bank through the long attention, 39
     launches per EVA batch; 1 + 1 max-query launches a step and no
     attention launch inside the steps; EVA, Qformer and the projections
     bit-identical, Qformer_query, text_proj_q and temp moved, the first
     batch's loss lower), `validate_main("blip2")` and
     `submission_main("blip2")` on its checkpoint;
     `serve_main(backbone_name="blip2")` with concurrent and sequential
     /retrieve requests (8 references re-encoded with plain attention keep
     their top-1); the stage-2 step at batch 32 against a 65,536 x 32 x 256
     bank, float32 then int8, and a 2,048-triplet host refer pool (ms/step,
     host gather, host-to-device copy, device busy, idle share, ms by kernel
     group); the EVA-g extraction rate at batch 32 with #3's share.
Phases 9 and 10 run between phases 7 and 8. The last three lines are the
kernels JSON, the card's name and power limit (nvidia-smi), and
{"ok": true, "device": {...}}.

The CLIP merges file is not in the repository: the text goes through the
port's CLIP tokenizer built from a synthetic merges table
(tests/torch_fixtures.py), written to a temporary file that
SPN4CIR_BPE_VOCAB points at. Nor is the BERT vocabulary: blip's text goes
through the port's WordPiece tokenizer over a synthetic vocabulary of the
real size (30,522 entries + [DEC], [ENC] = 30,524, MED's embedding table),
written to a temporary file that SPN4CIR_BERT_VOCAB points at.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import importlib.util
import io
import json
import math
import os
import re
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
F32_TOL = 1e-5   # attention forward, float32: only the summation order differs
BF16_TOL = 2e-2  # bf16: P is rounded to bf16 before P·V in both versions
# attention backward: float32 sums of up to 77 products in another order;
# bf16: P, dS (and, under autograd through the plain forward, dP) are
# rounded to bf16 at slightly different places and the outputs are bf16
BWD_F32_TOL = 1e-4
BWD_BF16_TOL = 5e-2
# bank InfoNCE: float32 sums over up to 65,536 bank rows in another order
BANK_RTOL = 1e-4
BANK_DQ_ATOL = 1e-6
# one training loss through the kernels vs through the plain versions,
# float32, twelve layers deep
STEP_TOL = 2e-4

# the card's published peaks (H100 SXM): HBM bytes/s, dense FLOP/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

VISION = dict(name="vision", bh=256 * 12, s=50, d=64, causal=False)
TEXT = dict(name="text", bh=32 * 8, s=77, d=64, causal=True)
TRAIN_TEXT = dict(name="train-text", bh=256 * 8, s=77, d=64, causal=True)
# RN50x4's text tower has 10 heads: a training batch of 256 and the
# evaluation CLIs' query batch of 32
FLAGSHIP_TEXT = dict(name="flagship-text", bh=256 * 10, s=77, d=64, causal=True)
FLAGSHIP_EVAL_TEXT = dict(name="flagship-eval-text", bh=32 * 10, s=77, d=64,
                          causal=True)

# long attention: BLIP's ViT-B/16 at 384 (12 heads) at the extraction batch
# of 128 and the index / validation / stage-1 batch of 32; then ViT-L/14
# (16 heads, batch 32), EVA-g (head_dim 88, 16 heads, batch 16), ViT-B/16 at
# 224 (batch 32) and a ragged slice
BLIP_EXTRACT = dict(name="blip-extract", bh=128 * 12, s=577, d=64, causal=False)
BLIP_INDEX = dict(name="blip-index", bh=32 * 12, s=577, d=64, causal=False)
# EVA ViT-g (16 heads of 88) at blip2's extraction / index batch of 32
EVA_EXTRACT = dict(name="eva-g-extract", bh=32 * 16, s=257, d=88, causal=False)
LONG_SHAPES = (BLIP_EXTRACT, BLIP_INDEX, EVA_EXTRACT,
               dict(name="vit-l14", bh=32 * 16, s=257, d=64, causal=False),
               dict(name="eva-g", bh=16 * 16, s=257, d=88, causal=False),
               dict(name="vit-b16", bh=32 * 12, s=197, d=64, causal=False),
               dict(name="ragged", bh=5, s=130, d=40, causal=False))

N_GALLERY = 1024
N_TRAIN = 1280
N_VAL = 64
ENCODE_BATCH = 256
SERVE_BATCH = 32
N_CONCURRENT = 64
N_SEQUENTIAL = 32
K = 10
TRAIN_BATCH = 256
BANK_DIM = 512
BANK_SIZES = (2049, 65536)
FLAGSHIP = "RN50x4"
FLAGSHIP_DIM = 640      # RN50x4's embedding; 768 is ViT-L/14's
FLAGSHIP_IMAGES = 1024  # the flagship slice's own, smaller CIRR tree
FLAGSHIP_TRAIN = 1024
RECIPE_BANK = 65536
RECIPE_STEPS = 6
PROFILE_STEPS = 4
BLIP_IMAGES = 512       # host refer index 512 x 577 x 768 x 4 B = 0.9 GB
BLIP_TRAIN = 512
BLIP_BATCH = 128
BLIP_LR = "1e-4"        # 20x the recipe's, so that 4 steps show in bf16
BLIP_S1_IMAGES = 128    # the stage-1 runs' own tree
BLIP_S1_TRAIN = 128
BLIP_S1_BATCH = 32
BLIP_DIM = 256
BLIP_POOL = 2048        # host refer pool of the recipe-scale step
BLIP_TAU = 0.03
# limit on |kernel score - plain score| of the blip re-score: one bf16
# rounding unit at 1.0 (2**-8); the cosine scores lie in [-1, 1]
BLIP_SCORE_NOISE = 2.0 ** -8
TAU = 0.02
# blip24cir: EVA ViT-g (39 layers) + Q-Former; batch 32, 32 query features of
# 256 per target image
BLIP2_IMAGES = 256      # host refer index 256 x 257 x 1408 x 4 B = 370 MB
BLIP2_TRAIN = 256
BLIP2_BATCH = 32
# the recipe's: at random weights the loss sits at chance (log M) and its
# gradient is small, so Adam's sign-sized steps of 1e-4 over the 110 M
# trainable parameters overshoot (the first batch's loss rose 5.447 ->
# 5.551 over 8 steps at 1e-4 on the H100)
BLIP2_LR = "1e-5"
BLIP2_POOL = 2048       # host refer pool (triplets) of the recipe-scale step
BLIP2_TAU = 0.05
BLIP2_QUERIES = 32
EVA_LAYERS = 39
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


def bound_ms(n_bytes: float, n_flops: float, dtype) -> tuple:
    """(least ms the card could take, 'bytes' or 'operations')."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def attention_bound(shape, dtype, n_tensors: int, n_products: int) -> tuple:
    """q, k, v, (dO) read once and the outputs written once; each product
    is 2·pairs·D operations per slice, pairs = S² or, causal, S(S+1)/2."""
    bh, s, d = shape["bh"], shape["s"], shape["d"]
    pairs = s * (s + 1) // 2 if shape["causal"] else s * s
    n_bytes = n_tensors * bh * s * d * torch.empty((), dtype=dtype).element_size()
    return bound_ms(n_bytes, n_products * 2 * pairs * d * bh, dtype)


def build_kernels(cuda_build) -> None:
    """Phase 2: one nvcc per source, all started together."""
    t0 = time.perf_counter()
    names = ("short_attention", "bank_infonce", "long_attention",
             "max_query_infonce")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futs = [pool.submit(cuda_build.build_library, n, [f"{n}.cu"], True)
                for n in names]
        libs = [f.result() for f in futs]
    phase(f"built {', '.join(os.path.relpath(l, REPO) for l in libs)} in "
          f"{time.perf_counter() - t0:.2f} s (in parallel)")
    for lib in libs:
        entry = ""
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                # drop the anonymous namespace's prefix of the mangled name
                entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+",
                               "", line.split("'")[1])[:60]
            elif "registers" in line or ("spill" in line and
                                         "0 bytes spill stores" not in line):
                phase(f"ptxas {lib.name.split('-')[0]}: {line.strip()} "
                      f"[{entry}]")


def sdpa(q, k, v, causal):
    """The PyTorch library call for the same function (yardstick only)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q[None], k[None], v[None], is_causal=causal, scale=1.0)[0]


def check_attention_fwd(ak, device, card):
    """Phase 3a: short_attention against its plain version, per shape and
    dtype; returns one record per comparison."""
    g = torch.Generator(device=device).manual_seed(0)
    records = []
    for shape in (VISION, TEXT, TRAIN_TEXT, FLAGSHIP_TEXT,
                  FLAGSHIP_EVAL_TEXT):
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
                library_ms = median_ms(lambda: sdpa(q, k, v, causal))
            b_ms, b_by = attention_bound(shape, dtype, 4, 2)
            rec = dict(shape=f"({bh}, {s}, {d})", tower=shape["name"],
                       causal=causal, dtype=dtype_name(dtype), rtol=tol,
                       atol=tol,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
            records.append(rec)
            phase(f"kernel short_attention {rec['tower']} {rec['shape']} "
                  f"causal={causal} {rec['dtype']}: max_abs_err={err:.3e} "
                  f"(atol=rtol={tol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, library (SDPA) {library_ms:.4f} ms, bound "
                  f"{b_ms:.5f} ms by {b_by} [{card}]")
    return records


def check_attention_bwd(ak, device, card):
    """Phase 3b: short_attention_bwd against the plain backward and against
    float32 autograd through the plain forward."""
    g = torch.Generator(device=device).manual_seed(1)
    records = []
    for shape in (TRAIN_TEXT, VISION, FLAGSHIP_TEXT):
        for dtype, tol in ((torch.bfloat16, BWD_BF16_TOL),
                           (torch.float32, BWD_F32_TOL)):
            bh, s, d, causal = shape["bh"], shape["s"], shape["d"], shape["causal"]
            q, k, v, do = (torch.randn(bh, s, d, generator=g, device=device,
                                       dtype=dtype) for _ in range(4))
            q = q * d ** -0.5
            got = ak.short_attention_bwd(q, k, v, do, causal)
            torch.cuda.synchronize()
            want = ak.short_attention_bwd_reference(q, k, v, do, causal)
            # autograd through the plain forward, in float32 on the same
            # values: in bf16 it would round dP = dO·vᵀ (values up to ~40)
            # to bf16 on the way back, which alone moves 2 of 12.6 million
            # elements of the 10-head shape by 0.067
            exact = [t.to(torch.float32, copy=True).requires_grad_()
                     for t in (q, k, v)]
            auto = torch.autograd.grad(
                ak.short_attention_reference(*exact, causal), exact,
                do.float())
            del exact
            err = 0.0
            for a, b, c in zip(got, want, auto):
                torch.testing.assert_close(a.float(), b.float(), atol=tol,
                                           rtol=tol)
                torch.testing.assert_close(a.float(), c.float(), atol=tol,
                                           rtol=tol)
                err = max(err, (a.float() - b.float()).abs().max().item())
            ms = median_ms(lambda: ak.short_attention_bwd(q, k, v, do, causal))
            plain_ms = median_ms(
                lambda: ak.short_attention_bwd_reference(q, k, v, do, causal))
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            lib_out = sdpa(*leaves, causal)
            library_ms = median_ms(lambda: torch.autograd.grad(
                lib_out, leaves, do, retain_graph=True))
            b_ms, b_by = attention_bound(shape, dtype, 7, 5)
            rec = dict(shape=f"({bh}, {s}, {d})", tower=shape["name"],
                       causal=causal, dtype=dtype_name(dtype), rtol=tol,
                       atol=tol,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
            records.append(rec)
            phase(f"kernel short_attention_bwd {rec['tower']} {rec['shape']} "
                  f"causal={causal} {rec['dtype']}: max_abs_err={err:.3e} vs "
                  f"plain backward, also within atol=rtol={tol} of float32 "
                  f"autograd through the plain forward; kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, library (SDPA backward) "
                  f"{library_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} [{card}]")
    return records


def check_long_attention(ak, device, card):
    """Phase 3d: long_attention and long_attention_bwd against their plain
    versions (the backward also against float32 autograd through the plain
    forward), per shape and dtype; two launches must give the same bits;
    timed at the two blip shapes and EVA-g's extraction slice. Returns
    (forward, backward) records."""
    g = torch.Generator(device=device).manual_seed(11)
    fwd_records, bwd_records = [], []
    for shape in LONG_SHAPES:
        timed = shape in (BLIP_EXTRACT, BLIP_INDEX, EVA_EXTRACT)
        for dtype, tol, btol in ((torch.bfloat16, BF16_TOL, BWD_BF16_TOL),
                                 (torch.float32, F32_TOL, BWD_F32_TOL)):
            bh, s, d = shape["bh"], shape["s"], shape["d"]
            q, k, v, do = (torch.randn(bh, s, d, generator=g, device=device,
                                       dtype=dtype) for _ in range(4))
            q = q * d ** -0.5
            with torch.inference_mode():
                got, lse = ak.long_attention_fwd(q, k, v)
                again, _ = ak.long_attention_fwd(q, k, v)
                torch.cuda.synchronize()
                assert torch.equal(got, again), "forward not repeatable"
                want = ak.long_attention_reference(q, k, v)
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=tol)
                err = (got.float() - want.float()).abs().max().item()
                del want, again
                grads = ak.long_attention_bwd(q, k, v, do, got, lse)
                grads2 = ak.long_attention_bwd(q, k, v, do, got, lse)
                plain = ak.long_attention_bwd_reference(q, k, v, do)
            exact = [t.to(torch.float32, copy=True).requires_grad_()
                     for t in (q, k, v)]
            auto = torch.autograd.grad(ak.long_attention_reference(*exact),
                                       exact, do.float())
            del exact
            berr = 0.0
            for a, a2, b, c in zip(grads, grads2, plain, auto):
                assert torch.equal(a, a2), "backward not repeatable"
                torch.testing.assert_close(a.float(), b.float(), atol=btol,
                                           rtol=btol)
                torch.testing.assert_close(a.float(), c.float(), atol=btol,
                                           rtol=btol)
                berr = max(berr, (a.float() - b.float()).abs().max().item())
            del grads2, plain, auto
            common = dict(shape=f"({bh}, {s}, {d})", tower=shape["name"],
                          causal=False, dtype=dtype_name(dtype))
            f_ms, f_by = attention_bound(shape, dtype, 4, 2)
            b_ms, b_by = attention_bound(shape, dtype, 7, 5)
            frec = dict(common, rtol=tol, atol=tol, max_abs_err=err,
                        bound_ms=f_ms, bound_by=f_by)
            brec = dict(common, rtol=btol, atol=btol, max_abs_err=berr,
                        bound_ms=b_ms, bound_by=b_by)
            times = ["", ""]
            if timed:
                with torch.inference_mode():
                    frec["ms"] = median_ms(
                        lambda: ak.long_attention_fwd(q, k, v), reps=10)
                    frec["plain_ms"] = median_ms(
                        lambda: ak.long_attention_reference(q, k, v), reps=5,
                        warmup=1)
                    frec["library_ms"] = median_ms(
                        lambda: sdpa(q, k, v, False), reps=10)
                    brec["ms"] = median_ms(lambda: ak.long_attention_bwd(
                        q, k, v, do, got, lse), reps=10)
                    brec["plain_ms"] = median_ms(
                        lambda: ak.long_attention_bwd_reference(q, k, v, do),
                        reps=5, warmup=1)
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                lib_out = sdpa(*leaves, False)
                brec["library_ms"] = median_ms(lambda: torch.autograd.grad(
                    lib_out, leaves, do, retain_graph=True), reps=10)
                del leaves, lib_out
                times = [f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
                         f"ms, library (SDPA{w}) {r['library_ms']:.4f} ms, "
                         for r, w in ((frec, ""), (brec, " backward"))]
            fwd_records.append(frec)
            bwd_records.append(brec)
            for name, rec, t in (("long_attention", frec, times[0]),
                                 ("long_attention_bwd", brec, times[1])):
                phase(f"kernel {name} {rec['tower']} {rec['shape']} "
                      f"{rec['dtype']}: max_abs_err={rec['max_abs_err']:.3e} "
                      f"vs the plain version (atol=rtol={rec['atol']}"
                      f"{', also vs float32 autograd' if rec is brec else ''}"
                      f"), two launches bit-identical; {t}bound "
                      f"{rec['bound_ms']:.5f} ms by {rec['bound_by']} [{card}]")
            del q, k, v, do, got, lse, grads
            torch.cuda.empty_cache()
    return fwd_records, bwd_records


def unit_rows(n, d, generator, device):
    return torch.nn.functional.normalize(
        torch.randn(n, d, generator=generator, device=device), dim=-1)


def bank_functions(bk, bank):
    """The wrappers, plain versions and names of the kernel pair that takes
    `bank` (a dense tensor or a QuantBank)."""
    if isinstance(bank, bk.QuantBank):
        return dict(fwd=bk.bank_infonce_q8_fwd, bwd=bk.bank_infonce_q8_bwd,
                    stats_ref=bk.bank_infonce_q8_stats_reference,
                    loss_ref=bk.bank_infonce_q8_reference,
                    bwd_ref=bk.bank_infonce_q8_bwd_reference,
                    names=("bank_infonce_q8_fwd", "bank_infonce_q8_bwd"),
                    # values once (1 byte each) and the scales beside them
                    bank_bytes=bank.values.numel() + 4 * bank.scales.numel(),
                    library="dequantize + matmul + cross_entropy",
                    dense=bank.dequantize)
    return dict(fwd=bk.bank_infonce_fwd, bwd=bk.bank_infonce_bwd,
                stats_ref=bk.bank_infonce_stats_reference,
                loss_ref=bk.bank_infonce_reference,
                bwd_ref=bk.bank_infonce_bwd_reference,
                names=("bank_infonce_fwd", "bank_infonce_bwd"),
                bank_bytes=bank.numel() * bank.element_size(),
                library="matmul + cross_entropy", dense=bank.float)


def check_bank_case(bk, q, bank, labels, card, time_it=True):
    """The forward and backward bank kernels against their plain versions
    on one case (dense or int8 bank): the four statistics, the loss, dtau
    and dQ; returns (fwd, bwd) records."""
    b, d = q.shape
    m = bank.shape[0]
    f = bank_functions(bk, bank)
    gout = torch.tensor(1.0, device=q.device)
    loss, stats, dtau = f["fwd"](q, bank, labels, TAU)
    dq = f["bwd"](q, bank, labels, TAU, stats[0], stats[1], gout)
    torch.cuda.synchronize()
    want = f["stats_ref"](q, bank, labels, TAU)
    want_loss = f["loss_ref"](q, bank, labels, TAU)
    want_dq = f["bwd_ref"](q, bank, labels, TAU, want[0], want[1], gout)
    for got_s, want_s in zip(stats, want):
        torch.testing.assert_close(got_s, want_s, atol=BANK_RTOL,
                                   rtol=BANK_RTOL)
    torch.testing.assert_close(loss, want_loss, atol=BANK_RTOL, rtol=BANK_RTOL)
    torch.testing.assert_close(dtau, bk.dtau_from_stats(want, TAU),
                               atol=10 * BANK_RTOL, rtol=BANK_RTOL)
    torch.testing.assert_close(dq, want_dq, atol=BANK_DQ_ATOL, rtol=BANK_RTOL)
    # every sum has a fixed order: a second launch gives the same bits
    loss2, _, _ = f["fwd"](q, bank, labels, TAU)
    dq2 = f["bwd"](q, bank, labels, TAU, stats[0], stats[1], gout)
    assert torch.equal(loss, loss2) and torch.equal(dq, dq2), "not repeatable"
    fwd_err = max((a - b_).abs().max().item() for a, b_ in zip(stats, want))
    fwd_err = max(fwd_err, (loss - want_loss).abs().item())
    bwd_err = (dq - want_dq).abs().max().item()

    def over_tol(got_t, want_t, atol):
        """Largest |got - want| as a share of what the comparison allows,
        atol + rtol·|want|: at most 1 where the comparison passed."""
        return ((got_t - want_t).abs()
                / (atol + BANK_RTOL * want_t.abs())).max().item()

    fwd_share = max(over_tol(a, b_, BANK_RTOL) for a, b_ in
                    zip((*stats, loss), (*want, want_loss)))
    bwd_share = over_tol(dq, want_dq, BANK_DQ_ATOL)
    common = dict(shape=f"B={b}, M={m}, D={d}", dtype=dtype_name(bank.dtype))
    # float32 products (the bank is widened), so the float32 peak applies;
    # bytes: the query, the bank, the labels and the statistics, each once
    f_ms, f_by = bound_ms(b * d * 4 + f["bank_bytes"] + b * 4 + 4 * b * 4 + 8,
                          2 * b * m * d, torch.float32)
    b_ms, b_by = bound_ms(2 * b * d * 4 + f["bank_bytes"] + b * 4 + 2 * b * 4
                          + 4, 4 * b * m * d, torch.float32)
    fwd = dict(common, rtol=BANK_RTOL, atol=BANK_RTOL, max_abs_err=fwd_err,
               max_err_over_tol=fwd_share, bound_ms=f_ms, bound_by=f_by)
    bwd = dict(common, rtol=BANK_RTOL, atol=BANK_DQ_ATOL, max_abs_err=bwd_err,
               max_err_over_tol=bwd_share, bound_ms=b_ms, bound_by=b_by)
    if time_it:
        ce = torch.nn.functional.cross_entropy
        fwd["ms"] = median_ms(lambda: f["fwd"](q, bank, labels, TAU))
        fwd["plain_ms"] = median_ms(
            lambda: f["stats_ref"](q, bank, labels, TAU))
        fwd["library_ms"] = median_ms(
            lambda: ce(q @ f["dense"]().T / TAU, labels))
        bwd["ms"] = median_ms(lambda: f["bwd"](
            q, bank, labels, TAU, stats[0], stats[1], gout))
        bwd["plain_ms"] = median_ms(lambda: f["bwd_ref"](
            q, bank, labels, TAU, want[0], want[1], gout))
        leaf = q.clone().requires_grad_()
        lib_loss = ce(leaf @ f["dense"]().T / TAU, labels)
        bwd["library_ms"] = median_ms(lambda: torch.autograd.grad(
            lib_loss, leaf, retain_graph=True))
    for name, rec in zip(f["names"], (fwd, bwd)):
        times = (f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                 f"library ({f['library']}"
                 f"{' backward' if name.endswith('bwd') else ''}) "
                 f"{rec['library_ms']:.4f} ms, " if time_it else "")
        phase(f"kernel {name} {rec['shape']} bank {rec['dtype']}: "
              f"max_abs_err={rec['max_abs_err']:.3e}, "
              f"{rec['max_err_over_tol']:.3f} of the tolerance "
              f"(atol={rec['atol']} + rtol={rec['rtol']}·|plain|), "
              f"repeatable; {times}bound {rec['bound_ms']:.5f} ms by "
              f"{rec['bound_by']} [{card}]")
    return fwd, bwd


def check_bank(bk, device, card):
    """Phase 3c: the bank kernels at batch 256. Dense: D=512 x M x (float32,
    bfloat16), then M=65,536 at D=640 (both types) and D=768 (float32).
    int8: M=65,536 at D=640 and at D=512. Then blip4cir's shape (batch 128,
    D=256, float32), then ragged cases, untimed.
    Returns the records of the four kernels."""
    g = torch.Generator(device=device).manual_seed(2)
    records = {name: [] for name in (
        "bank_infonce_fwd", "bank_infonce_bwd", "bank_infonce_q8_fwd",
        "bank_infonce_q8_bwd")}

    def run(q, bank, labels, time_it=True):
        names = bank_functions(bk, bank)["names"]
        for name, rec in zip(names, check_bank_case(bk, q, bank, labels, card,
                                                    time_it)):
            records[name].append(rec)

    for d, sizes in ((BANK_DIM, BANK_SIZES), (FLAGSHIP_DIM, (RECIPE_BANK,)),
                     (768, (RECIPE_BANK,))):
        for m in sizes:
            q = unit_rows(TRAIN_BATCH, d, g, device)
            bank32 = unit_rows(m, d, g, device)
            labels = torch.randint(0, m, (TRAIN_BATCH,), generator=g,
                                   device=device)
            run(q, bank32, labels)
            if d != 768:
                run(q, bank32.to(torch.bfloat16), labels)
            if m == RECIPE_BANK and d != 768:
                run(q, bk.quantize_bank(bank32), labels)
    # blip4cir's stage-2 shape: batch 128, embedding 256
    q = unit_rows(BLIP_BATCH, BLIP_DIM, g, device)
    bank32 = unit_rows(RECIPE_BANK, BLIP_DIM, g, device)
    run(q, bank32, torch.randint(0, RECIPE_BANK, (BLIP_BATCH,), generator=g,
                                 device=device))
    # row and bank counts that are no multiple of a tile; the scales of the
    # int8 bank are a view into a buffer whose tail is NaN
    for b, m, d in ((5, 2049, BANK_DIM), (5, 2049, FLAGSHIP_DIM),
                    (70, 4001, 768)):
        q = unit_rows(b, d, g, device)
        bank32 = unit_rows(m, d, g, device)
        labels = torch.randint(0, m, (b,), generator=g, device=device)
        run(q, bank32, labels, time_it=False)
        qbank = bk.quantize_bank(bank32)
        scales = torch.full((m + 300,), float("nan"), device=device)
        scales[:m] = qbank.scales
        run(q, bk.QuantBank(qbank.values, scales[:m]), labels, time_it=False)
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


def drive_serving(ak, bk, layers, root, card):
    """Phase 4: the serving CLI end to end, then the checks. Returns the
    launch counts of the run."""
    import numpy as np

    from spn4cir_tpu_torch.cli.serve import serve_main
    from spn4cir_tpu_torch.data.datasets import CIRDataset
    from spn4cir_tpu_torch.eval.retrieval import extract_index_features

    argv = ["--dataset", "cirr", "--data_path", root,
            "--clip-model-name", "ViT-B/32", "--bf16", "--seed", "0",
            "--batch-size", str(ENCODE_BATCH), "--serve_batch",
            str(SERVE_BATCH), "--default_k", str(K), "--device", "0",
            "--serve_host", "127.0.0.1", "--serve_port", "0", "--no-block"]

    # ---- the main path, counted ----
    count = zero_counts(ak, bk)
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
        launches = read_counts(count)
        dispatches = service.metrics()["dispatches"]
    finally:
        server.shutdown()
        server.server_close()

    backbone = service.backbone
    cfg = backbone.cfg
    encode_batches = math.ceil(N_GALLERY / ENCODE_BATCH)
    want = dict(short_attention=(cfg.vision_layers * encode_batches
                                 + cfg.transformer_layers * dispatches),
                short_attention_bwd=0, **NO_LONG, **bank_launches(False, 0))
    phase(f"serving slice: {len(names)} images indexed in {encode_batches} "
          f"encode batches, {2 * N_CONCURRENT + N_SEQUENTIAL} queries in "
          f"{dispatches} fuse dispatches; launches {launches} (want "
          f"{cfg.vision_layers}*{encode_batches} + "
          f"{cfg.transformer_layers}*{dispatches} = "
          f"{want['short_attention']} short-attention forwards and no other "
          f"kernel)")
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
    phase("serving slice stats " + json.dumps(stats))
    return launches


class Tee(io.TextIOBase):
    """Writes go to the terminal and into a buffer that is parsed after."""

    def __init__(self, stream):
        self.stream, self.buffer_ = stream, io.StringIO()

    def write(self, text):
        self.stream.write(text)
        return self.buffer_.write(text)

    def flush(self):
        self.stream.flush()


def counters(ak, bk):
    from spn4cir_tpu_torch.ops import maxquery_kernels as mk

    return dict(short_attention=ak.short_attention,
                short_attention_bwd=ak.short_attention_bwd,
                long_attention=ak.long_attention,
                long_attention_bwd=ak.long_attention_bwd,
                bank_infonce_fwd=bk.bank_infonce_fwd,
                bank_infonce_bwd=bk.bank_infonce_bwd,
                bank_infonce_q8_fwd=bk.bank_infonce_q8_fwd,
                bank_infonce_q8_bwd=bk.bank_infonce_q8_bwd,
                max_query_infonce_fwd=mk.max_query_infonce_fwd,
                max_query_infonce_bwd=mk.max_query_infonce_bwd)


def zero_counts(ak, bk):
    count = counters(ak, bk)
    for fn in count.values():
        fn.launches = 0
    return count


def read_counts(count):
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in count.items()}


def bank_launches(quant: bool, steps: int, max_query: bool = False) -> dict:
    """The bank kernels' launches of `steps` optimizer steps: one forward
    and one backward of the pair that takes the bank (the max-over-query
    pair for blip2's (M, 32, 256) bank, of either type), none of the
    others."""
    dense, q8, mq = ((0, 0, steps) if max_query else
                     (0, steps, 0) if quant else (steps, 0, 0))
    return dict(bank_infonce_fwd=dense, bank_infonce_bwd=dense,
                bank_infonce_q8_fwd=q8, bank_infonce_q8_bwd=q8,
                max_query_infonce_fwd=mq, max_query_infonce_bwd=mq)


# the CLIP paths at S <= 128 never reach the long-attention kernels
NO_LONG = dict(long_attention=0, long_attention_bwd=0)
# nor the blip paths the short ones: MED's attention is plain tensor code
NO_SHORT = dict(short_attention=0, short_attention_bwd=0)


def drive_training_cli(ak, bk, root, tmp, card, model="ViT-B/32",
                       bank_dtype="float32", n_gallery=N_GALLERY,
                       n_train=N_TRAIN):
    """Phases 5 and 6: `train_main` through its argv, then the checks.
    Returns the launch counts of the run, the argv and the trained
    backbone."""
    from spn4cir_tpu_torch.bank.bank import Bank
    from spn4cir_tpu_torch.cli import common, train
    from spn4cir_tpu_torch.data.datasets import CIRDataset, iter_train_bank
    from spn4cir_tpu_torch.utils.checkpoint import load_model
    from spn4cir_tpu_torch.utils.seeding import seed_everything

    quant = bank_dtype == "int8"
    out = os.path.join(tmp, f"train_run_{bank_dtype}")
    argv = ["--dataset", "cirr", "--data_path", root, "--clip-model-name",
            model, "--bf16", "--seed", "0", "--batch-size",
            str(TRAIN_BATCH), "--num-epochs", "1", "--output_path", out,
            "--bank_dtype", bank_dtype]

    # ---- the main path, counted (no --device: cuda:0 is the default) ----
    count = zero_counts(ak, bk)
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        best = train.train_main("clip", argv, log_every=1,
                                **train.CLIP4CIR_DEFAULTS)
    launches = read_counts(count)
    train_s = time.perf_counter() - t0

    losses = [json.loads(line)["loss"]
              for line in tee.buffer_.getvalue().splitlines()
              if line.startswith('{"step"')]
    steps = n_train // TRAIN_BATCH
    assert len(losses) == steps >= 4, (len(losses), steps)
    assert all(math.isfinite(x) for x in losses), losses

    with contextlib.redirect_stdout(io.StringIO()):
        args = common.base_parser(**train.CLIP4CIR_DEFAULTS).parse_args(argv)
        common.finalize_args(args)
    fresh = common.make_backbone("clip", args)
    common.load_or_init_params(fresh, args, seed_everything(args.seed))
    trained = common.make_backbone("clip", args)
    _, meta = load_model(os.path.join(out, "best.pt"), trained.model)
    assert meta["epoch"] == 0 and meta["score"] == best > 0.0, (meta, best)
    cfg = trained.cfg

    preprocess = common.make_transform(trained, args)
    ds = CIRDataset("cirr", "train", "relative", preprocess, root,
                    args.dress_types, extend_suffix=trained.extend_suffix,
                    seed=args.seed, replace_extended=trained.replace_extended)
    m = ds.num_unique_images
    extract_batches = math.ceil(m / TRAIN_BATCH)
    val_gallery_batches = math.ceil(n_gallery / 32)
    val_query_batches = math.ceil(N_VAL / 32)
    # a ResNet tower has no attention layer: its pool is plain PyTorch
    vision_layers = cfg.vision_layers if cfg.is_vit else 0
    want = dict(
        short_attention=(cfg.transformer_layers * steps
                         + vision_layers * extract_batches
                         + vision_layers * val_gallery_batches
                         + cfg.transformer_layers * val_query_batches),
        short_attention_bwd=cfg.transformer_layers * steps,
        **NO_LONG, **bank_launches(quant, steps))
    phase(f"training slice (train_main, {model} bf16, batch {TRAIN_BATCH}, "
          f"{bank_dtype} bank): "
          f"bank of {m} images in {extract_batches} encode batches, {steps} "
          f"steps, validation over {n_gallery} images and {N_VAL} queries, "
          f"{train_s:.1f} s in all; launches {launches} (want "
          f"{cfg.transformer_layers} attention forwards + "
          f"{cfg.transformer_layers} backwards + 1 bank forward + 1 bank "
          f"backward per step, and {vision_layers}*({extract_batches}+"
          f"{val_gallery_batches}) + {cfg.transformer_layers}*"
          f"{val_query_batches} forwards of extraction and validation: {want})")
    assert launches == want, (launches, want)

    # the frozen tensors are bit-identical, the text side moved
    moved = 0
    for (name, before), after in zip(fresh.model.state_dict().items(),
                                     trained.model.state_dict().values()):
        if name.startswith("visual.") or name == "logit_scale":
            assert torch.equal(before, after), f"frozen {name} changed"
        elif not torch.equal(before, after):
            moved += 1
    n_text = sum(1 for n in fresh.model.state_dict()
                 if not (n.startswith("visual.") or n == "logit_scale"))
    assert moved == n_text, (moved, n_text)

    # the first batch again, with the trained weights, against its loss at
    # step 0 (which was computed before any update)
    bank = Bank.load(os.path.join(out, "cirr_bank.npz"), device=trained.device)
    assert bank.target.shape == (m, cfg.embed_dim) and bank.refer.shape == (
        m, cfg.embed_dim)
    assert torch.isfinite(bank.target).all()
    raw = next(iter_train_bank(ds, TRAIN_BATCH, epoch_seed=args.seed))
    dev = trained.device
    target = bk.quantize_bank(bank.target) if quant else bank.target
    batch = (torch.from_numpy(bank.gather_refer(raw)).to(dev),
             torch.from_numpy(trained.tokenize(raw["captions"])).to(dev),
             target, torch.from_numpy(raw["target_image_id"]).to(dev))
    with torch.no_grad():
        before = fresh.stage2_loss(*batch).item()
        after = trained.stage2_loss(*batch).item()
    phase(f"training slice: per-step losses {[round(x, 4) for x in losses]}; "
          f"first batch before training {before:.4f} (logged {losses[0]:.4f})"
          f", after {steps} steps {after:.4f}; best score {best:.2f}; "
          f"{moved} text tensors moved, image tower and logit_scale "
          f"bit-identical; best.pt read back [{card}]")
    assert abs(before - losses[0]) < 1e-3 * abs(before), (before, losses[0])
    assert after < before, (after, before)

    # the kernels at the shape this path gave them: the extracted bank
    q = unit_rows(TRAIN_BATCH, cfg.embed_dim,
                  torch.Generator(device=dev).manual_seed(3), dev)
    check_bank_case(bk, q, target, batch[3], card, time_it=False)
    return launches, argv, trained


def drive_flagship_eval(ak, bk, argv, backbone, tmp, card):
    """Phase 6, after training: `validate_main` on the best checkpoint,
    `submission_main`, and the bank-extraction rate of the image tower.
    Returns the launch counts of the two entry points."""
    from spn4cir_tpu_torch.cli import submission, train, validate

    ckpt = os.path.join(argv[argv.index("--output_path") + 1], "best.pt")
    argv = argv + ["--model_path", ckpt]
    count = zero_counts(ak, bk)
    with contextlib.redirect_stdout(io.StringIO()):
        results = validate.validate_main("clip", argv,
                                         **train.CLIP4CIR_DEFAULTS)
    assert set(results) >= {"recall_at1", "recall_at5", "recall_at50",
                            "group_recall_at1", "arithmetic_mean"}, results
    assert all(math.isfinite(v) and 0.0 <= v <= 100.0
               for v in results.values()), results
    assert results["recall_at50"] > 0.0, results

    cwd = os.getcwd()
    os.chdir(tmp)       # the files land under the working directory
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            paths = submission.submission_main(
                "clip", argv + ["--submission-name", "smoke"],
                **train.CLIP4CIR_DEFAULTS)
        docs = []
        for path in paths:
            with open(path) as fh:
                docs.append(json.load(fh))
    finally:
        os.chdir(cwd)
    launches = read_counts(count)
    pred, group = docs
    assert (pred.pop("version"), pred.pop("metric")) == ("rc2", "recall")
    assert (group.pop("version"), group.pop("metric")) == (
        "rc2", "recall_subset")
    with open(os.path.join(argv[argv.index("--data_path") + 1], "cirr",
                           "captions", "cap.rc2.test1.json")) as fh:
        refer = {str(int(t["pairid"])): t["reference"] for t in json.load(fh)}
    assert set(pred) == set(group) == set(refer) and len(refer) == N_VAL
    for pid, name in refer.items():
        assert len(pred[pid]) == len(set(pred[pid])) == 50, (pid, pred[pid])
        assert len(group[pid]) == 3, (pid, group[pid])
        assert name not in pred[pid] and name not in group[pid], pid
    query_batches = 2 * math.ceil(N_VAL / 32)       # validation + submission
    want = dict(short_attention=backbone.cfg.transformer_layers * query_batches,
                short_attention_bwd=0, **NO_LONG, **bank_launches(True, 0))
    phase(f"flagship slice: validate_main on best.pt {json.dumps(results)}; "
          f"submission_main wrote {[os.path.basename(p) for p in paths]}: "
          f"{len(pred)} pairs, 50 and 3 names each, no reference in its own "
          f"list; launches {launches} (want {want})")
    assert launches == want, (launches, want)

    res = backbone.cfg.image_resolution
    dev = backbone.device
    batch = torch.randn(ENCODE_BATCH, res, res, 3, device=dev,
                        generator=torch.Generator(dev).manual_seed(2))
    with torch.inference_mode():
        ms = median_ms(lambda: backbone.bank_features(batch), reps=5, warmup=2)
    phase(f"{FLAGSHIP} bf16 bank extraction at {res}: "
          f"{ENCODE_BATCH / (ms / 1e3):.1f} images/s on the device (batch "
          f"{ENCODE_BATCH}, {ms:.3f} ms/batch) [{card}]")
    return launches


def synthetic_batches(n_steps, batch, num_images, seed):
    """`iter_train_bank`-shaped batches over a synthetic bank."""
    import numpy as np

    rng = np.random.RandomState(seed)
    # the triplet ids of a triplet-keyed refer pool (blip2) from a stream of
    # their own
    triplets = np.random.RandomState(seed + 10_000)
    for _ in range(n_steps):
        yield {"captions": [CAPTIONS[int(i)] for i in
                            rng.randint(0, len(CAPTIONS), batch)],
               "refer_image_id": rng.randint(0, num_images, batch),
               "target_image_id": rng.randint(0, num_images, batch),
               "triplet_idx": triplets.randint(0, num_images, batch)}


def device_busy(trace_path: str):
    """(busy ms, number of device operations, ms by kernel group) from a
    chrome trace: the union of the kernel / memcpy / memset intervals."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    spans, groups = [], {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((ev["ts"], ev["ts"] + ev["dur"]))
        name = ev.get("name", "")
        low = name.lower()
        if "bank_infonce" in name:
            key = "bank kernels"
        elif "mq_" in name and "kernel" in name:
            key = "max-query kernels"
        elif "short_attention" in name or "long_attention" in name:
            key = "attention kernels"
        elif any(w in low for w in ("gemm", "cutlass", "xmma", "cublas", "nvjet")):
            key = "GEMMs"
        elif "layer_norm" in low or "layernorm" in low:
            key = "LayerNorm"
        elif "adam" in low or "multi_tensor" in low:
            key = "optimizer"
        elif ev["cat"] != "kernel":
            key = "copies"
        else:
            key = "elementwise and other"
        groups[key] = groups.get(key, 0.0) + ev["dur"] / 1e3
    spans.sort()
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, len(spans), groups


def drive_training_recipe(ak, bk, tmp, card, model, bank_dtypes):
    """Phase 7: `train_epoch` of `model` at the recipe's bank size, once per
    bank type of `bank_dtypes`: ms/step, then a profiler window whose trace
    gives the device time of each kernel group within the step."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from spn4cir_tpu_torch.bank.bank import Bank
    from spn4cir_tpu_torch.models.clip4cir import ClipCIR
    from spn4cir_tpu_torch.train.stage2 import create_train_state, train_epoch

    device = torch.device("cuda:0")
    backbone = ClipCIR(model, tau=TAU, dtype=torch.bfloat16, device=device)
    backbone.init_params(torch.Generator().manual_seed(0))
    dim = backbone.embed_dim
    g = torch.Generator(device=device).manual_seed(4)
    target32 = unit_rows(RECIPE_BANK, dim, g, device)
    refer = np.random.RandomState(5).randn(RECIPE_BANK, dim).astype(np.float32)
    state = create_train_state(backbone, 2e-5)
    count = counters(ak, bk)
    layers_n = backbone.cfg.transformer_layers

    def profiled(bank, n_steps, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            train_epoch(backbone, state, bank,
                        synthetic_batches(n_steps, TRAIN_BATCH, RECIPE_BANK,
                                          seed), log_every=0)
            torch.cuda.synchronize()
        return prof, (time.perf_counter() - t0) * 1e3

    results = {}
    for name in bank_dtypes:
        quant = name == "int8"
        bank = Bank(refer=refer, target=bk.quantize_bank(target32) if quant
                    else target32.to(getattr(torch, name)))
        backbone.train()
        train_epoch(backbone, state, bank,
                    synthetic_batches(3, TRAIN_BATCH, RECIPE_BANK, 6),
                    log_every=0)                                # warm-up
        for fn in count.values():
            fn.launches = 0
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        _, mean_loss = train_epoch(
            backbone, state, bank,
            synthetic_batches(RECIPE_STEPS, TRAIN_BATCH, RECIPE_BANK, 7),
            log_every=0)
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / RECIPE_STEPS
        event_ms = start.elapsed_time(end) / RECIPE_STEPS
        launches = read_counts(count)
        assert launches == dict(
            short_attention=layers_n * RECIPE_STEPS,
            short_attention_bwd=layers_n * RECIPE_STEPS,
            **NO_LONG, **bank_launches(quant, RECIPE_STEPS)), launches
        assert math.isfinite(mean_loss), mean_loss
        phase(f"recipe scale, M={RECIPE_BANK} x {dim} {name} bank, batch "
              f"{TRAIN_BATCH}, {model} bf16, {RECIPE_STEPS} steps: "
              f"{event_ms:.3f} ms/step (CUDA events; host clock "
              f"{wall_ms:.3f}); mean loss {mean_loss:.4f} [{card}]")

        # a profiler window over further steady steps; a first one-step
        # window takes the profiler's start-up cost and is dropped
        profiled(bank, 1, 8)
        prof, window_ms = profiled(bank, PROFILE_STEPS, 9)
        trace = os.path.join(tmp, f"train_trace_{dim}_{name}.json")
        prof.export_chrome_trace(trace)
        busy_ms, n_ops, groups = device_busy(trace)
        assert n_ops > 0, "the profiler's trace holds no device interval"
        per = {k: v / PROFILE_STEPS for k, v in
               sorted(groups.items(), key=lambda kv: -kv[1])}
        bank_ms, attn_ms = per["bank kernels"], per["attention kernels"]
        assert bank_ms > 0 and attn_ms > 0, per
        busy_step = busy_ms / PROFILE_STEPS
        results[name] = dict(
            ms_per_step=event_ms, wall_ms_per_step=wall_ms,
            mean_loss=mean_loss, profile_steps=PROFILE_STEPS,
            window_ms_per_step=window_ms / PROFILE_STEPS,
            busy_ms_per_step=busy_step,
            idle_share_in_window=1 - busy_ms / window_ms,
            idle_share_of_unprofiled_step=1 - busy_step / event_ms,
            device_ops_per_step=n_ops / PROFILE_STEPS,
            ms_per_step_by_group=per)
        phase(f"profile, {model}, {PROFILE_STEPS} steps at M={RECIPE_BANK} "
              f"{name} bank: device busy {busy_step:.3f} ms/step in "
              f"{n_ops / PROFILE_STEPS:.0f} device operations per step; idle "
              f"share {100 * (1 - busy_step / event_ms):.1f}% of the "
              f"{event_ms:.3f} ms step timed without the profiler "
              f"({100 * (1 - busy_ms / window_ms):.1f}% of the "
              f"{window_ms / PROFILE_STEPS:.3f} ms/step window under the "
              f"profiler, whose host cost widens it); in the step's own "
              f"trace the two bank kernels take {bank_ms:.3f} ms/step "
              f"({100 * bank_ms / busy_step:.1f}% of device busy, "
              f"{100 * bank_ms / event_ms:.1f}% of the step) and the "
              f"{2 * layers_n} attention launches {attn_ms:.3f} ms/step "
              f"({100 * attn_ms / busy_step:.1f}%, "
              f"{100 * attn_ms / event_ms:.1f}%); device ms per step by "
              f"group: { {k: round(v, 3) for k, v in per.items()} } [{card}]")
    phase(f"recipe scale stats {model} " + json.dumps(results))


def blip_argv(root, *extra):
    return ["--dataset", "cirr", "--data_path", root, "--bf16", "--seed", "0",
            *extra]


# what the two BLIP serving slices expect of their models: (image tower
# width, layers, heads, tokens), (text side hidden, layers, vocabulary), the
# gallery's size, a target row's shape and the text side's name
BLIP_SERVING = dict(name="blip", phase="9a", vit=(768, 12, 12, 577),
                    text_cfg="med_cfg", text=(768, 12, 30524),
                    n_images=BLIP_IMAGES, target_row=(BLIP_DIM,),
                    text_side="MED's")
BLIP2_SERVING = dict(name="blip2", phase="10b", vit=(1408, EVA_LAYERS, 16, 257),
                     text_cfg="q_cfg", text=(768, 12, 30524),
                     n_images=BLIP2_IMAGES, target_row=(BLIP2_QUERIES, BLIP_DIM),
                     text_side="the Q-Former's")


def drive_blip_serving(ak, bk, layers, root, card, spec=BLIP_SERVING):
    """Phases 9a and 10b: the serving CLI over blip4cir or blip24cir (`spec`),
    then the checks. Returns the launch counts of the run."""
    import numpy as np

    from spn4cir_tpu_torch.cli.serve import serve_main
    from spn4cir_tpu_torch.data.datasets import CIRDataset, iter_gallery

    name, n_images = spec["name"], spec["n_images"]
    argv = blip_argv(root, "--batch-size", str(SERVE_BATCH), "--serve_batch",
                     str(SERVE_BATCH), "--default_k", str(K), "--serve_host",
                     "127.0.0.1", "--serve_port", "0", "--no-block")
    count = zero_counts(ak, bk)
    t0 = time.perf_counter()
    server, service = serve_main(argv, backbone_name=name)
    startup_s = time.perf_counter() - t0
    port = server.server_address[1]
    try:
        index = service.index
        names = list(index.names)
        name_set = set(names)
        rng = np.random.RandomState(0)
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
        concurrent_ms = [ms for _, ms in outs]
        sequential = []
        for j in range(N_SEQUENTIAL):
            n = names[int(rng.randint(len(names)))]
            results, ms = post(port, {"reference_name": n,
                                      "caption": CAPTIONS[j % len(CAPTIONS)],
                                      "k": K})
            check_results(n, results, name_set)
            sequential.append(ms)
        launches = read_counts(count)
        dispatches = service.metrics()["dispatches"]
    finally:
        server.shutdown()
        server.server_close()

    backbone = service.backbone
    vit = backbone.vit_cfg
    assert (vit.width, vit.layers, vit.heads, vit.num_tokens) == spec["vit"], vit
    text_cfg = getattr(backbone, spec["text_cfg"])
    assert (text_cfg.hidden_size, text_cfg.num_layers,
            text_cfg.vocab_size) == spec["text"], text_cfg
    encode_batches = math.ceil(n_images / SERVE_BATCH)
    want = dict(long_attention=vit.layers * encode_batches,
                long_attention_bwd=0, **NO_SHORT, **bank_launches(False, 0))
    phase(f"{name} serving slice: {len(names)} images indexed at "
          f"{vit.image_size} in {encode_batches} encode batches of "
          f"{SERVE_BATCH} ({startup_s:.1f} s with the model's construction), "
          f"{N_CONCURRENT + N_SEQUENTIAL} queries in {dispatches} fuse "
          f"dispatches; launches {launches} (want {vit.layers} long-attention "
          f"forwards per encode batch and no other kernel: "
          f"{spec['text_side']} attention carries padding masks)")
    assert launches == want, (launches, want)

    target = index.target
    assert target.shape == (n_images, *spec["target_row"]), target.shape
    assert index.refer.shape == (n_images, vit.num_tokens, vit.width), \
        index.refer.shape
    assert torch.isfinite(target).all() and np.isfinite(index.refer).all()
    norms = target.float().norm(dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-3), norms

    # the first 8 gallery images again, their tokens through the plain
    # attention: the scores of the two routes differ by no more than
    # BLIP_SCORE_NOISE, and each query keeps its top-1 unless its two best
    # were closer than twice that fixed limit
    classic = CIRDataset("cirr", "val", "classic", service.preprocess, root)
    ids, images = next(iter_gallery(classic, 8, 0))
    dev = backbone.device
    with torch.inference_mode():
        text = torch.from_numpy(backbone.tokenize(
            [CAPTIONS[j % len(CAPTIONS)] for j in range(8)])).to(dev)
        mask = torch.zeros(8, n_images, device=dev)
        mask[torch.arange(8), torch.from_numpy(ids)] = float("-inf")
        kern_scores = backbone.score_queries(
            backbone.fuse(index.refer_rows(ids), text), target) + mask
        layers.set_attention_impl(backbone, "plain")
        try:
            before = ak.long_attention.launches
            plain_refer = backbone.index_features(
                torch.from_numpy(images).to(dev))["refer"]
            assert ak.long_attention.launches == before
        finally:
            layers.set_attention_impl(backbone, "auto")
        plain_scores = backbone.score_queries(
            backbone.fuse(plain_refer, text), target) + mask
        top_k = kern_scores.topk(2, dim=-1)
        top_p = plain_scores.topk(1, dim=-1).indices[:, 0]
        gaps = top_k.values[:, 0] - top_k.values[:, 1]
        diff = (kern_scores - plain_scores)[mask == 0].abs().max().item()
        same = top_k.indices[:, 0] == top_p
        phase(f"{name} re-score, references re-encoded with plain attention: "
              f"top-1 kernel {top_k.indices[:, 0].tolist()} plain "
              f"{top_p.tolist()}: {int(same.sum())}/8 kept; max |score diff| "
              f"{diff:.3e} (limit {BLIP_SCORE_NOISE:.1e}); top-1/top-2 gaps "
              f"min {gaps.min().item():.3e}")
        assert diff <= BLIP_SCORE_NOISE, diff
        assert bool((same | (gaps <= 2 * BLIP_SCORE_NOISE)).all()), \
            "top-1 changed"
        assert int(same.sum()) >= 6, same

    stats = dict(startup_s=startup_s, dispatches=dispatches,
                 concurrent_p50_ms=statistics.median(concurrent_ms),
                 concurrent_p99_ms=pct(concurrent_ms, 0.99),
                 sequential_p50_ms=statistics.median(sequential),
                 sequential_p99_ms=pct(sequential, 0.99))
    phase(f"{name} query latency, {N_CONCURRENT} concurrent (first round): "
          f"p50 {stats['concurrent_p50_ms']:.2f} ms, p99 "
          f"{stats['concurrent_p99_ms']:.2f} ms; sequential: p50 "
          f"{stats['sequential_p50_ms']:.2f} ms, p99 "
          f"{stats['sequential_p99_ms']:.2f} ms (each dispatch gathers its "
          f"references' {vit.num_tokens} x {vit.width} tokens on the host) "
          f"[{card}]")
    phase(f"{name} serving slice stats " + json.dumps(stats))
    return launches


def blip_sides(common, argv, name="blip"):
    """(args, a fresh `name` backbone with the weights `train_main` started
    from)."""
    from spn4cir_tpu_torch.utils.seeding import seed_everything

    with contextlib.redirect_stdout(io.StringIO()):
        args = common.base_parser(**common.recipe_defaults(name)).parse_args(
            argv)
        common.finalize_args(args)
    fresh = common.make_backbone(name, args)
    common.load_or_init_params(fresh, args, seed_everything(args.seed))
    return args, fresh.eval()


def logged_losses(text):
    losses = [json.loads(line)["loss"] for line in text.splitlines()
              if line.startswith('{"step"')]
    assert losses and all(math.isfinite(x) for x in losses), losses
    return losses


def drive_blip_training(ak, bk, root, tmp, card):
    """Phase 9b: `train_main("blip")` (stage 2) through its argv, the checks,
    then `validate_main` and `submission_main` on its checkpoint. Returns the
    launch counts of the training run and of the two evaluation runs."""
    from spn4cir_tpu_torch.bank.bank import Bank
    from spn4cir_tpu_torch.cli import common, submission, train, validate
    from spn4cir_tpu_torch.data.datasets import CIRDataset, iter_train_bank
    from spn4cir_tpu_torch.models.convert import load_blip_checkpoint

    out = os.path.join(tmp, "blip_run")
    argv = blip_argv(root, "--batch-size", str(BLIP_BATCH), "--num-epochs",
                     "1", "--learning-rate", BLIP_LR, "--output_path", out)
    count = zero_counts(ak, bk)
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        best = train.train_main("blip", argv, log_every=1)
    launches = read_counts(count)
    train_s = time.perf_counter() - t0
    losses = logged_losses(tee.buffer_.getvalue())
    steps = BLIP_TRAIN // BLIP_BATCH
    assert len(losses) == steps == 4, (len(losses), steps)

    args, fresh = blip_sides(common, argv)
    assert args.tau == BLIP_TAU and args.clip_model_name == "RN50x4"
    ckpt = os.path.join(out, "best.pt")
    _, trained = blip_sides(common, argv)
    trained.model.load_state_dict(load_blip_checkpoint(ckpt))
    layers_n = trained.vit_cfg.layers

    preprocess = common.make_transform(trained, args)
    ds = CIRDataset("cirr", "train", "relative", preprocess, root,
                    args.dress_types, extend_suffix=trained.extend_suffix,
                    seed=args.seed, replace_extended=trained.replace_extended)
    m = ds.num_unique_images
    extract_batches = math.ceil(m / BLIP_BATCH)
    val_batches = math.ceil(BLIP_IMAGES / 32)
    want = dict(long_attention=layers_n * (extract_batches + val_batches),
                long_attention_bwd=0, **NO_SHORT,
                **bank_launches(False, steps))
    phase(f"blip training slice (train_main, BLIP base bf16, batch "
          f"{BLIP_BATCH}): bank of {m} images in {extract_batches} encode "
          f"batches, {steps} steps, validation over {BLIP_IMAGES} images and "
          f"{N_VAL} queries, {train_s:.1f} s in all; launches {launches} "
          f"(want {layers_n} long-attention forwards per encode batch of "
          f"extraction and validation, 1 dense bank forward + 1 backward per "
          f"step and no attention launch inside the steps: {want})")
    assert launches == want, (launches, want)

    moved, still = [], []
    fresh_sd, trained_sd = fresh.model.state_dict(), trained.model.state_dict()
    for name, before in fresh_sd.items():
        after = trained_sd[name]
        if name.startswith(("visual_encoder.", "vision_proj.")):
            assert torch.equal(before, after), f"frozen {name} changed"
        else:
            (still if torch.equal(before, after) else moved).append(name)
    # a key bias has a gradient of exactly zero and starts at zero: AdamW
    # leaves it where it is unless rounding noise moves it
    assert all(n.endswith(".self.key.bias") for n in still), still
    for name in ("tau", "text_proj.weight",
                 "text_encoder.embeddings.word_embeddings.weight",
                 "text_encoder.encoder.layer.0.attention.self.query.weight",
                 "text_encoder.encoder.layer.11.crossattention.self.value.weight",
                 "text_encoder.encoder.layer.5.output.LayerNorm.bias"):
        assert name in moved, f"{name} did not move"

    bank = Bank.load(os.path.join(out, "cirr_bank.npz"), device=trained.device)
    assert bank.target.shape == (m, BLIP_DIM), bank.target.shape
    assert bank.refer.shape == (m, 577, 768), bank.refer.shape
    assert torch.isfinite(bank.target).all()
    raw = next(iter_train_bank(ds, BLIP_BATCH, epoch_seed=args.seed))
    dev = trained.device
    batch = (torch.from_numpy(bank.gather_refer(raw)).to(dev),
             torch.from_numpy(trained.tokenize(raw["captions"])).to(dev),
             bank.target, torch.from_numpy(raw["target_image_id"]).to(dev))
    with torch.no_grad():
        before = fresh.stage2_loss(*batch).item()
        after = trained.stage2_loss(*batch).item()
    tau = trained.model.tau.item()
    phase(f"blip training slice: per-step losses "
          f"{[round(x, 4) for x in losses]}; first batch before training "
          f"{before:.4f} (logged {losses[0]:.4f}), after {steps} steps "
          f"{after:.4f}; tau {BLIP_TAU} -> {tau:.6f}; best score {best:.2f}; "
          f"{len(moved)} text-side tensors moved ({len(still)} zero-gradient "
          f"key biases did not), ViT and vision_proj bit-identical; best.pt "
          f"read back [{card}]")
    assert abs(before - losses[0]) < 2e-3 * abs(before), (before, losses[0])
    assert after < before, (after, before)
    assert tau != BLIP_TAU

    # kernels #5 / #6 at the shape this path gave them: the extracted bank
    q = unit_rows(BLIP_BATCH, BLIP_DIM,
                  torch.Generator(device=dev).manual_seed(3), dev)
    check_bank_case(bk, q, bank.target, batch[3], card, time_it=False)
    del bank, batch, fresh, trained
    torch.cuda.empty_cache()

    # validate_main and submission_main on the checkpoint
    eval_argv = blip_argv(root, "--model_path", ckpt)
    count = zero_counts(ak, bk)
    with contextlib.redirect_stdout(io.StringIO()):
        results = validate.validate_main("blip", eval_argv)
    assert set(results) >= {"recall_at1", "recall_at5", "recall_at50",
                            "group_recall_at1", "arithmetic_mean"}, results
    assert all(math.isfinite(v) and 0.0 <= v <= 100.0
               for v in results.values()), results
    assert abs(results["arithmetic_mean"] - best) < 1e-6, (results, best)
    cwd = os.getcwd()
    os.chdir(tmp)       # the files land under the working directory
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            paths = submission.submission_main(
                "blip", eval_argv + ["--submission-name", "blip_smoke"])
        docs = []
        for path in paths:
            with open(path) as fh:
                docs.append(json.load(fh))
    finally:
        os.chdir(cwd)
    eval_launches = read_counts(count)
    pred, group = docs
    assert (pred.pop("version"), pred.pop("metric")) == ("rc2", "recall")
    assert (group.pop("version"), group.pop("metric")) == (
        "rc2", "recall_subset")
    assert len(pred) == len(group) == N_VAL and set(pred) == set(group)
    assert all(len(v) == len(set(v)) == 50 for v in pred.values())
    assert all(len(v) == 3 for v in group.values())
    want = dict(long_attention=layers_n * 2 * val_batches,
                long_attention_bwd=0, **NO_SHORT, **bank_launches(False, 0))
    phase(f"blip training slice: validate_main on best.pt "
          f"{json.dumps(results)}; submission_main wrote "
          f"{[os.path.relpath(p, 'submission') for p in paths]}: {len(pred)} "
          f"pairs, 50 and 3 names each; launches {eval_launches} (want "
          f"{want})")
    assert eval_launches == want, (eval_launches, want)
    return launches, eval_launches


def drive_blip_stage1(ak, bk, root, tmp, card):
    """Phase 9c: `train_main("blip", ["--wo_bank", ...])` through its argv,
    without and with `--grad_ckpt`, and the checks. Returns the launch
    counts of both runs together."""
    from spn4cir_tpu_torch.cli import common, train
    from spn4cir_tpu_torch.data.datasets import CIRDataset, iter_train_images
    from spn4cir_tpu_torch.models.convert import load_blip_checkpoint

    steps = BLIP_S1_TRAIN // BLIP_S1_BATCH
    val_batches = math.ceil(BLIP_S1_IMAGES / 32)
    total = {}
    runs = {}
    for ckpt_flag in ((), ("--grad_ckpt",)):
        out = os.path.join(tmp, f"blip_stage1{'_ckpt' if ckpt_flag else ''}")
        argv = blip_argv(root, "--batch-size", str(BLIP_S1_BATCH),
                         "--num-epochs", "1", "--learning-rate", BLIP_LR,
                         "--output_path", out, "--wo_bank", *ckpt_flag)
        count = zero_counts(ak, bk)
        torch.cuda.reset_peak_memory_stats()
        tee = Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            best = train.train_main("blip", argv, log_every=1)
        launches = read_counts(count)
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = logged_losses(tee.buffer_.getvalue())
        assert len(losses) == steps == 4, (len(losses), steps)
        # with --grad_ckpt each block's forward runs again in the backward
        fwd_per_step = 24 * (2 if ckpt_flag else 1)
        want = dict(long_attention=fwd_per_step * steps + 12 * val_batches,
                    long_attention_bwd=24 * steps, **NO_SHORT,
                    **bank_launches(False, 0))
        phase(f"blip stage-1 slice (train_main --wo_bank"
              f"{' --grad_ckpt' if ckpt_flag else ''}, BLIP base bf16, batch "
              f"{BLIP_S1_BATCH}): {steps} steps and a validation over "
              f"{BLIP_S1_IMAGES} images in {run_s:.1f} s, peak device memory "
              f"{peak_gb:.2f} GiB; per-step losses "
              f"{[round(x, 4) for x in losses]}; best score {best:.2f}; "
              f"launches {launches} (want {fwd_per_step} long-attention "
              f"forwards + 24 backwards per step (two tower calls), 12 "
              f"forwards per validation batch, no bank kernel: {want}) "
              f"[{card}]")
        assert launches == want, (launches, want)
        assert not os.path.exists(os.path.join(out, "cirr_bank.npz"))
        runs[bool(ckpt_flag)] = (argv, out, losses)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

    # the same seed, the same first loss: rematerialisation changes what is
    # kept, not what is computed
    first, first_ckpt = runs[False][2][0], runs[True][2][0]
    assert abs(first - first_ckpt) <= 1e-6 * abs(first), (first, first_ckpt)

    argv, out, losses = runs[False]
    args, fresh = blip_sides(common, argv)
    _, trained = blip_sides(common, argv)
    trained.model.load_state_dict(
        load_blip_checkpoint(os.path.join(out, "best.pt")))
    for name in ("visual_encoder.blocks.0.attn.qkv.weight",
                 "visual_encoder.blocks.11.mlp.fc2.weight",
                 "visual_encoder.patch_embed.proj.weight", "vision_proj.weight",
                 "text_proj.weight", "tau",
                 "text_encoder.encoder.layer.3.crossattention.self.key.weight"):
        assert not torch.equal(fresh.model.state_dict()[name],
                               trained.model.state_dict()[name]), name
    preprocess = common.make_transform(trained, args)
    ds = CIRDataset("cirr", "train", "relative", preprocess, root,
                    args.dress_types, extend_suffix=trained.extend_suffix,
                    seed=args.seed, replace_extended=trained.replace_extended)
    raw = next(iter_train_images(ds, BLIP_S1_BATCH, shuffle=True,
                                 epoch_seed=args.seed))
    dev = trained.device
    batch = (torch.from_numpy(raw["refer_images"]).to(dev),
             torch.from_numpy(raw["target_images"]).to(dev),
             torch.from_numpy(trained.tokenize(raw["captions"])).to(dev))
    with torch.no_grad():
        before = fresh.stage1_loss(*batch).item()
        after = trained.stage1_loss(*batch).item()
    phase(f"blip stage-1 slice: first batch before training {before:.4f} "
          f"(logged {losses[0]:.4f}; with --grad_ckpt {first_ckpt:.4f}), "
          f"after {steps} steps {after:.4f}; the ViT, vision_proj, MED, "
          f"text_proj and tau moved [{card}]")
    assert abs(before - losses[0]) < 2e-3 * abs(before), (before, losses[0])
    assert after < before, (after, before)
    return total


def drive_blip_recipe(ak, bk, tmp, card):
    """Phase 9d: the blip stage-2 epoch loop at the recipe's bank size
    (65,536 x 256 float32) with a 2,048-image host refer pool at batch 128:
    ms/step, the host gather and the host-to-device copy of one batch's
    refer tokens, a profiler window, and the extraction rate."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from spn4cir_tpu_torch.bank.bank import Bank
    from spn4cir_tpu_torch.models.blip4cir import BlipCIR
    from spn4cir_tpu_torch.train.stage2 import create_train_state, train_epoch

    device = torch.device("cuda:0")
    backbone = BlipCIR("base", tau=BLIP_TAU, dtype=torch.bfloat16,
                       device=device)
    backbone.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator(device=device).manual_seed(4)
    target = unit_rows(RECIPE_BANK, BLIP_DIM, g, device)
    # 64 distinct images' worth of tokens, tiled: what a gather costs does
    # not depend on the values
    block = torch.randn(64, 577, 768, generator=g, device=device).cpu().numpy()
    refer = np.tile(block, (BLIP_POOL // 64, 1, 1))
    bank = Bank(refer=refer, target=target)
    state = create_train_state(backbone, 5e-6)
    steps, profile_steps = 6, 3

    def batches(n, seed):
        return synthetic_batches(n, BLIP_BATCH, BLIP_POOL, seed)

    backbone.train()
    train_epoch(backbone, state, bank, batches(2, 6), log_every=0)  # warm-up
    count = zero_counts(ak, bk)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    _, mean_loss = train_epoch(backbone, state, bank, batches(steps, 7),
                               log_every=0)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    event_ms = start.elapsed_time(end) / steps
    launches = read_counts(count)
    assert launches == dict(**NO_LONG, **NO_SHORT,
                            **bank_launches(False, steps)), launches
    assert math.isfinite(mean_loss), mean_loss

    # the two host stages of one batch's refer tokens, alone
    raws = list(batches(5, 8))
    gather, copy = [], []
    for raw in raws:
        t0 = time.perf_counter()
        rows = bank.gather_refer(raw)
        t1 = time.perf_counter()
        dev_rows = torch.from_numpy(rows).to(device)
        torch.cuda.synchronize()
        copy.append((time.perf_counter() - t1) * 1e3)
        gather.append((t1 - t0) * 1e3)
    gather_ms, copy_ms = statistics.median(gather), statistics.median(copy)
    mb = rows.nbytes / 1e6
    del dev_rows, rows

    def profiled(n, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            train_epoch(backbone, state, bank, batches(n, seed), log_every=0)
            torch.cuda.synchronize()
        return prof, (time.perf_counter() - t0) * 1e3

    profiled(1, 9)      # takes the profiler's start-up cost
    prof, window_ms = profiled(profile_steps, 10)
    trace = os.path.join(tmp, "blip_train_trace.json")
    prof.export_chrome_trace(trace)
    busy_ms, n_ops, groups = device_busy(trace)
    assert n_ops > 0, "the profiler's trace holds no device interval"
    per = {k: v / profile_steps for k, v in
           sorted(groups.items(), key=lambda kv: -kv[1])}
    busy_step = busy_ms / profile_steps
    stats = dict(ms_per_step=event_ms, wall_ms_per_step=wall_ms,
                 mean_loss=mean_loss, host_gather_ms=gather_ms,
                 host_to_device_copy_ms=copy_ms, refer_batch_mb=mb,
                 busy_ms_per_step=busy_step,
                 window_ms_per_step=window_ms / profile_steps,
                 idle_share_of_unprofiled_step=1 - busy_step / event_ms,
                 device_ops_per_step=n_ops / profile_steps,
                 ms_per_step_by_group=per)
    phase(f"blip recipe scale, M={RECIPE_BANK} x {BLIP_DIM} float32 bank, "
          f"{BLIP_POOL}-image host refer pool, batch {BLIP_BATCH}, BLIP base "
          f"bf16, {steps} steps: {event_ms:.3f} ms/step (CUDA events; host "
          f"clock {wall_ms:.3f}); one batch's refer tokens ({mb:.1f} MB): "
          f"host gather {gather_ms:.3f} ms "
          f"({100 * gather_ms / wall_ms:.1f}% of the step), host-to-device "
          f"copy {copy_ms:.3f} ms ({100 * copy_ms / wall_ms:.1f}%); device "
          f"busy {busy_step:.3f} ms/step in {n_ops / profile_steps:.0f} "
          f"device operations, idle share "
          f"{100 * (1 - busy_step / event_ms):.1f}% of the step timed "
          f"without the profiler ({window_ms / profile_steps:.3f} ms/step "
          f"under it); device ms per step by group: "
          f"{ {k: round(v, 3) for k, v in per.items()} } [{card}]")
    phase("blip recipe scale stats " + json.dumps(stats))
    assert per.get("bank kernels", 0) > 0, per

    del bank, refer, state
    blip_stage1_step(backbone, card)
    backbone.eval()
    images = torch.randn(BLIP_BATCH, 384, 384, 3, device=device,
                         generator=torch.Generator(device).manual_seed(2))
    qkv = [torch.randn(BLIP_BATCH * 12, 577, 64, device=device,
                       dtype=torch.bfloat16) for _ in range(3)]
    with torch.inference_mode():
        ms = median_ms(lambda: backbone.bank_features(images), reps=4,
                       warmup=1)
        attn_ms = 12 * median_ms(lambda: ak.long_attention_fwd(*qkv), reps=4,
                                 warmup=1)
    phase(f"BLIP base bf16 bank extraction at 384: "
          f"{BLIP_BATCH / (ms / 1e3):.1f} images/s on the device (batch "
          f"{BLIP_BATCH}, {ms:.3f} ms/batch; 12 long-attention launches at "
          f"its shape take {attn_ms:.1f} ms alone, "
          f"{100 * attn_ms / ms:.0f}% of the batch) [{card}]")


def blip_stage1_step(backbone, card):
    """The blip stage-1 step at batch 32 on one resident batch (no image
    decode): ms/step by CUDA events, then a profiler window."""
    from torch.profiler import ProfilerActivity, profile

    from spn4cir_tpu_torch.train.stage1 import (create_stage1_state,
                                                stage1_train_step)

    device = backbone.device
    state = create_stage1_state(backbone, 5e-6)
    g = torch.Generator(device=device).manual_seed(13)
    batch = {
        "refer_images": torch.randn(BLIP_S1_BATCH, 384, 384, 3, generator=g,
                                    device=device),
        "target_images": torch.randn(BLIP_S1_BATCH, 384, 384, 3, generator=g,
                                     device=device),
        "text_ids": torch.from_numpy(backbone.tokenize(
            [CAPTIONS[i % len(CAPTIONS)] for i in range(BLIP_S1_BATCH)])
        ).to(device)}
    backbone.train()
    step_ms = median_ms(lambda: stage1_train_step(backbone, state, batch),
                        reps=4, warmup=1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        for n in (1, 2):    # the first window takes the profiler's start-up
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    stage1_train_step(backbone, state, batch)
                torch.cuda.synchronize()
        trace = os.path.join(tmp, "blip_stage1_trace.json")
        prof.export_chrome_trace(trace)
        busy_ms, n_ops, groups = device_busy(trace)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert n_ops > 0, "the profiler's trace holds no device interval"
    per = {k: round(v / 2, 3) for k, v in
           sorted(groups.items(), key=lambda kv: -kv[1])}
    attn = per.get("attention kernels", 0.0)
    assert attn > 0, per
    phase(f"blip stage-1 step, BLIP base bf16, batch {BLIP_S1_BATCH}, one "
          f"resident batch, no --grad_ckpt: {step_ms:.3f} ms/step (median of "
          f"4, CUDA events); device busy {busy_ms / 2:.3f} ms/step in "
          f"{n_ops / 2:.0f} device operations, idle share "
          f"{100 * (1 - busy_ms / 2 / step_ms):.1f}%; the 24 + 24 "
          f"long-attention launches take {attn:.3f} ms/step "
          f"({100 * attn / step_ms:.1f}% of the step); device ms per step "
          f"by group: {per} [{card}]")
    backbone.zero_grad(set_to_none=True)
    del state


def check_blip_plain_step(layers, card):
    """Phase 8, blip: one float32 stage-1 loss and its gradients through the
    long-attention kernels and through the plain attention, same weights and
    batch; BLIP base width, 384-pixel images, two layers deep."""
    from spn4cir_tpu_torch.models.blip4cir import BlipCIR
    from spn4cir_tpu_torch.models.blip_vit import BlipViTConfig
    from spn4cir_tpu_torch.models.med import MedConfig
    from spn4cir_tpu_torch.train.stage1 import create_stage1_state

    device = torch.device("cuda:0")
    backbone = BlipCIR("base", tau=BLIP_TAU, dtype=torch.float32,
                       device=device, vit_cfg=BlipViTConfig(layers=2),
                       med_cfg=MedConfig(num_layers=2))
    backbone.init_params(torch.Generator().manual_seed(0))
    create_stage1_state(backbone, 5e-6)
    g = torch.Generator(device=device).manual_seed(12)
    refer, target = (torch.randn(4, 384, 384, 3, generator=g, device=device)
                     for _ in range(2))
    text_ids = torch.from_numpy(backbone.tokenize(CAPTIONS)).to(device)
    probe = ("visual_encoder.blocks.0.attn.qkv.weight",
             "visual_encoder.patch_embed.proj.weight",
             "visual_encoder.blocks.1.mlp.fc1.weight", "vision_proj.weight",
             "text_encoder.encoder.layer.0.crossattention.self.value.weight",
             "text_proj.weight")

    def run(impl):
        backbone.zero_grad(set_to_none=True)
        layers.set_attention_impl(backbone, impl)
        loss = backbone.stage1_loss(refer, target, text_ids)
        loss.backward()
        return loss.item(), [backbone.model.get_parameter(n).grad.clone()
                             for n in probe]

    kern_loss, kern_grads = run("auto")
    plain_loss, plain_grads = run("plain")
    layers.set_attention_impl(backbone, "auto")
    rel = [((a - b_).norm() / b_.norm()).item()
           for a, b_ in zip(kern_grads, plain_grads)]
    phase(f"one float32 blip stage-1 loss (B=4 at 384, two layers at BLIP "
          f"base width): long-attention kernels {kern_loss:.6f}, plain "
          f"attention {plain_loss:.6f} (rtol {STEP_TOL}); relative gradient "
          f"difference of {probe}: {[f'{r:.2e}' for r in rel]} (each under "
          f"{10 * STEP_TOL}) [{card}]")
    assert abs(kern_loss - plain_loss) <= STEP_TOL * abs(plain_loss)
    assert all(r < 10 * STEP_TOL for r in rel), rel


def check_plain_step(layers, bk, card):
    """Phase 8: one float32 loss and its gradients through the kernels and
    through the plain versions, same weights and batch, over a dense bank
    and over the same bank quantized to int8."""
    import numpy as np

    from spn4cir_tpu_torch.models.clip4cir import ClipCIR
    from spn4cir_tpu_torch.train.stage2 import create_train_state

    device = torch.device("cuda:0")
    backbone = ClipCIR("ViT-B/32", tau=TAU, dtype=torch.float32, device=device)
    backbone.init_params(torch.Generator().manual_seed(0))
    create_train_state(backbone, 2e-5)      # freezes what stage 2 freezes
    g = torch.Generator(device=device).manual_seed(9)
    m, b = 4099, 64
    bank = unit_rows(m, BANK_DIM, g, device)
    refer = torch.randn(b, BANK_DIM, generator=g, device=device)
    labels = torch.randint(0, m, (b,), generator=g, device=device)
    raw = next(synthetic_batches(1, b, m, 10))
    text_ids = torch.from_numpy(backbone.tokenize(raw["captions"])).to(device)
    probe = ("text_projection", "transformer.resblocks.0.attn.in_proj_weight",
             "transformer.resblocks.11.mlp.c_fc.weight", "token_embedding.weight")

    def run(plain: bool, target):
        backbone.zero_grad(set_to_none=True)
        layers.set_attention_impl(backbone, "plain" if plain else "auto")
        if plain:
            reference = (bk.bank_infonce_q8_reference
                         if isinstance(target, bk.QuantBank)
                         else bk.bank_infonce_reference)
            loss = reference(backbone.fuse(refer, text_ids), target, labels,
                             TAU)
        else:
            loss = backbone.stage2_loss(refer, text_ids, target, labels)
        loss.backward()
        return loss.item(), [backbone.model.get_parameter(n).grad.clone()
                             for n in probe]

    for target in (bank, bk.quantize_bank(bank)):
        kern_loss, kern_grads = run(False, target)
        plain_loss, plain_grads = run(True, target)
        layers.set_attention_impl(backbone, "auto")
        rel = [((a - b_).norm() / b_.norm()).item()
               for a, b_ in zip(kern_grads, plain_grads)]
        phase(f"one float32 ViT-B/32 stage-2 loss (B={b}, M={m}, "
              f"{dtype_name(target.dtype)} bank): kernels {kern_loss:.6f}, "
              f"plain versions {plain_loss:.6f} (rtol {STEP_TOL}); relative "
              f"gradient difference of {probe}: {[f'{r:.2e}' for r in rel]} "
              f"(each under {10 * STEP_TOL}) [{card}]")
        assert abs(kern_loss - plain_loss) <= STEP_TOL * abs(plain_loss)
        assert all(r < 10 * STEP_TOL for r in rel), rel
        assert np.isfinite(kern_loss)


def max_query_case(mk, bk, q, bank, labels, card, time_it=True):
    """#9 and #10 against their plain versions on one case (a dense
    (M, Q, D) bank or a 3-D QuantBank): the four statistics, the loss, dtau
    and dfeats; a second launch gives the same bits. Returns (fwd, bwd)
    records."""
    b, d = q.shape
    quant = isinstance(bank, bk.QuantBank)
    rows = bank.values if quant else bank
    m, nq = rows.shape[:2]
    gout = torch.tensor(1.0, device=q.device)
    loss, stats, dtau = mk.max_query_infonce_fwd(q, bank, labels, BLIP2_TAU)
    dq = mk.max_query_infonce_bwd(q, bank, labels, BLIP2_TAU, stats[0],
                                  stats[1], gout)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = mk.max_query_infonce_stats_reference(q, bank, labels, BLIP2_TAU)
        want_loss = mk.max_query_infonce_reference(q, bank, labels, BLIP2_TAU)
        want_dq = mk.max_query_infonce_bwd_reference(
            q, bank, labels, BLIP2_TAU, want[0], want[1], gout)
    for got_s, want_s in zip(stats, want):
        torch.testing.assert_close(got_s, want_s, atol=BANK_RTOL,
                                   rtol=BANK_RTOL)
    torch.testing.assert_close(loss, want_loss, atol=BANK_RTOL, rtol=BANK_RTOL)
    torch.testing.assert_close(dtau, bk.dtau_from_stats(want, BLIP2_TAU),
                               atol=10 * BANK_RTOL, rtol=BANK_RTOL)
    torch.testing.assert_close(dq, want_dq, atol=BANK_DQ_ATOL, rtol=BANK_RTOL)
    loss2, _, _ = mk.max_query_infonce_fwd(q, bank, labels, BLIP2_TAU)
    dq2 = mk.max_query_infonce_bwd(q, bank, labels, BLIP2_TAU, stats[0],
                                   stats[1], gout)
    assert torch.equal(loss, loss2) and torch.equal(dq, dq2), "not repeatable"
    fwd_err = max((a - b_).abs().max().item() for a, b_ in zip(stats, want))
    fwd_err = max(fwd_err, (loss - want_loss).abs().item())
    bwd_err = (dq - want_dq).abs().max().item()

    def over_tol(got_t, want_t, atol):
        return ((got_t - want_t).abs()
                / (atol + BANK_RTOL * want_t.abs())).max().item()

    fwd_share = max(over_tol(a, b_, BANK_RTOL) for a, b_ in
                    zip((*stats, loss), (*want, want_loss)))
    bwd_share = over_tol(dq, want_dq, BANK_DQ_ATOL)
    common = dict(shape=f"B={b}, M={m}, Q={nq}, D={d}",
                  dtype=dtype_name(bank.dtype))
    # float32 products (the bank widens exactly); bytes: feats, the bank
    # (with its scales), the labels, the statistics (the backward: mx, se,
    # gout in, dfeats out), each once
    bank_bytes = rows.numel() * rows.element_size() + (
        4 * bank.scales.numel() if quant else 0)
    f_ms, f_by = bound_ms(b * d * 4 + bank_bytes + b * 4 + 4 * b * 4 + 8,
                          2 * b * m * nq * d, torch.float32)
    b_ms, b_by = bound_ms(2 * b * d * 4 + bank_bytes + b * 4 + 2 * b * 4 + 4,
                          2 * b * m * nq * d + 2 * b * m * d, torch.float32)
    fwd = dict(common, rtol=BANK_RTOL, atol=BANK_RTOL, max_abs_err=fwd_err,
               max_err_over_tol=fwd_share, bound_ms=f_ms, bound_by=f_by)
    bwd = dict(common, rtol=BANK_RTOL, atol=BANK_DQ_ATOL, max_abs_err=bwd_err,
               max_err_over_tol=bwd_share, bound_ms=b_ms, bound_by=b_by)
    del want_dq, dq2
    if time_it:
        ce = torch.nn.functional.cross_entropy
        dense = bank.dequantize if quant else bank.float

        def library(feats):
            sims = torch.einsum("bd,mqd->bmq", feats, dense())
            return ce(sims.amax(dim=-1) / BLIP2_TAU, labels)

        with torch.no_grad():
            fwd["ms"] = median_ms(lambda: mk.max_query_infonce_fwd(
                q, bank, labels, BLIP2_TAU), reps=10)
            fwd["plain_ms"] = median_ms(
                lambda: mk.max_query_infonce_stats_reference(
                    q, bank, labels, BLIP2_TAU), reps=5, warmup=1)
            fwd["library_ms"] = median_ms(lambda: library(q), reps=5,
                                          warmup=1)
            bwd["ms"] = median_ms(lambda: mk.max_query_infonce_bwd(
                q, bank, labels, BLIP2_TAU, stats[0], stats[1], gout),
                reps=10)
            bwd["plain_ms"] = median_ms(
                lambda: mk.max_query_infonce_bwd_reference(
                    q, bank, labels, BLIP2_TAU, want[0], want[1], gout),
                reps=5, warmup=1)
        leaf = q.clone().requires_grad_()
        lib_loss = library(leaf)
        bwd["library_ms"] = median_ms(lambda: torch.autograd.grad(
            lib_loss, leaf, retain_graph=True), reps=5, warmup=1)
        del leaf, lib_loss
    for name, rec in (("max_query_infonce_fwd", fwd),
                      ("max_query_infonce_bwd", bwd)):
        times = (f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                 f"library (einsum + amax + cross_entropy"
                 f"{' backward' if name.endswith('bwd') else ''}) "
                 f"{rec['library_ms']:.4f} ms, " if time_it else "")
        phase(f"kernel {name} {rec['shape']} bank {rec['dtype']}: "
              f"max_abs_err={rec['max_abs_err']:.3e}, "
              f"{rec['max_err_over_tol']:.3f} of the tolerance "
              f"(atol={rec['atol']} + rtol={rec['rtol']}·|plain|), "
              f"repeatable; {times}bound {rec['bound_ms']:.5f} ms by "
              f"{rec['bound_by']} [{card}]")
    return fwd, bwd


def unit_bank(m, nq, d, generator, device):
    return torch.nn.functional.normalize(
        torch.randn(m, nq, d, generator=generator, device=device), dim=-1)


def check_max_query(mk, bk, device, card):
    """Phase 3e: the max-over-query kernels at blip2's stage-2 shape (B=32,
    M=65,536, Q=32, D=256) over float32, bfloat16 and int8 banks, timed;
    then a ragged case (B=5, M=1,000, Q=8) in the three types, the int8
    scales a view into a buffer whose tail is NaN. Returns the records of
    the two kernels."""
    g = torch.Generator(device=device).manual_seed(13)
    records = {"max_query_infonce_fwd": [], "max_query_infonce_bwd": []}

    def run(q, bank, labels, time_it=True):
        for name, rec in zip(records, max_query_case(mk, bk, q, bank, labels,
                                                     card, time_it)):
            records[name].append(rec)

    q = unit_rows(BLIP2_BATCH, BLIP_DIM, g, device)
    bank32 = unit_bank(RECIPE_BANK, BLIP2_QUERIES, BLIP_DIM, g, device)
    labels = torch.randint(0, RECIPE_BANK, (BLIP2_BATCH,), generator=g,
                           device=device)
    for bank in (bank32, bank32.to(torch.bfloat16), bk.quantize_bank(bank32)):
        run(q, bank, labels)
        del bank
        torch.cuda.empty_cache()
    del bank32
    b, m, nq = 5, 1000, 8
    q = unit_rows(b, BLIP_DIM, g, device)
    bank32 = unit_bank(m, nq, BLIP_DIM, g, device)
    labels = torch.randint(0, m, (b,), generator=g, device=device)
    run(q, bank32, labels, time_it=False)
    run(q, bank32.to(torch.bfloat16), labels, time_it=False)
    qbank = bk.quantize_bank(bank32)
    scales = torch.full((m + 300, nq), float("nan"), device=device)
    scales[:m] = qbank.scales
    run(q, bk.QuantBank(qbank.values, scales[:m]), labels, time_it=False)
    torch.cuda.empty_cache()
    return records


def blip2_unrun(name: str) -> bool:
    """Parts of Qformer_query that the stage-2 text re-read never runs: no
    gradient, so AdamW leaves them where they are."""
    return name.startswith("Qformer_query.") and (
        ".crossattention." in name or ".intermediate_query." in name
        or ".output_query." in name)


def drive_blip2_training(ak, bk, mk, root, tmp, card):
    """Phase 10a: `train_main("blip2")` (stage 2) through its argv, the
    checks, then `validate_main` and `submission_main` on its checkpoint.
    Returns the launch counts of the training run and of the two evaluation
    runs."""
    from spn4cir_tpu_torch.bank.bank import Bank
    from spn4cir_tpu_torch.cli import common, submission, train, validate
    from spn4cir_tpu_torch.data.datasets import CIRDataset, iter_train_bank
    from spn4cir_tpu_torch.models.convert import load_blip2_checkpoint

    out = os.path.join(tmp, "blip2_run")
    argv = blip_argv(root, "--batch-size", str(BLIP2_BATCH), "--num-epochs",
                      "1", "--learning-rate", BLIP2_LR, "--output_path", out)
    count = zero_counts(ak, bk)
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        best = train.train_main("blip2", argv, log_every=1)
    launches = read_counts(count)
    train_s = time.perf_counter() - t0
    losses = logged_losses(tee.buffer_.getvalue())
    steps = BLIP2_TRAIN // BLIP2_BATCH
    assert len(losses) == steps == 8, (len(losses), steps)

    args, fresh = blip_sides(common, argv, "blip2")
    assert args.tau == BLIP2_TAU and args.clip_model_name == "pretrain"
    ckpt = os.path.join(out, "best.pt")
    t1 = time.perf_counter()
    _, trained = blip_sides(common, argv, "blip2")
    trained.model.load_state_dict(load_blip2_checkpoint(ckpt))
    reload_s = time.perf_counter() - t1
    vit, qf = trained.vit_cfg, trained.q_cfg
    assert (vit.width, vit.layers, vit.heads, vit.num_tokens,
            int(vit.width * vit.mlp_ratio)) == (1408, EVA_LAYERS, 16, 257,
                                                6144), vit
    assert (qf.hidden_size, qf.num_layers, qf.num_query_tokens,
            qf.encoder_width, qf.vocab_size) == (768, 12, 32, 1408, 30524), qf
    n_params = sum(p.numel() for p in trained.parameters())

    preprocess = common.make_transform(trained, args)
    ds = CIRDataset("cirr", "train", "relative", preprocess, root,
                    args.dress_types, extend_suffix=trained.extend_suffix,
                    seed=args.seed, replace_extended=trained.replace_extended)
    m = ds.num_unique_images
    extract_batches = math.ceil(len(ds.triplets) / BLIP2_BATCH)
    val_batches = math.ceil(BLIP2_IMAGES / 32)
    # two EVA passes per triplet batch (refer and target images)
    want = dict(long_attention=EVA_LAYERS * (2 * extract_batches
                                             + val_batches),
                long_attention_bwd=0, **NO_SHORT,
                **bank_launches(False, steps, max_query=True))
    phase(f"blip2 training slice (train_main, EVA ViT-g + Q-Former bf16, "
          f"{n_params / 1e9:.3f} B parameters, batch {BLIP2_BATCH}): fusion "
          f"bank of {len(ds.triplets)} triplets and {m} target images in "
          f"{2 * extract_batches} EVA batches, {steps} steps, validation over "
          f"{BLIP2_IMAGES} images and {N_VAL} queries, {train_s:.1f} s in all "
          f"(best.pt read back and loaded in {reload_s:.1f} s); launches "
          f"{launches} (want {EVA_LAYERS} long-attention forwards per EVA "
          f"batch of extraction and validation, 1 max-query forward + 1 "
          f"backward per step and no attention launch inside the steps: "
          f"{want})")
    assert launches == want, (launches, want)

    moved, still = [], []
    fresh_sd, trained_sd = fresh.model.state_dict(), trained.model.state_dict()
    for name, before in fresh_sd.items():
        after = trained_sd[name]
        trains = name.startswith(("Qformer_query.", "text_proj_q.", "temp"))
        if not trains or blip2_unrun(name):
            assert torch.equal(before, after), f"frozen {name} changed"
        else:
            (still if torch.equal(before, after) else moved).append(name)
    # a key bias has a gradient of exactly zero and starts at zero
    assert all(n.endswith(".self.key.bias") for n in still), still
    for name in ("temp", "text_proj_q.weight",
                 "Qformer_query.bert.embeddings.word_embeddings.weight",
                 "Qformer_query.bert.encoder.layer.0.attention.self.query.weight",
                 "Qformer_query.bert.encoder.layer.11.output.dense.weight",
                 "Qformer_query.bert.encoder.layer.5.output.LayerNorm.bias"):
        assert name in moved, f"{name} did not move"

    bank = Bank.load(os.path.join(out, "cirr_bank.npz"), device=trained.device)
    assert bank.refer_key == "triplet"
    assert bank.target.shape == (m, BLIP2_QUERIES, BLIP_DIM), bank.target.shape
    assert bank.refer.shape == (len(ds.triplets), BLIP2_QUERIES, 768)
    assert torch.isfinite(bank.target).all()
    raw = next(iter_train_bank(ds, BLIP2_BATCH, epoch_seed=args.seed))
    dev = trained.device
    batch = (torch.from_numpy(bank.gather_refer(raw)).to(dev),
             torch.from_numpy(trained.tokenize(raw["captions"])).to(dev),
             bank.target, torch.from_numpy(raw["target_image_id"]).to(dev))
    with torch.no_grad():
        before = fresh.stage2_loss(*batch).item()
        after = trained.stage2_loss(*batch).item()
    temp = trained.model.temp.item()
    phase(f"blip2 training slice: per-step losses "
          f"{[round(x, 4) for x in losses]}; first batch before training "
          f"{before:.4f} (logged {losses[0]:.4f}), after {steps} steps "
          f"{after:.4f}; temp {BLIP2_TAU} -> {temp:.6f}; best score "
          f"{best:.2f}; {len(moved)} tensors of Qformer_query, text_proj_q "
          f"and temp moved ({len(still)} zero-gradient key biases did not; "
          f"the copy's cross-attention and query feed-forward, which the "
          f"text re-read never runs, held), EVA, ln_vision, Qformer, the "
          f"projections and the query tokens bit-identical [{card}]")
    assert abs(before - losses[0]) < 2e-3 * abs(before), (before, losses[0])
    assert after < before, (after, before)
    assert temp != BLIP2_TAU

    # #9 / #10 at the shape this path gave them: the extracted bank
    q = unit_rows(BLIP2_BATCH, BLIP_DIM,
                  torch.Generator(device=dev).manual_seed(3), dev)
    max_query_case(mk, bk, q, bank.target, batch[3], card, time_it=False)
    del bank, batch, fresh, trained
    torch.cuda.empty_cache()

    # validate_main and submission_main on the checkpoint
    eval_argv = blip_argv(root, "--model_path", ckpt)
    count = zero_counts(ak, bk)
    with contextlib.redirect_stdout(io.StringIO()):
        results = validate.validate_main("blip2", eval_argv)
    assert set(results) >= {"recall_at1", "recall_at5", "recall_at50",
                            "group_recall_at1", "arithmetic_mean"}, results
    assert all(math.isfinite(v) and 0.0 <= v <= 100.0
               for v in results.values()), results
    assert abs(results["arithmetic_mean"] - best) < 1e-6, (results, best)
    cwd = os.getcwd()
    os.chdir(tmp)       # the files land under the working directory
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            paths = submission.submission_main(
                "blip2", eval_argv + ["--submission-name", "blip2_smoke"])
        docs = []
        for path in paths:
            with open(path) as fh:
                docs.append(json.load(fh))
    finally:
        os.chdir(cwd)
    eval_launches = read_counts(count)
    pred, group = docs
    assert (pred.pop("version"), pred.pop("metric")) == ("rc2", "recall")
    assert (group.pop("version"), group.pop("metric")) == (
        "rc2", "recall_subset")
    assert len(pred) == len(group) == N_VAL and set(pred) == set(group)
    assert all(len(v) == len(set(v)) == 50 for v in pred.values())
    assert all(len(v) == 3 for v in group.values())
    want = dict(long_attention=EVA_LAYERS * 2 * val_batches,
                long_attention_bwd=0, **NO_SHORT, **bank_launches(False, 0))
    phase(f"blip2 training slice: validate_main on best.pt "
          f"{json.dumps(results)}; submission_main wrote "
          f"{[os.path.relpath(p, 'submission') for p in paths]}: {len(pred)} "
          f"pairs, 50 and 3 names each; launches {eval_launches} (want "
          f"{want})")
    assert eval_launches == want, (eval_launches, want)
    return launches, eval_launches


def drive_blip2_recipe(ak, bk, tmp, card):
    """Phase 10c: the blip2 stage-2 epoch loop at the recipe's batch of 32
    against a synthetic 65,536 x 32 x 256 target bank (float32, then int8)
    and a 2,048-triplet host refer pool of fused states (32 x 768 each):
    ms/step, the host gather and the host-to-device copy of one batch's
    refer rows, a profiler window per bank type; then the EVA-g extraction
    rate at batch 32 with #3's share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from spn4cir_tpu_torch.bank.bank import Bank
    from spn4cir_tpu_torch.models.blip24cir import Blip2CIR
    from spn4cir_tpu_torch.train.stage2 import create_train_state, train_epoch

    device = torch.device("cuda:0")
    backbone = Blip2CIR("pretrain", tau=BLIP2_TAU, dtype=torch.bfloat16,
                        device=device)
    backbone.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator(device=device).manual_seed(4)
    target32 = unit_bank(RECIPE_BANK, BLIP2_QUERIES, BLIP_DIM, g, device)
    # 64 distinct triplets' worth of fused states, tiled: what a gather
    # costs does not depend on the values
    block = torch.randn(64, BLIP2_QUERIES, 768, generator=g,
                        device=device).cpu().numpy()
    refer = np.tile(block, (BLIP2_POOL // 64, 1, 1))
    state = create_train_state(backbone, 1e-5)
    steps, profile_steps = 6, 3

    def batches(n, seed):
        return synthetic_batches(n, BLIP2_BATCH, BLIP2_POOL, seed)

    results = {}
    for name in ("float32", "int8"):
        quant = name == "int8"
        bank = Bank(refer=refer, target=bk.quantize_bank(target32) if quant
                    else target32, refer_key="triplet")
        backbone.train()
        train_epoch(backbone, state, bank, batches(2, 6), log_every=0)
        count = zero_counts(ak, bk)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        _, mean_loss = train_epoch(backbone, state, bank, batches(steps, 7),
                                   log_every=0)
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        event_ms = start.elapsed_time(end) / steps
        launches = read_counts(count)
        assert launches == dict(**NO_LONG, **NO_SHORT,
                                **bank_launches(False, steps, max_query=True)
                                ), launches
        assert math.isfinite(mean_loss), mean_loss

        # the two host stages of one batch's refer rows, alone
        gather, copy = [], []
        for raw in batches(5, 8):
            t0 = time.perf_counter()
            rows = bank.gather_refer(raw)
            t1 = time.perf_counter()
            dev_rows = torch.from_numpy(rows).to(device)
            torch.cuda.synchronize()
            copy.append((time.perf_counter() - t1) * 1e3)
            gather.append((t1 - t0) * 1e3)
        gather_ms, copy_ms = statistics.median(gather), statistics.median(copy)
        mb = rows.nbytes / 1e6
        del dev_rows, rows

        def profiled(n, seed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                train_epoch(backbone, state, bank, batches(n, seed),
                            log_every=0)
                torch.cuda.synchronize()
            return prof, (time.perf_counter() - t0) * 1e3

        profiled(1, 9)      # takes the profiler's start-up cost
        prof, window_ms = profiled(profile_steps, 10)
        trace = os.path.join(tmp, f"blip2_train_trace_{name}.json")
        prof.export_chrome_trace(trace)
        busy_ms, n_ops, groups = device_busy(trace)
        assert n_ops > 0, "the profiler's trace holds no device interval"
        per = {k: v / profile_steps for k, v in
               sorted(groups.items(), key=lambda kv: -kv[1])}
        assert per.get("max-query kernels", 0) > 0, per
        busy_step = busy_ms / profile_steps
        results[name] = dict(
            ms_per_step=event_ms, wall_ms_per_step=wall_ms,
            mean_loss=mean_loss, host_gather_ms=gather_ms,
            host_to_device_copy_ms=copy_ms, refer_batch_mb=mb,
            busy_ms_per_step=busy_step,
            window_ms_per_step=window_ms / profile_steps,
            idle_share_of_unprofiled_step=1 - busy_step / event_ms,
            device_ops_per_step=n_ops / profile_steps,
            ms_per_step_by_group=per)
        mq_ms = per["max-query kernels"]
        phase(f"blip2 recipe scale, M={RECIPE_BANK} x {BLIP2_QUERIES} x "
              f"{BLIP_DIM} {name} bank, {BLIP2_POOL}-triplet host refer pool, "
              f"batch {BLIP2_BATCH}, Q-Former bf16, {steps} steps: "
              f"{event_ms:.3f} ms/step (CUDA events; host clock "
              f"{wall_ms:.3f}); one batch's refer rows ({mb:.1f} MB): host "
              f"gather {gather_ms:.3f} ms, host-to-device copy {copy_ms:.3f} "
              f"ms; device busy {busy_step:.3f} ms/step in "
              f"{n_ops / profile_steps:.0f} device operations, idle share "
              f"{100 * (1 - busy_step / event_ms):.1f}% of the step timed "
              f"without the profiler ({window_ms / profile_steps:.3f} "
              f"ms/step under it); the max-query kernels {mq_ms:.3f} ms/step "
              f"({100 * mq_ms / event_ms:.1f}% of the step); device ms per "
              f"step by group: { {k: round(v, 3) for k, v in per.items()} } "
              f"[{card}]")
        del bank
        torch.cuda.empty_cache()
    phase("blip2 recipe scale stats " + json.dumps(results))
    del state, target32, refer

    backbone.eval()
    images = torch.randn(BLIP2_BATCH, 224, 224, 3, device=device,
                         generator=torch.Generator(device).manual_seed(2))
    text = torch.from_numpy(backbone.tokenize(
        [CAPTIONS[j % len(CAPTIONS)] for j in range(BLIP2_BATCH)])).to(device)
    qkv = [torch.randn(EVA_EXTRACT["bh"], 257, 88, device=device,
                       dtype=torch.bfloat16) for _ in range(3)]
    with torch.inference_mode():
        ms = median_ms(lambda: backbone.fusion_bank_features(images, text),
                       reps=4, warmup=1)
        attn_ms = EVA_LAYERS * median_ms(lambda: ak.long_attention_fwd(*qkv),
                                         reps=4, warmup=1)
    phase(f"EVA ViT-g bf16 bank extraction at 224 (fusion_bank_features): "
          f"{BLIP2_BATCH / (ms / 1e3):.1f} images/s on the device (batch "
          f"{BLIP2_BATCH}, {ms:.3f} ms/batch; {EVA_LAYERS} long-attention "
          f"launches at its shape take {attn_ms:.1f} ms alone, "
          f"{100 * attn_ms / ms:.0f}% of the batch) [{card}]")


def check_blip2_plain_step(layers, bk, mk, card):
    """Phase 8, blip2: one float32 stage-2 loss and its gradients through
    #9 / #10 and through the plain versions, same weights and batch, over a
    dense and over an int8 bank; the Q-Former at full width (its EVA cut to
    two layers: the stage-2 loss does not run it)."""
    from spn4cir_tpu_torch.models.blip24cir import Blip2CIR
    from spn4cir_tpu_torch.models.eva_vit import EvaViTConfig
    from spn4cir_tpu_torch.train.stage2 import create_train_state

    device = torch.device("cuda:0")
    backbone = Blip2CIR("pretrain", tau=BLIP2_TAU, dtype=torch.float32,
                        device=device, vit_cfg=EvaViTConfig(layers=2))
    backbone.init_params(torch.Generator().manual_seed(0))
    create_train_state(backbone, 1e-5)      # freezes what stage 2 freezes
    g = torch.Generator(device=device).manual_seed(14)
    m, b = 4099, BLIP2_BATCH
    bank = unit_bank(m, BLIP2_QUERIES, BLIP_DIM, g, device)
    refer = torch.randn(b, BLIP2_QUERIES, 768, generator=g, device=device)
    labels = torch.randint(0, m, (b,), generator=g, device=device)
    raw = next(synthetic_batches(1, b, m, 10))
    text_ids = torch.from_numpy(backbone.tokenize(raw["captions"])).to(device)
    probe = ("Qformer_query.bert.encoder.layer.0.attention.self.query.weight",
             "Qformer_query.bert.encoder.layer.11.output.dense.weight",
             "Qformer_query.bert.embeddings.word_embeddings.weight",
             "text_proj_q.weight", "temp")

    def run(plain: bool, target):
        backbone.zero_grad(set_to_none=True)
        if plain:
            loss = mk.max_query_infonce_reference(
                backbone.stage2_query_feats(refer, text_ids), target, labels,
                backbone.model.temp)
        else:
            loss = backbone.stage2_loss(refer, text_ids, target, labels)
        loss.backward()
        return loss.item(), [backbone.model.get_parameter(n).grad.clone()
                             for n in probe]

    for target in (bank, bk.quantize_bank(bank)):
        kern_loss, kern_grads = run(False, target)
        plain_loss, plain_grads = run(True, target)
        rel = [((a - b_).norm() / b_.norm()).item()
               for a, b_ in zip(kern_grads, plain_grads)]
        phase(f"one float32 blip2 stage-2 loss (B={b}, M={m}, Q="
              f"{BLIP2_QUERIES}, {dtype_name(target.dtype)} bank, Q-Former "
              f"at full width): kernels {kern_loss:.6f}, plain versions "
              f"{plain_loss:.6f} (rtol {STEP_TOL}); relative gradient "
              f"difference of {probe}: {[f'{r:.2e}' for r in rel]} (each "
              f"under {10 * STEP_TOL}) [{card}]")
        assert abs(kern_loss - plain_loss) <= STEP_TOL * abs(plain_loss)
        assert all(r < 10 * STEP_TOL for r in rel), rel
        assert math.isfinite(kern_loss)


def pick(records, **want):
    return next(r for r in records
                if all(r[k] == v for k, v in want.items()))


def timing(at):
    return {"ms_at": f"{at.get('tower', '')} {at['shape']} {at['dtype']}".strip(),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"]}


def kernel_entry(name, replaces, source, launches_by_path, on_paths, records,
                 at, also=()):
    """One entry of the kernels line: `launches` is the sum over the main
    paths that were driven, each counted from zero and listed under
    `launches_by_path`; the kernel must have run on every path of
    `on_paths` and on no other. The times and the bound are those of the
    record `at` (a main-path shape), with the other main-path shapes under
    `also_at`; max_abs_err is the largest over every comparison of this
    kernel."""
    for path, n in launches_by_path.items():
        assert (n > 0) == (path in on_paths), (name, launches_by_path)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": at["ms"], "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
        "library_ms": at["library_ms"],
        "ms_at": timing(at)["ms_at"],
        "also_at": [timing(r) for r in also],
        "checks": records,
    }


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke runs "
                         "only on an NVIDIA GPU")
    sys.path.insert(0, REPO)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # the tokenizer reads SPN4CIR_BPE_VOCAB when it first loads
        merges = os.path.join(tmp, "bpe_synthetic.txt.gz")
        os.environ["SPN4CIR_BPE_VOCAB"] = merges
        fixtures = load_test_module("torch_fixtures")
        fixtures.write_merges_file(merges)
        # and so does the WordPiece tokenizer with SPN4CIR_BERT_VOCAB
        os.environ["SPN4CIR_BERT_VOCAB"] = fixtures.write_bert_vocab(
            os.path.join(tmp, "bert_vocab_synthetic.txt"))
        from spn4cir_tpu_torch.models import layers
        from spn4cir_tpu_torch.ops import attention_kernels as ak
        from spn4cir_tpu_torch.ops import bank_kernels as bk
        from spn4cir_tpu_torch.ops import cuda_build
        from spn4cir_tpu_torch.ops import maxquery_kernels as mk

        device = torch.device("cuda:0")
        card = card_line()
        phase(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
              f"torch {torch.__version__}, CUDA {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase("TF32 off for matmul and cuDNN (float32 comparisons)")

        # phase 2: build
        build_kernels(cuda_build)

        # phase 3: kernels against their plain versions
        fwd_records = check_attention_fwd(ak, device, card)
        bwd_records = check_attention_bwd(ak, device, card)
        bank_records = check_bank(bk, device, card)
        long_fwd_records, long_bwd_records = check_long_attention(
            ak, device, card)
        mq_records = check_max_query(mk, bk, device, card)

        # one synthetic CIRR tree for the two ViT-B/32 slices, a smaller one
        # for the flagship slice
        make_cirr = load_test_module("fixtures").make_cirr
        root = make_cirr(os.path.join(tmp, "cirr"), n_images=N_GALLERY,
                         n_train=N_TRAIN, n_val=N_VAL, extended=False)
        flagship_root = make_cirr(
            os.path.join(tmp, "cirr_flagship"), n_images=FLAGSHIP_IMAGES,
            n_train=FLAGSHIP_TRAIN, n_val=N_VAL, extended=False)

        # phase 4: the serving slice
        serve_launches = drive_serving(ak, bk, layers, root, card)

        # phase 5: the training slice through its entry point
        train_launches, _, _ = drive_training_cli(ak, bk, root, tmp, card)

        # phase 6: the flagship recipe through its three entry points
        flagship_launches, argv, trained = drive_training_cli(
            ak, bk, flagship_root, tmp, card, model=FLAGSHIP,
            bank_dtype="int8", n_gallery=FLAGSHIP_IMAGES,
            n_train=FLAGSHIP_TRAIN)
        eval_launches = drive_flagship_eval(ak, bk, argv, trained, tmp, card)
        del trained
        torch.cuda.empty_cache()

        # phase 7: the training loop at the recipe's bank size
        drive_training_recipe(ak, bk, tmp, card, "ViT-B/32", ("bfloat16",))
        drive_training_recipe(ak, bk, tmp, card, FLAGSHIP,
                              ("int8", "float32"))

        # phase 9: blip4cir through its entry points
        blip_root = make_cirr(os.path.join(tmp, "cirr_blip"),
                              n_images=BLIP_IMAGES, n_train=BLIP_TRAIN,
                              n_val=N_VAL, extended=False)
        blip_s1_root = make_cirr(os.path.join(tmp, "cirr_blip_stage1"),
                                 n_images=BLIP_S1_IMAGES,
                                 n_train=BLIP_S1_TRAIN, n_val=N_VAL,
                                 extended=False)
        blip_serve_launches = drive_blip_serving(ak, bk, layers, blip_root,
                                                 card)
        blip_train_launches, blip_eval_launches = drive_blip_training(
            ak, bk, blip_root, tmp, card)
        blip_stage1_launches = drive_blip_stage1(ak, bk, blip_s1_root, tmp,
                                                 card)
        drive_blip_recipe(ak, bk, tmp, card)
        torch.cuda.empty_cache()

        # phase 10: blip24cir through its entry points
        blip2_root = make_cirr(os.path.join(tmp, "cirr_blip2"),
                               n_images=BLIP2_IMAGES, n_train=BLIP2_TRAIN,
                               n_val=N_VAL, extended=False)
        blip2_train_launches, blip2_eval_launches = drive_blip2_training(
            ak, bk, mk, blip2_root, tmp, card)
        torch.cuda.empty_cache()
        blip2_serve_launches = drive_blip_serving(ak, bk, layers, blip2_root,
                                                  card, BLIP2_SERVING)
        torch.cuda.empty_cache()
        drive_blip2_recipe(ak, bk, tmp, card)
        torch.cuda.empty_cache()

        # phase 8: kernels vs plain versions through one whole loss
        check_plain_step(layers, bk, card)
        check_blip_plain_step(layers, card)
        check_blip2_plain_step(layers, bk, mk, card)

        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "optax", "spn4cir_tpu"))
        assert not bad, f"JAX or the JAX package was imported: {bad}"

        def by_path(name):
            return {"serve": serve_launches[name],
                    "train": train_launches[name],
                    "flagship": flagship_launches[name] + eval_launches[name],
                    "blip_serve": blip_serve_launches[name],
                    "blip_train": (blip_train_launches[name]
                                   + blip_eval_launches[name]),
                    "blip_stage1": blip_stage1_launches[name],
                    "blip2_serve": blip2_serve_launches[name],
                    "blip2_train": (blip2_train_launches[name]
                                    + blip2_eval_launches[name])}

        at_bank = f"B={TRAIN_BATCH}, M={RECIPE_BANK}, D={BANK_DIM}"
        at_flag = f"B={TRAIN_BATCH}, M={RECIPE_BANK}, D={FLAGSHIP_DIM}"
        csrc = "spn4cir_tpu_torch/csrc/"
        jax_ops = "spn4cir_tpu/ops/"
        entries = [kernel_entry(
            "short_attention", jax_ops + "attention_kernels.py:257",
            csrc + "short_attention.cu", by_path("short_attention"),
            ("serve", "train", "flagship"), fwd_records,
            pick(fwd_records, tower="vision", dtype="bfloat16"),
            also=[pick(fwd_records, tower=t, dtype="bfloat16") for t in
                  ("text", "train-text", "flagship-text",
                   "flagship-eval-text")])]
        entries.append(kernel_entry(
            "short_attention_bwd", jax_ops + "attention_kernels.py:279",
            csrc + "short_attention.cu", by_path("short_attention_bwd"),
            ("train", "flagship"), bwd_records,
            pick(bwd_records, tower="train-text", dtype="bfloat16"),
            also=[pick(bwd_records, tower="flagship-text",
                       dtype="bfloat16")]))
        for name, line in (("bank_infonce_fwd", 53), ("bank_infonce_bwd", 148)):
            recs = bank_records[name]
            entries.append(kernel_entry(
                name, f"{jax_ops}bank_kernels.py:{line}",
                csrc + "bank_infonce.cu", by_path(name),
                ("train", "blip_train"), recs,
                pick(recs, shape=at_bank, dtype="float32"),
                also=[pick(recs, shape=at_bank, dtype="bfloat16"),
                      pick(recs, shape=at_flag, dtype="float32"),
                      pick(recs, shape=at_flag, dtype="bfloat16"),
                      pick(recs, shape=f"B={TRAIN_BATCH}, M={RECIPE_BANK}, "
                                       f"D=768", dtype="float32"),
                      pick(recs, shape=f"B={BLIP_BATCH}, M={RECIPE_BANK}, "
                                       f"D={BLIP_DIM}", dtype="float32")]))
        for name, line in (("bank_infonce_q8_fwd", 398),
                           ("bank_infonce_q8_bwd", 444)):
            recs = bank_records[name]
            entries.append(kernel_entry(
                name, f"{jax_ops}bank_kernels.py:{line}",
                csrc + "bank_infonce.cu", by_path(name), ("flagship",), recs,
                pick(recs, shape=at_flag, dtype="int8"),
                also=[pick(recs, shape=at_bank, dtype="int8")]))
        for name, line, on_paths, recs in (
                ("long_attention", 74,
                 ("blip_serve", "blip_train", "blip_stage1", "blip2_serve",
                  "blip2_train"),
                 long_fwd_records),
                ("long_attention_bwd", 109, ("blip_stage1",),
                 long_bwd_records)):
            entries.append(kernel_entry(
                name, f"{jax_ops}attention_kernels.py:{line}",
                csrc + "long_attention.cu", by_path(name), on_paths, recs,
                pick(recs, tower="blip-index", dtype="bfloat16"),
                also=[pick(recs, tower="blip-extract", dtype="bfloat16"),
                      pick(recs, tower="blip-extract", dtype="float32"),
                      pick(recs, tower="blip-index", dtype="float32"),
                      pick(recs, tower="eva-g-extract", dtype="bfloat16"),
                      pick(recs, tower="eva-g-extract", dtype="float32")]))
        at_mq = (f"B={BLIP2_BATCH}, M={RECIPE_BANK}, Q={BLIP2_QUERIES}, "
                 f"D={BLIP_DIM}")
        for name, line in (("max_query_infonce_fwd", 72),
                           ("max_query_infonce_bwd", 116)):
            recs = mq_records[name]
            entries.append(kernel_entry(
                name, f"{jax_ops}maxquery_kernels.py:{line}",
                csrc + "max_query_infonce.cu", by_path(name),
                ("blip2_train",), recs,
                pick(recs, shape=at_mq, dtype="float32"),
                also=[pick(recs, shape=at_mq, dtype="bfloat16"),
                      pick(recs, shape=at_mq, dtype="int8")]))
        assert len(entries) == 10, len(entries)
        print(json.dumps({"kernels": entries}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
