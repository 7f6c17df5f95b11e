#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 in practice).

    python3 chip_smoke.py

Phases (one line or more each; any failure is an uncaught exception and a
non-zero exit):
  1. device: CUDA must be present; prints the card and its power limit and
     turns TF32 off for the comparisons;
  2. build: compiles the port's CUDA sources from csrc/ with nvcc, one nvcc
     per source, started together; the tensor-core kernels (bf16 long and
     short attention, forward and backward, the split-TF32 bank kernels
     over float32, bf16 and int8 banks, the int8-weight product over
     float32 and bf16 x) must hold HMMA instructions and spill nothing;
  3. kernels: each of the twelve kernels against its plain PyTorch version
     on the card at the shapes of the serving, training, flagship, blip and
     blip2 paths (short attention in bfloat16 and float32 at the ViT-B/32
     towers' slices and at RN50x4's 10-head text tower; the bank InfoNCE
     over float32, bfloat16 and int8 banks at D = 512, 640 and 768, with a
     ragged case each and a shallow one; the short attention, forward and
     backward, also at the edges of its tensor-core kernels, S = 1..128 x
     D = 8..128, causal and not, and at a BH past the blocks the card
     holds; #1, #2 and the bank kernels timed per call and as the device
     time of back-to-back launches, with TFLOP/s and the share of the
     bound; the long attention, forward and backward, at
     BLIP's
     (1536, 577, 64) and (384, 577, 64), at EVA-g's extraction slice
     (512, 257, 88) and (256, 257, 88), at ViT-L/14's and ViT-B/16's
     slices (LLaVA's tower over a group of 16: (256, 257, 64), timed), a
     ragged one and the edges of its tiles (S = 63, 65, 129),
     with each timed record's TFLOP/s and share of its bound; the
     max-over-query InfoNCE at blip2's B=32, M=65,536, Q=32, D=256 over
     float32, bfloat16 and int8 banks and a ragged B=5, M=1,000, Q=8; two
     launches giving the same bits), with the kernel's time, the plain
     version's, the time of the PyTorch library call that computes the
     same function (a yardstick only) and the bound (the larger of bytes /
     3.35 TB/s and operations / peak);
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
     then float32): the host gather and copy of one batch's refer rows,
     ms/step over three timed windows of 10 steps (their median and
     spread), then a profiler window over further steps
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
     copy, device busy, idle share) and the extraction rate with a
     profiled batch (device busy, idle share, ms by kernel group);
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
     group); the EVA-g extraction rate at batch 32 with #3's share and a
     profiled batch;
 11. the LLaMA-2-7B-chat rewriter of the datagen pipeline at full width (32
     layers, width 4096, 32 heads of 128, MLP 11008, vocabulary 32,000;
     random bf16 weights drawn on the device from seed 0; the byte
     tokenizer, as the repository has no sentencepiece model), on a
     32-image synthetic CIRR tree with 32 CIRR-like captions: (a)
     `generate_extended_triplets` with the batch rewriter that
     `load_torch_rewriter` composes (B=16, 50 new tokens, prefill in chunks
     of 128), then `write_extended_triplets`, over a bf16 and then an int8
     KV cache (32 x 49 x 2 = 3,136 launches of #11 each; prefill ms per
     group, decode ms/step, tokens/s, peak memory, a profiler window over
     decode steps; over bf16 the first step's logits through #11 against
     the plain route from the same cache); (b) the weights through
     `quantize_llama_weights` and `llama_generate(quant_kernel=True,
     cache_dtype=int8)` at B = 1, 8, 16 (225 launches of #12 per decode
     step), and the decode step timed through #12, through
     dequant-after-matmul and with the bf16 model; (c) `python -m
     spn4cir_tpu_torch.cli.get_cir_data ... --llm_backend torch-tiny`
     through its main(), #11 at head_dim 8; (d) at full width, 2 layers,
     float32, greedy, B=4: #11 on and off, and #12 on and
     dequant-after-matmul over int8 weights, give the same 50-token
     streams (where they part, the plain path's top-2 margin there must be
     under the float32 tolerance);
 12. tgcir at full width (CLIP ViT-B/16 at 224: vision 12 x 768, text 12 x
     512 with 8 heads, embedding 512, plus the token learners, masks and
     gate; bf16 over float32 weights, random from seed 0) on the flagship
     slice's 1,024-image tree: `serve_main(backbone_name="tgcir")` with
     concurrent and sequential /retrieve requests (12 launches of the long
     attention per encode batch at S=197, 12 short ones per fuse dispatch;
     8 references re-encoded with plain attention keep their top-1);
     `train_main("tgcir")` at batch 256 over a float32 bank, then over the
     same bank cache in int8 (12 + 12 short-attention launches and 1 + 1
     bank launches a step; the image branch bit-identical, the text branch
     moved, the first batch's loss lower), `validate_main("tgcir")` and
     `submission_main("tgcir")` on its checkpoint; phase 7's recipe loop
     for tgcir: batch 256 against a 65,536 x 512 bank, float32 then int8,
     with the full 65,536 x 12 x 512 float32 refer bank on the host;
 13. the stage-1 ablations and zscir: `cli.train_negtype` (`--wo_bank
     --neg_type 15`) with ViT-B/32 bf16 at batch 256 for an epoch of the
     flagship tree (36 + 36 short-attention launches a step: two vision
     calls and one text call); `cli.train_zs` at full ViT-L/14 width
     (24 x 1024 vision, 12 x 768 text, every weight training) at batch 48
     over a tree of generated triplets that replace the human ones (24 +
     24 long-attention launches at (1536, 257, 64) and 12 + 12 short ones
     a step), then its step on one resident batch (ms/step, device busy,
     idle share, launches a step, ms by kernel group);
 14. the captioning stage, LLaVA-v1-7B at full width (CLIP ViT-L/14 at 224,
     23 blocks through #3; the 1024 -> 4096 projector; LLaMA-7B, random
     bf16 weights drawn on the card; the byte tokenizer): (a)
     `datagen.captioner.make_llava_captioner`, `caption_images_batched`
     with a jsonl sidecar and `write_it_list` over the 32 images of the
     rewrite tree in 2 groups of 16 (483-row prompts, 64 new tokens: 23
     launches of #3 per group and 32 x 63 of #11), captions/s, tower ms per
     batch, prefill ms per group, decode ms/step, a profiler window over
     decode steps; the sidecar resume (the second group torn off and
     captioned again, the same captions); the first group's streams
     against plain attention in the tower and `attn_kernel=False` (where
     they part, the plain margin within twice the routes' measured logit
     difference); (b) its batched_fn behind a `CaptionService`, 8
     concurrent requests with two prompts; (c) `cli.get_cir_data` (phase
     11c before) rewriting the tree's triplets from that it-list: caption
     -> rewrite as one chain;
 15. BLIP caption base at full width (ViT-B/16 at 384 through #3, the
     12-layer MED decoder over 30,524 words, float32): `python -m
     spn4cir_tpu_torch.cli.captioner --mllm blip` through its main() over a
     64-image synthetic CIRR tree at batch 32, beam 3; again (the resume
     loads no model); with `--nucleus`; then `cli.serve_mllm --mllm blip
     --no-block` with 16 concurrent /caption requests (every reply a
     non-empty string, the requests coalesced);
 16. `cli.retrieval` (ViT-L/14 float32, random weights from seed 0) i2i
     over the 64 images of phase 15's tree and t2i for 4 captions;
 17. the scaling-positives datagen and resume: (a) `cli.deduplicate_images`
     over a 1,024-image synthetic CIRR tree with 32 planted pixel-identical
     re-saves (the groups found, `CIRDataset` reading the map); (b)
     `cli.srm_utils` at full width over its unique train images: random
     Unicom ViT-L/14 (float32 attention through #3 at S = 256) and
     BGE-base read from files in the reference's layout, the synthetic
     30,522-word vocabulary, CLIP ViT-L/14 in the cross-modal role (#3 at
     S = 257, #1 on the captions), counted from zero; the Unicom encode's
     images/s by CUDA events, #3's and the GEMMs' device shares from a
     profiled batch, the batch's embeddings against the plain route; (c)
     `srm_scores` at CIRR's size (16,939 images x 28,225 triplets, K =
     1000) on seeded random features, timed, its peak memory, 256 rows
     against the CPU version on the host copy; (d) `cli.captioner --mllm
     stub`, `cli.get_cir_data --srm --i2i_rank` on (b)'s sims, and
     `train_main("clip", [... "--plus"])` on the triplets it writes
     (ViT-B/32 bf16, batch 256, #1, #2, #5, #6 counted); (e) that run
     through `python -m spn4cir_tpu_torch.cli.train ... --resume
     --ckpt_every_steps 2` in subprocesses: one uninterrupted with
     `--profile_dir`, one killed by SIGKILL after its first checkpoint and
     started again, their final trainable parameters compared (bitwise or
     max abs difference).
Phase 6 ends with 6b: `cli.validate_case` on the flagship checkpoint and on
random weights, then `cli.analysis_case` over the two dumps. Phase 8 also holds one float32 tgcir ViT-B/16 stage-2 loss through the
kernels against the plain versions, over a dense and an int8 bank. Phase
3d times #3 and #4 at zscir's stage-1 slice (1536, 257, 64) and tgcir's
extraction slice (3072, 197, 64) too.
Phase 3 ends with 3f: #11 at the 7B's decode shapes (B = 1, 8, 16 over
1,842 cache rows, B=16 over 1,241; float32, bf16 and int8 caches; a ragged
B=3, H=4, hd=8, L=37; since PR 14 also LLaVA's 547 rows at B=16) and #12
at the 7B's four weight shapes (x float32 and
bf16 at 1, 8, 16 rows; a ragged 5 x 40 x 77), timed beside their plain
versions, the library call and the bound, each record with its design, its
split plan and the blocks or clusters the card holds at once; #3, #4, #9
and #10 are timed per call and back to back too. Phase 11 prints each
decode step's device busy, #11's and #12's ms a step and the idle share.
Phases 9-13 run between
phases 7 and 8, phase 14 after 11, phases 15, 16 and 17 after 13. The last three lines are the kernels JSON, the card's name
and power limit (nvidia-smi), and {"ok": true, "device": {...}}.

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
import dataclasses
import importlib.util
import io
import json
import math
import os
import re
import shutil
import signal
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
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}

VISION = dict(name="vision", bh=256 * 12, s=50, d=64, causal=False)
TEXT = dict(name="text", bh=32 * 8, s=77, d=64, causal=True)
TRAIN_TEXT = dict(name="train-text", bh=256 * 8, s=77, d=64, causal=True)
# RN50x4's text tower has 10 heads: a training batch of 256 and the
# evaluation CLIs' query batch of 32
FLAGSHIP_TEXT = dict(name="flagship-text", bh=256 * 10, s=77, d=64, causal=True)
FLAGSHIP_EVAL_TEXT = dict(name="flagship-eval-text", bh=32 * 10, s=77, d=64,
                          causal=True)

# the edges of short_attention's tensor-core kernel (slices padded to 64, 80
# or 128 rows, one warp per 16; head dims padded to 64 or 128): every S x D
# below, causal and not, at a BH that is no multiple of anything, then BH
# past the blocks the card holds at once (each block walks several slices)
SHORT_EDGE_S = (1, 15, 16, 17, 50, 77, 128)
SHORT_EDGE_D = (8, 64, 72, 128)
SHORT_EDGE_BH = 5
SHORT_RAGGED = (dict(name="ragged-text", bh=1001, s=77, d=64, causal=True),
                dict(name="ragged-vision", bh=1001, s=50, d=64, causal=False),
                dict(name="one-slice", bh=1, s=77, d=64, causal=True))

# long attention: BLIP's ViT-B/16 at 384 (12 heads) at the extraction batch
# of 128 and the index / validation / stage-1 batch of 32; then ViT-L/14
# (16 heads, batch 32), EVA-g (head_dim 88, 16 heads, batch 16), ViT-B/16 at
# 224 (batch 32), a ragged slice, and the edges of the bf16 kernels' tiles
# (64 query rows or keys a block, 64 keys / 32 query rows a ring stage):
# S = 63 (one partial tile), 65 (a one-row query tile and a one-key key
# tile) and 129 (a one-key stage in both walks), one slice at S = 65
BLIP_EXTRACT = dict(name="blip-extract", bh=128 * 12, s=577, d=64, causal=False)
BLIP_INDEX = dict(name="blip-index", bh=32 * 12, s=577, d=64, causal=False)
# EVA ViT-g (16 heads of 88) at blip2's extraction / index batch of 32
EVA_EXTRACT = dict(name="eva-g-extract", bh=32 * 16, s=257, d=88, causal=False)
# zscir stage 1: ViT-L/14 at 224 over the 2B = 96 images of a batch of 48;
# tgcir's ViT-B/16 at 224 over an extraction batch of 256
ZS_STAGE1 = dict(name="zs-stage1", bh=96 * 16, s=257, d=64, causal=False)
TGCIR_EXTRACT = dict(name="tgcir-extract", bh=256 * 12, s=197, d=64,
                     causal=False)
# LLaVA's tower: CLIP ViT-L/14 at 224 (16 heads of 64) over a group of 16
LLAVA_TOWER = dict(name="llava-tower", bh=16 * 16, s=257, d=64, causal=False)
# Unicom ViT-L/14 (16 heads of 64, no class token: 256 tokens) over the SRM
# encode batch of 32; its attention runs in float32
UNICOM_ENCODE = dict(name="unicom-encode", bh=32 * 16, s=256, d=64,
                     causal=False)
LONG_TIMED = (BLIP_EXTRACT, BLIP_INDEX, EVA_EXTRACT, ZS_STAGE1, TGCIR_EXTRACT,
              LLAVA_TOWER, UNICOM_ENCODE)
LONG_SHAPES = (BLIP_EXTRACT, BLIP_INDEX, EVA_EXTRACT, ZS_STAGE1, TGCIR_EXTRACT,
               LLAVA_TOWER, UNICOM_ENCODE,
               dict(name="vit-l14", bh=32 * 16, s=257, d=64, causal=False),
               dict(name="eva-g", bh=16 * 16, s=257, d=88, causal=False),
               dict(name="vit-b16", bh=32 * 12, s=197, d=64, causal=False),
               dict(name="ragged", bh=5, s=130, d=40, causal=False),
               dict(name="edge-63", bh=3, s=63, d=64, causal=False),
               dict(name="edge-65", bh=1, s=65, d=64, causal=False),
               dict(name="edge-129", bh=2, s=129, d=88, causal=False))

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
RECIPE_WINDOWS = 3
RECIPE_STEPS = 10
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
# the LLaMA-2 7B rewriter (datagen): 32 CIRR pairs rewritten in 2 groups of
# 16, 50 new tokens each (49 decode steps), prompts prefilled in chunks of
# 128 positions; the CIRR few-shot prompt is 1,720-1,791 byte tokens, padded
# to 1,792, so the cache holds 1,842 rows (FIQ's prompts: 1,241)
REWRITE_PAIRS = 32
LLAMA_BATCH = 16
LLAMA_NEW = 50
LLAMA_CHUNK = 128
LLAMA_LEN_CIRR = 1842
LLAMA_LEN_FIQ = 1241
Q8_BATCHES = (1, 8, 16)
LLAMA_PROFILE_STEPS = 5
# tolerances of #11 and #12 against their plain versions (phase 3f):
# #11 float32: summation order; bf16: the plain version rounds the softmax
# weights to bf16 before the V product, the kernel rounds once at the
# output; int8 cache: float32 arithmetic on exact int8 values, the scales
# applied in another order (absolute and relative)
DECODE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.int8: 1e-4}
# #12: relative to the largest |output|: float32 sums over D in another
# order; bf16 x: one rounding of the output to bf16
QMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# the first decode step's logits at full depth in bf16, #11 against the
# plain route from the same cache: 32 layers, each attention output differs
# by a bf16 rounding (~2^-8 relative) between the routes and the residual
# stream carries it; against logits of std ~1.3 (random weights) the bound
# is 2^-3 absolute
LLAMA_BF16_LOGIT_TOL = 0.125
# phase 11d: where two float32 greedy streams part, the plain path's top-2
# margin at that step must be under the float32 tolerance (relative to the
# top logit, at least 1)
STREAM_MARGIN_TOL = 1e-5
# phase 14: LLaVA-v1-7B at full width (CLIP ViT-L/14 at 224, 23 of its 24
# blocks; LLaMA-7B) captions the 32 images of the rewrite tree in 2 groups of
# 16 with the default prompt: 227 byte ids + 256 patches = 483 prompt rows,
# 64 new tokens, so a 547-row cache. The two routes' bf16 logits differ by
# the roundings of 23 tower and 32 LM layers (0.143 at most over the first
# group's 64 steps, 0.122 at the prefill, in the first run on the H100):
# where the kernel and plain streams part, the plain margin must lie within
# twice the measured difference, and that difference within LLAVA_LOGIT_TOL
LLAVA_IMAGES = REWRITE_PAIRS
LLAVA_BATCH = 16
LLAVA_NEW = 64
LLAVA_PROMPT = "please briefly describe the image in 10 words"
LLAVA_PROMPT_IDS = 227
LLAVA_TOWER_LAYERS = 23
LLAVA_LEN = LLAVA_PROMPT_IDS + 256 + LLAVA_NEW
LLAVA_LOGIT_TOL = 0.25
# phase 15: BLIP caption base through cli.captioner (64 images, batch 32,
# beam 3) and cli.serve_mllm (16 concurrent requests)
BLIP_CAPTION_IMAGES = 64
BLIP_CAPTION_BATCH = 32
BLIP_SERVE_REQUESTS = 16
# phase 13: the negtype ablation on ViT-B/32 (the recipe's RN50x4 cut), and
# zscir stage 1 at full ViT-L/14 width on a tree of 192 generated triplets
# (4 steps at the recipe's batch of 48) over 256 images
NEGTYPE_MODEL = "ViT-B/32"
ZS_BATCH = 48
ZS_TRAIN = 192
ZS_IMAGES = 256
# phase 17, the scaling-positives datagen: dedup, the SRM matcher, resume.
# A 1,024-image tree with 1,024 train triplets, 32 planted duplicate pairs;
# the SRM encode at its batch of 32 (Unicom ViT-L/14 + CLIP ViT-L/14);
# srm_scores at CIRR's train size (16,939 images, 28,225 triplets), K =
# 1000, 768-wide random unit features, 256 rows checked on the host
SRM_IMAGES = 1024
SRM_TRAIN = 1024
SRM_PLANTED = 32
SRM_BATCH = 32
SRM_K = 1000
SRM_DIM = 768
CIRR_SRM_IMAGES = 16939
CIRR_SRM_TRIPLETS = 28225
SRM_CHECK_ROWS = 256
# unit Unicom embeddings (768) through #3 against the plain route, float32
# both: the attention differs in summation order only (1e-5 a layer)
SRM_EMBED_TOL = 1e-4
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


def device_ms(fn, n: int = 50) -> float:
    """Mean device time of `n` back-to-back calls: the stream is held by a
    sleep kernel while the host queues them, so no call waits for the
    host's wrapper work (which the per-call `median_ms` includes)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e7))  # ~10 ms of device clock
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


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
             "max_query_infonce", "decode_attention", "quant_matmul")
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
    for lib in libs:
        check_tensor_cores(cuda_build, lib)


# the tensor-core instantiations (`*_tc_kernel`) each library must hold:
# long_attention.cu's bf16 forward, dQ and dK/dV at the padded depths 64,
# 96, 128; short_attention.cu's bf16 forward and backward, each at the
# padded depths 64, 128 x 64, 80, 128 rows x causal or not; bank_infonce.cu's
# split-TF32 forward, coefficient and dQ kernels over float32, bf16 and int8
# banks; max_query_infonce.cu's split-TF32 forward over float32, bf16 and
# int8 banks; quant_matmul.cu's int8-weight product over float32 and bf16 x
# at one and two n8 tiles of rows
TC_KERNELS = {"long_attention": 9, "short_attention": 24, "bank_infonce": 9,
              "max_query_infonce": 3, "quant_matmul": 4}


def check_tensor_cores(cuda_build, lib) -> None:
    """The tensor-core kernels of `lib` (`*_tc_kernel`, as many as
    TC_KERNELS says) run on the tensor cores: each holds HMMA instructions
    (bf16 m16n8k16 and TF32 m16n8k8 alike) in `cuobjdump -sass` of the built
    library, and ptxas spilled nothing in any of them."""
    want = TC_KERNELS.get(lib.name.split("-")[0], 0)
    spills, entry = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line and entry:
            spills[entry] = "0 bytes spill stores, 0 bytes spill loads" in line
    cuobjdump = os.path.join(os.path.dirname(cuda_build.find_nvcc()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    hmma, fn = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            fn = found.group(1)
            hmma[fn] = 0
        elif fn and "HMMA" in line:
            hmma[fn] += 1
    tc = sorted(f for f in hmma if "_tc_kernel" in f)
    assert len(tc) == want, (lib.name, tc)
    for f in tc:
        name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "", f)[:56]
        assert hmma[f] > 0 and spills.get(f), (f, hmma[f], spills.get(f))
        phase(f"sass {name}: {hmma[f]} HMMA instructions, no spills")


def sdpa(q, k, v, causal):
    """The PyTorch library call for the same function (yardstick only)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q[None], k[None], v[None], is_causal=causal, scale=1.0)[0]


def short_rate(rec, shape, n_products: int = 2) -> None:
    """Achieved TFLOP/s of the counted products (2 forward, 5 backward) and
    the share of the bound, from the device time of back-to-back
    launches."""
    bh, s, d = shape["bh"], shape["s"], shape["d"]
    pairs = s * (s + 1) // 2 if shape["causal"] else s * s
    rec["tflops"] = n_products * 2 * pairs * d * bh / rec["device_ms"] / 1e9
    rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]


def check_attention_fwd(ak, device, card):
    """Phase 3a: short_attention against its plain version, per shape and
    dtype, timed at the main paths' shapes (per call, and as the device
    time of back-to-back launches, beside SDPA's two times); then, untimed,
    the edges of the bf16 tensor-core kernel (SHORT_EDGE_*) and BH past the
    resident blocks (SHORT_RAGGED), with two launches giving the same bits.
    Returns one record per comparison."""
    g = torch.Generator(device=device).manual_seed(0)
    records = []

    def compare(shape, dtype, tol):
        bh, s, d, causal = shape["bh"], shape["s"], shape["d"], shape["causal"]
        q, k, v = (torch.randn(bh, s, d, generator=g, device=device,
                               dtype=dtype) for _ in range(3))
        q = q * d ** -0.5
        with torch.inference_mode():
            got = ak.short_attention(q, k, v, causal)
            again = ak.short_attention(q, k, v, causal)
            torch.cuda.synchronize()
            assert torch.equal(got, again), "not repeatable"
            want = ak.short_attention_reference(q, k, v, causal)
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=tol, rtol=tol)
        err = (got.float() - want.float()).abs().max().item()
        b_ms, b_by = attention_bound(shape, dtype, 4, 2)
        rec = dict(shape=f"({bh}, {s}, {d})", tower=shape["name"],
                   causal=causal, dtype=dtype_name(dtype), rtol=tol, atol=tol,
                   route=ak.short_route(dtype, d, True),
                   max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
        records.append(rec)
        return rec, (q, k, v)

    for shape in (VISION, TEXT, TRAIN_TEXT, FLAGSHIP_TEXT,
                  FLAGSHIP_EVAL_TEXT):
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            rec, (q, k, v) = compare(shape, dtype, tol)
            causal = shape["causal"]
            with torch.inference_mode():
                rec["ms"] = median_ms(
                    lambda: ak.short_attention(q, k, v, causal))
                rec["plain_ms"] = median_ms(
                    lambda: ak.short_attention_reference(q, k, v, causal))
                rec["library_ms"] = median_ms(lambda: sdpa(q, k, v, causal))
                rec["device_ms"] = device_ms(
                    lambda: ak.short_attention(q, k, v, causal))
                rec["library_device_ms"] = device_ms(
                    lambda: sdpa(q, k, v, causal))
            short_rate(rec, shape)
            phase(f"kernel short_attention {rec['tower']} {rec['shape']} "
                  f"causal={causal} {rec['dtype']} ({rec['route']}): "
                  f"max_abs_err={rec['max_abs_err']:.3e} (atol=rtol={tol}), "
                  f"repeatable; kernel {rec['ms']:.4f} ms a call, "
                  f"{rec['device_ms']:.4f} ms of device time back to back "
                  f"({rec['tflops']:.1f} TFLOP/s, "
                  f"{100 * rec['bound_share']:.1f}% of the bound), plain "
                  f"{rec['plain_ms']:.4f} ms, library (SDPA) "
                  f"{rec['library_ms']:.4f} ms a call, "
                  f"{rec['library_device_ms']:.4f} back to back, bound "
                  f"{rec['bound_ms']:.5f} ms by {rec['bound_by']} [{card}]")
    worst = {}
    for s in SHORT_EDGE_S:
        for d in SHORT_EDGE_D:
            for causal in (False, True):
                for dtype, tol in ((torch.bfloat16, BF16_TOL),
                                   (torch.float32, F32_TOL)):
                    edge = dict(name=f"edge-s{s}-d{d}", bh=SHORT_EDGE_BH,
                                s=s, d=d, causal=causal)
                    rec, _ = compare(edge, dtype, tol)
                    worst[rec["dtype"]] = max(worst.get(rec["dtype"], 0.0),
                                              rec["max_abs_err"])
    for shape in SHORT_RAGGED:
        for dtype, tol in ((torch.bfloat16, BF16_TOL),
                           (torch.float32, F32_TOL)):
            rec, _ = compare(shape, dtype, tol)
            worst[rec["dtype"]] = max(worst[rec["dtype"]], rec["max_abs_err"])
    ragged = ", ".join(f"{r['name']} {(r['bh'], r['s'], r['d'])}"
                       for r in SHORT_RAGGED)
    phase(f"kernel short_attention edges: S in {SHORT_EDGE_S} x D in "
          f"{SHORT_EDGE_D} x causal or not at BH={SHORT_EDGE_BH}, and "
          f"{ragged}: all within tolerance and repeatable, max_abs_err bf16 "
          f"{worst['bfloat16']:.3e}, float32 {worst['float32']:.3e} [{card}]")
    return records


def check_attention_bwd(ak, device, card):
    """Phase 3b: short_attention_bwd against the plain backward and against
    float32 autograd through the plain forward, two launches giving the same
    bits; timed at the main paths' shapes (per call, and as the device time
    of back-to-back launches, beside SDPA's backward read both ways); then,
    untimed, the edges of the bf16 tensor-core kernel (SHORT_EDGE_*) and BH
    past the resident blocks (SHORT_RAGGED). Returns one record per
    comparison."""
    g = torch.Generator(device=device).manual_seed(1)
    records = []

    def compare(shape, dtype, tol):
        bh, s, d, causal = shape["bh"], shape["s"], shape["d"], shape["causal"]
        q, k, v, do = (torch.randn(bh, s, d, generator=g, device=device,
                                   dtype=dtype) for _ in range(4))
        q = q * d ** -0.5
        got = ak.short_attention_bwd(q, k, v, do, causal)
        again = ak.short_attention_bwd(q, k, v, do, causal)
        torch.cuda.synchronize()
        want = ak.short_attention_bwd_reference(q, k, v, do, causal)
        # autograd through the plain forward, in float32 on the same
        # values: in bf16 it would round dP = dO·vᵀ (values up to ~40) to
        # bf16 on the way back, which alone moves 2 of 12.6 million
        # elements of the 10-head shape by 0.067
        exact = [t.to(torch.float32, copy=True).requires_grad_()
                 for t in (q, k, v)]
        auto = torch.autograd.grad(
            ak.short_attention_reference(*exact, causal), exact, do.float())
        del exact
        err = 0.0
        for a, a2, b, c in zip(got, again, want, auto):
            assert torch.equal(a, a2), "not repeatable"
            torch.testing.assert_close(a.float(), b.float(), atol=tol,
                                       rtol=tol)
            torch.testing.assert_close(a.float(), c.float(), atol=tol,
                                       rtol=tol)
            err = max(err, (a.float() - b.float()).abs().max().item())
        b_ms, b_by = attention_bound(shape, dtype, 7, 5)
        rec = dict(shape=f"({bh}, {s}, {d})", tower=shape["name"],
                   causal=causal, dtype=dtype_name(dtype), rtol=tol, atol=tol,
                   route=ak.short_route(dtype, d, True), max_abs_err=err,
                   bound_ms=b_ms, bound_by=b_by)
        records.append(rec)
        return rec, (q, k, v, do)

    for shape in (TRAIN_TEXT, VISION, FLAGSHIP_TEXT):
        for dtype, tol in ((torch.bfloat16, BWD_BF16_TOL),
                           (torch.float32, BWD_F32_TOL)):
            rec, (q, k, v, do) = compare(shape, dtype, tol)
            causal = shape["causal"]
            rec["ms"] = median_ms(
                lambda: ak.short_attention_bwd(q, k, v, do, causal))
            rec["device_ms"] = device_ms(
                lambda: ak.short_attention_bwd(q, k, v, do, causal))
            rec["plain_ms"] = median_ms(
                lambda: ak.short_attention_bwd_reference(q, k, v, do, causal))
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            lib_out = sdpa(*leaves, causal)
            rec["library_ms"] = median_ms(lambda: torch.autograd.grad(
                lib_out, leaves, do, retain_graph=True))
            rec["library_device_ms"] = device_ms(lambda: torch.autograd.grad(
                lib_out, leaves, do, retain_graph=True))
            del leaves, lib_out
            short_rate(rec, shape, 5)
            phase(f"kernel short_attention_bwd {rec['tower']} {rec['shape']} "
                  f"causal={causal} {rec['dtype']} ({rec['route']}): "
                  f"max_abs_err={rec['max_abs_err']:.3e} vs plain backward, "
                  f"also within atol=rtol={tol} of float32 autograd through "
                  f"the plain forward, repeatable; kernel {rec['ms']:.4f} ms "
                  f"a call, {rec['device_ms']:.4f} ms of device time back to "
                  f"back ({rec['tflops']:.1f} TFLOP/s, "
                  f"{100 * rec['bound_share']:.1f}% of the bound), plain "
                  f"{rec['plain_ms']:.4f} ms, library (SDPA backward) "
                  f"{rec['library_ms']:.4f} ms a call, "
                  f"{rec['library_device_ms']:.4f} back to back, bound "
                  f"{rec['bound_ms']:.5f} ms by {rec['bound_by']} [{card}]")
    worst = {}
    edges = [dict(name=f"edge-s{s}-d{d}", bh=SHORT_EDGE_BH, s=s, d=d,
                  causal=causal)
             for s in SHORT_EDGE_S for d in SHORT_EDGE_D
             for causal in (False, True)]
    for shape in edges + list(SHORT_RAGGED):
        for dtype, tol in ((torch.bfloat16, BWD_BF16_TOL),
                           (torch.float32, BWD_F32_TOL)):
            rec, _ = compare(shape, dtype, tol)
            worst[rec["dtype"]] = max(worst.get(rec["dtype"], 0.0),
                                      rec["max_abs_err"])
    ragged = ", ".join(f"{r['name']} {(r['bh'], r['s'], r['d'])}"
                       for r in SHORT_RAGGED)
    phase(f"kernel short_attention_bwd edges: S in {SHORT_EDGE_S} x D in "
          f"{SHORT_EDGE_D} x causal or not at BH={SHORT_EDGE_BH}, and "
          f"{ragged}: all within tolerance of the plain backward and of "
          f"float32 autograd, repeatable, max_abs_err bf16 "
          f"{worst['bfloat16']:.3e}, float32 {worst['float32']:.3e} [{card}]")
    return records


def check_long_attention(ak, device, card):
    """Phase 3d: long_attention and long_attention_bwd against their plain
    versions (the backward also against float32 autograd through the plain
    forward), per shape and dtype; two launches must give the same bits;
    timed at the two blip shapes, EVA-g's extraction slice, zscir's stage-1
    slice and tgcir's extraction slice. Returns
    (forward, backward) records."""
    g = torch.Generator(device=device).manual_seed(11)
    fwd_records, bwd_records = [], []
    for shape in LONG_SHAPES:
        timed = shape in LONG_TIMED
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
                    frec["device_ms"] = device_ms(
                        lambda: ak.long_attention_fwd(q, k, v), n=20)
                    frec["library_device_ms"] = device_ms(
                        lambda: sdpa(q, k, v, False), n=20)
                    brec["device_ms"] = device_ms(lambda: ak.long_attention_bwd(
                        q, k, v, do, got, lse), n=20)
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                lib_out = sdpa(*leaves, False)
                brec["library_ms"] = median_ms(lambda: torch.autograd.grad(
                    lib_out, leaves, do, retain_graph=True), reps=10)
                brec["library_device_ms"] = device_ms(
                    lambda: torch.autograd.grad(lib_out, leaves, do,
                                                retain_graph=True), n=20)
                del leaves, lib_out
                # achieved rate of the counted products, share of the bound
                for r, n_products in ((frec, 2), (brec, 5)):
                    r["tflops"] = (n_products * 2 * bh * s * s * d
                                   / r["device_ms"] / 1e9)
                    r["bound_share"] = r["bound_ms"] / r["device_ms"]
                times = [f"kernel {r['ms']:.4f} ms a call, "
                         f"{r['device_ms']:.4f} ms of device time back to "
                         f"back ({r['tflops']:.1f} TFLOP/s, "
                         f"{100 * r['bound_share']:.1f}% of the bound), plain "
                         f"{r['plain_ms']:.4f} ms, library (SDPA{w}) "
                         f"{r['library_ms']:.4f} ms a call, "
                         f"{r['library_device_ms']:.4f} back to back, "
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
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    # bytes: the query, the bank, the labels and the statistics, each once;
    # the forward's route from its plan: from D = 256 on split TF32 on the
    # tensor cores, 3 products of 2·B·M·D (2 over a bf16 bank or int8
    # values) at the TF32 peak, below float32 FMAs at the float32 peak (the
    # bound the CUDA-core design was held to, printed beside the other)
    fwd_tc = bk.fwd_plan(b, m, d, sms).tc_logits
    n_split = 3 if bank.dtype == torch.float32 else 2
    fwd_bytes = b * d * 4 + f["bank_bytes"] + b * 4 + 4 * b * 4 + 8
    f_fma_ms, f_fma_by = bound_ms(fwd_bytes, 2 * b * m * d, torch.float32)
    f_ms, f_by = (bound_ms(fwd_bytes, n_split * 2 * b * m * d, "tf32")
                  if fwd_tc else (f_fma_ms, f_fma_by))
    bwd_bytes = 2 * b * d * 4 + f["bank_bytes"] + b * 4 + 2 * b * 4 + 4
    # the function's 4·B·M·D in float32 FMAs: the bound the CUDA-core
    # design's readings were held to, printed beside
    fma_ms, fma_by = bound_ms(bwd_bytes, 4 * b * m * d, torch.float32)
    # the split-TF32 route, every bank: 3 products each of 2·B·M·D (2 over
    # a bf16 bank or int8 values, exact in TF32) in the dQ kernel and, from
    # D = 256 on, in the coefficient kernel (below, float32 FMAs), and the
    # coefficient scratch written and read once; the two kernels' least
    # times add
    plan = bk.bwd_plan(b, m, d, sms)
    coef_bytes = 2 * 4 * plan.coef_shape[0] * plan.coef_shape[1]
    tc_ops = n_split * 2 * b * m * d * (2 if plan.tc_logits else 1)
    fma_ops = 0 if plan.tc_logits else 2 * b * m * d
    t_ops = (tc_ops / PEAK_FLOPS["tf32"]
             + fma_ops / PEAK_FLOPS[torch.float32]) * 1e3
    t_bytes = (bwd_bytes + coef_bytes) / HBM_BYTES_S * 1e3
    b_ms, b_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    route = "tensor_cores" if plan.tc_logits else "cuda_cores+tensor_cores"
    fwd = dict(common, rtol=BANK_RTOL, atol=BANK_RTOL, max_abs_err=fwd_err,
               max_err_over_tol=fwd_share, bound_ms=f_ms, bound_by=f_by,
               fma_bound_ms=f_fma_ms,
               route="tensor_cores" if fwd_tc else "cuda_cores")
    bwd = dict(common, rtol=BANK_RTOL, atol=BANK_DQ_ATOL, max_abs_err=bwd_err,
               max_err_over_tol=bwd_share, bound_ms=b_ms, bound_by=b_by,
               fma_bound_ms=fma_ms, route=route)
    if time_it:
        ce = torch.nn.functional.cross_entropy
        fwd["ms"] = median_ms(lambda: f["fwd"](q, bank, labels, TAU))
        fwd["device_ms"] = device_ms(lambda: f["fwd"](q, bank, labels, TAU),
                                     n=20)
        fwd["plain_ms"] = median_ms(
            lambda: f["stats_ref"](q, bank, labels, TAU))
        fwd["library_ms"] = median_ms(
            lambda: ce(q @ f["dense"]().T / TAU, labels))
        fwd["library_device_ms"] = device_ms(
            lambda: ce(q @ f["dense"]().T / TAU, labels), n=20)
        bwd["ms"] = median_ms(lambda: f["bwd"](
            q, bank, labels, TAU, stats[0], stats[1], gout))
        bwd["device_ms"] = device_ms(lambda: f["bwd"](
            q, bank, labels, TAU, stats[0], stats[1], gout), n=20)
        bwd["plain_ms"] = median_ms(lambda: f["bwd_ref"](
            q, bank, labels, TAU, want[0], want[1], gout))
        leaf = q.clone().requires_grad_()
        lib_loss = ce(leaf @ f["dense"]().T / TAU, labels)
        bwd["library_ms"] = median_ms(lambda: torch.autograd.grad(
            lib_loss, leaf, retain_graph=True))
        bwd["library_device_ms"] = device_ms(lambda: torch.autograd.grad(
            lib_loss, leaf, retain_graph=True), n=20)
        # the function's operations (2·B·M·D forward, 4·B·M·D backward) a
        # second of device time, and the share of the bound
        for rec, n_ops in ((fwd, 2 * b * m * d), (bwd, 4 * b * m * d)):
            rec["tflops"] = n_ops / rec["device_ms"] / 1e9
            rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
    for name, rec in zip(f["names"], (fwd, bwd)):
        times = (f"kernel {rec['ms']:.4f} ms a call, "
                 f"{rec['device_ms']:.4f} ms of device time back to back "
                 f"({rec['tflops']:.1f} TFLOP/s of the function's operations, "
                 f"{100 * rec['bound_share']:.1f}% of the bound), plain "
                 f"{rec['plain_ms']:.4f} ms, "
                 f"library ({f['library']}"
                 f"{' backward' if name.endswith('bwd') else ''}) "
                 f"{rec['library_ms']:.4f} ms a call, "
                 f"{rec['library_device_ms']:.4f} back to back, "
                 if time_it else "")
        fma = (f" (float32-FMA bound {rec['fma_bound_ms']:.5f} ms)"
               if rec["route"] != "cuda_cores" else "")
        phase(f"kernel {name} {rec['shape']} bank {rec['dtype']} "
              f"({rec['route']}): max_abs_err={rec['max_abs_err']:.3e}, "
              f"{rec['max_err_over_tol']:.3f} of the tolerance "
              f"(atol={rec['atol']} + rtol={rec['rtol']}·|plain|), "
              f"repeatable; {times}bound {rec['bound_ms']:.5f} ms by "
              f"{rec['bound_by']}{fma} [{card}]")
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
    # row and bank counts that are no multiple of a tile, and a shallow bank
    # (D = 240: the forward's and the backward's logits on the CUDA cores);
    # the scales of the int8 bank are a view into a buffer whose tail is NaN
    for b, m, d in ((5, 2049, BANK_DIM), (5, 2049, FLAGSHIP_DIM),
                    (70, 4001, 768), (33, 1000, 240)):
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


def drive_queries(port, names, n_rounds):
    """`n_rounds` rounds of N_CONCURRENT concurrent /retrieve requests, then
    N_SEQUENTIAL one at a time, each result checked; returns (per-round
    client ms, sequential client ms)."""
    import numpy as np

    name_set = set(names)
    rng = np.random.RandomState(0)
    rounds = []
    for _ in range(n_rounds):
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
    return rounds, sequential


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
        rounds, sequential = drive_queries(port, names, 2)
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
    from spn4cir_tpu_torch.ops import decode_attn as da
    from spn4cir_tpu_torch.ops import maxquery_kernels as mk
    from spn4cir_tpu_torch.ops import quant_matmul as qm

    return dict(short_attention=ak.short_attention,
                short_attention_bwd=ak.short_attention_bwd,
                long_attention=ak.long_attention,
                long_attention_bwd=ak.long_attention_bwd,
                bank_infonce_fwd=bk.bank_infonce_fwd,
                bank_infonce_bwd=bk.bank_infonce_bwd,
                bank_infonce_q8_fwd=bk.bank_infonce_q8_fwd,
                bank_infonce_q8_bwd=bk.bank_infonce_q8_bwd,
                max_query_infonce_fwd=mk.max_query_infonce_fwd,
                max_query_infonce_bwd=mk.max_query_infonce_bwd,
                decode_attention=da.decode_attention,
                quant_matmul=qm.quant_matmul)


def zero_counts(ak, bk):
    count = counters(ak, bk)
    for fn in count.values():
        fn.launches = 0
    return count


def read_counts(count):
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in count.items()}


def bank_launches(quant: bool, steps: int, max_query: bool = False) -> dict:
    """The launches of every kernel but attention in `steps` optimizer steps
    of a retrieval path: one forward and one backward of the bank pair that
    takes the bank (the max-over-query pair for blip2's (M, 32, 256) bank,
    of either type), none of the other bank kernels, and none of the LLaMA
    decoders' (#11, #12)."""
    dense, q8, mq = ((0, 0, steps) if max_query else
                     (0, steps, 0) if quant else (steps, 0, 0))
    return dict(bank_infonce_fwd=dense, bank_infonce_bwd=dense,
                bank_infonce_q8_fwd=q8, bank_infonce_q8_bwd=q8,
                max_query_infonce_fwd=mq, max_query_infonce_bwd=mq,
                **NO_LLAMA)


# the retrieval paths never reach the LLaMA decoders' kernels, and the LLaMA
# paths reach none of the retrieval ones
NO_LLAMA = dict(decode_attention=0, quant_matmul=0)
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
        elif "decode_attention" in name:
            key = "decode attention (#11)"
        elif "quant_matmul" in name:
            key = "int8 matmul (#12)"
        elif any(w in low for w in ("gemm", "cutlass", "xmma", "cublas", "nvjet")):
            key = "GEMMs"
        elif "layer_norm" in low or "layernorm" in low:
            key = "LayerNorm"
        elif "reduce" in low:
            key = "reductions (RMSNorm variance, sampling)"
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


def drive_training_recipe(ak, bk, tmp, card, model, bank_dtypes,
                          kind="clip"):
    """Phase 7 (clip) and 12c (tgcir): `train_epoch` of the `kind` backbone
    at `model` against the recipe's bank size, batch 256, the refer bank
    (its rows of the backbone's `bank_spec`) on the host. First the host
    gather and the host-to-device copy of one batch's refer rows alone;
    then, once per bank type of `bank_dtypes`, ms/step over RECIPE_WINDOWS
    timed windows of RECIPE_STEPS steps (the median and the spread across
    the windows) and a profiler window whose trace gives the device time
    of each kernel group within the step."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from spn4cir_tpu_torch.bank.bank import Bank
    from spn4cir_tpu_torch.models.api import build_backbone
    from spn4cir_tpu_torch.train.stage2 import create_train_state, train_epoch

    device = torch.device("cuda:0")
    backbone = build_backbone(kind, clip_model_name=model, tau=TAU,
                              dtype=torch.bfloat16, device=device)
    backbone.init_params(torch.Generator().manual_seed(0))
    spec = backbone.bank_spec()
    dim, = spec.target_shape
    g = torch.Generator(device=device).manual_seed(4)
    target32 = unit_rows(RECIPE_BANK, dim, g, device)
    # 64 distinct refer rows tiled to the full bank: what a gather costs
    # does not depend on the values
    block = torch.randn(64, *spec.refer_shape, generator=g,
                        device=device).cpu().numpy()
    refer = np.tile(block, (RECIPE_BANK // 64,) + (1,) * len(spec.refer_shape))
    state = create_train_state(backbone, 2e-5)
    layers_n = backbone.cfg.transformer_layers
    label = f"{kind} {model}"

    def batches(n, seed):
        return synthetic_batches(n, TRAIN_BATCH, RECIPE_BANK, seed)

    def profiled(bank, n_steps, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            train_epoch(backbone, state, bank, batches(n_steps, seed),
                        log_every=0)
            torch.cuda.synchronize()
        return prof, (time.perf_counter() - t0) * 1e3

    # the two host stages of one batch's refer rows, alone
    bank = Bank(refer=refer, target=target32)
    gather, copy = [], []
    for raw in batches(5, 5):
        t0 = time.perf_counter()
        rows = bank.gather_refer(raw)
        t1 = time.perf_counter()
        dev_rows = torch.from_numpy(rows).to(device)
        torch.cuda.synchronize()
        copy.append((time.perf_counter() - t1) * 1e3)
        gather.append((t1 - t0) * 1e3)
    results = dict(host_gather_ms=statistics.median(gather),
                   host_to_device_copy_ms=statistics.median(copy),
                   refer_batch_mb=rows.nbytes / 1e6,
                   refer_bank_gb=refer.nbytes / 1e9)
    del dev_rows, rows
    phase(f"recipe scale, {label}: one batch's refer rows "
          f"({results['refer_batch_mb']:.1f} MB of a "
          f"{results['refer_bank_gb']:.2f} GB host bank): host gather "
          f"{results['host_gather_ms']:.3f} ms, host-to-device copy "
          f"{results['host_to_device_copy_ms']:.3f} ms [{card}]")

    for name in bank_dtypes:
        quant = name == "int8"
        bank = Bank(refer=refer, target=bk.quantize_bank(target32) if quant
                    else target32.to(getattr(torch, name)))
        backbone.train()
        train_epoch(backbone, state, bank, batches(3, 6),
                    log_every=0)                                # warm-up
        count = zero_counts(ak, bk)
        windows, walls, losses = [], [], []
        for w in range(RECIPE_WINDOWS):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            _, mean_loss = train_epoch(backbone, state, bank,
                                       batches(RECIPE_STEPS, 7 + 100 * w),
                                       log_every=0)
            end.record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / RECIPE_STEPS)
            windows.append(start.elapsed_time(end) / RECIPE_STEPS)
            losses.append(mean_loss)
        n_steps = RECIPE_WINDOWS * RECIPE_STEPS
        launches = read_counts(count)
        assert launches == dict(
            short_attention=layers_n * n_steps,
            short_attention_bwd=layers_n * n_steps,
            **NO_LONG, **bank_launches(quant, n_steps)), launches
        assert all(math.isfinite(x) for x in losses), losses
        event_ms = statistics.median(windows)
        wall_ms = statistics.median(walls)
        phase(f"recipe scale, M={RECIPE_BANK} x {dim} {name} bank, refer "
              f"rows {spec.refer_shape}, batch {TRAIN_BATCH}, {label} bf16, "
              f"{RECIPE_WINDOWS} windows of {RECIPE_STEPS} steps: median "
              f"{event_ms:.3f} ms/step (CUDA events; windows "
              f"{[round(x, 3) for x in windows]}, max / min "
              f"{max(windows) / min(windows):.3f}; host clock median "
              f"{wall_ms:.3f}); mean losses {[round(x, 4) for x in losses]} "
              f"[{card}]")

        # a profiler window over further steady steps; a first one-step
        # window takes the profiler's start-up cost and is dropped
        profiled(bank, 1, 8)
        prof, window_ms = profiled(bank, PROFILE_STEPS, 9)
        trace = os.path.join(tmp, f"train_trace_{kind}_{dim}_{name}.json")
        prof.export_chrome_trace(trace)
        busy_ms, n_ops, groups = device_busy(trace)
        assert n_ops > 0, "the profiler's trace holds no device interval"
        per = {k: v / PROFILE_STEPS for k, v in
               sorted(groups.items(), key=lambda kv: -kv[1])}
        bank_ms, attn_ms = per["bank kernels"], per["attention kernels"]
        assert bank_ms > 0 and attn_ms > 0, per
        busy_step = busy_ms / PROFILE_STEPS
        results[name] = dict(
            ms_per_step=event_ms, ms_per_step_windows=windows,
            wall_ms_per_step=wall_ms, wall_ms_per_step_windows=walls,
            mean_losses=losses, profile_steps=PROFILE_STEPS,
            window_ms_per_step=window_ms / PROFILE_STEPS,
            busy_ms_per_step=busy_step,
            idle_share_in_window=1 - busy_ms / window_ms,
            idle_share_of_unprofiled_step=1 - busy_step / event_ms,
            device_ops_per_step=n_ops / PROFILE_STEPS,
            ms_per_step_by_group=per)
        phase(f"profile, {label}, {PROFILE_STEPS} steps at M={RECIPE_BANK} "
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
    phase(f"recipe scale stats {label} " + json.dumps(results))


def bf16_argv(root, *extra):
    """An entry point's argv on a CIRR tree, bf16 towers, seed 0, the
    backbone's recipe for the rest; cuda:0 is the default device."""
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


def plain_rescore(name, ak, layers, service, root):
    """The first 8 gallery images of `service`'s index again, their
    references re-encoded through the plain attention: the scores of the
    two routes differ by no more than BLIP_SCORE_NOISE, and each query keeps
    its top-1 unless its two best were closer than twice that fixed
    limit."""
    from spn4cir_tpu_torch.data.datasets import CIRDataset, iter_gallery

    backbone, index = service.backbone, service.index
    target, n_images = index.target, len(index.names)
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


def drive_blip_serving(ak, bk, layers, root, card, spec=BLIP_SERVING):
    """Phases 9a and 10b: the serving CLI over blip4cir or blip24cir (`spec`),
    then the checks. Returns the launch counts of the run."""
    import numpy as np

    from spn4cir_tpu_torch.cli.serve import serve_main

    name, n_images = spec["name"], spec["n_images"]
    argv = bf16_argv(root, "--batch-size", str(SERVE_BATCH), "--serve_batch",
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
        (concurrent_ms,), sequential = drive_queries(port, names, 1)
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

    plain_rescore(name, ak, layers, service, root)

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


def fresh_sides(common, argv, name="blip"):
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
    argv = bf16_argv(root, "--batch-size", str(BLIP_BATCH), "--num-epochs",
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

    args, fresh = fresh_sides(common, argv)
    assert args.tau == BLIP_TAU and args.clip_model_name == "RN50x4"
    ckpt = os.path.join(out, "best.pt")
    _, trained = fresh_sides(common, argv)
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
    eval_argv = bf16_argv(root, "--model_path", ckpt)
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
        argv = bf16_argv(root, "--batch-size", str(BLIP_S1_BATCH),
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
    args, fresh = fresh_sides(common, argv)
    _, trained = fresh_sides(common, argv)
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
        prof = batch_profile(lambda: backbone.bank_features(images),
                             "blip_extract")
    phase(f"BLIP base bf16 bank extraction at 384: "
          f"{BLIP_BATCH / (ms / 1e3):.1f} images/s on the device (batch "
          f"{BLIP_BATCH}, {ms:.3f} ms/batch; 12 long-attention launches at "
          f"its shape take {attn_ms:.1f} ms alone, "
          f"{100 * attn_ms / ms:.0f}% of the batch; "
          f"{extraction_line(*prof, ms)}) [{card}]")


def batch_profile(fn, name):
    """(device busy ms, device operations, ms by kernel group) of one call
    of `fn` in a profiler window, after a first window that takes the
    profiler's start-up."""
    from torch.profiler import ProfilerActivity, profile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_prof_")
    try:
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        trace = os.path.join(tmp, f"{name}_trace.json")
        prof.export_chrome_trace(trace)
        busy_ms, n_ops, groups = device_busy(trace)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert n_ops > 0, "the profiler's trace holds no device interval"
    return busy_ms, n_ops, groups


def extraction_line(busy_ms, n_ops, groups, ms) -> str:
    return (f"device busy {busy_ms:.3f} ms in {n_ops} operations under the "
            f"profiler, idle {100 * (1 - busy_ms / ms):.1f}% of the batch "
            f"timed without it; the long-attention launches "
            f"{groups.get('attention kernels', 0.0):.3f} ms of it, GEMMs "
            f"{groups.get('GEMMs', 0.0):.3f}, elementwise and other "
            f"{groups.get('elementwise and other', 0.0):.3f}")


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


CLIP_PROBE = ("text_projection", "transformer.resblocks.0.attn.in_proj_weight",
              "transformer.resblocks.11.mlp.c_fc.weight",
              "token_embedding.weight")
TGCIR_PROBE = ("clip.text_projection",
               "clip.transformer.resblocks.0.attn.in_proj_weight",
               "text_fc.weight", "tokenlearn_text.attn.weight",
               "masks_text.weight", "s_remain.fc1.weight")


def check_plain_step(layers, bk, card, kind="clip", model="ViT-B/32",
                     probe=CLIP_PROBE, seed=9):
    """Phase 8: one float32 stage-2 loss of the `kind` backbone and its
    gradients through the kernels and through the plain versions, same
    weights and batch, over a dense bank and over the same bank quantized
    to int8; `probe` names the parameters whose gradients are held."""
    from spn4cir_tpu_torch.models.api import build_backbone
    from spn4cir_tpu_torch.train.stage2 import create_train_state

    device = torch.device("cuda:0")
    backbone = build_backbone(kind, clip_model_name=model, tau=TAU,
                              dtype=torch.float32, device=device)
    backbone.init_params(torch.Generator().manual_seed(0))
    create_train_state(backbone, 2e-5)      # freezes what stage 2 freezes
    spec = backbone.bank_spec()
    g = torch.Generator(device=device).manual_seed(seed)
    m, b = 4099, 64
    bank = unit_rows(m, spec.target_shape[0], g, device)
    refer = torch.randn(b, *spec.refer_shape, generator=g, device=device)
    labels = torch.randint(0, m, (b,), generator=g, device=device)
    raw = next(synthetic_batches(1, b, m, seed + 1))
    text_ids = torch.from_numpy(backbone.tokenize(raw["captions"])).to(device)

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
        phase(f"one float32 {kind} {model} stage-2 loss (B={b}, M={m}, "
              f"{dtype_name(target.dtype)} bank): kernels {kern_loss:.6f}, "
              f"plain versions {plain_loss:.6f} (rtol {STEP_TOL}); relative "
              f"gradient difference of {probe}: {[f'{r:.2e}' for r in rel]} "
              f"(each under {10 * STEP_TOL}) [{card}]")
        assert abs(kern_loss - plain_loss) <= STEP_TOL * abs(plain_loss)
        assert all(r < 10 * STEP_TOL for r in rel), rel
        assert math.isfinite(kern_loss)


def launched_kernels(fn) -> list:
    """The names of the CUDA kernels that `fn` launches, in order, from a
    profiler trace."""
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return [ev["name"] for ev in sorted(
        (ev for ev in events
         if ev.get("ph") == "X" and ev.get("cat") == "kernel"),
        key=lambda ev: ev["ts"])]


def max_query_case(mk, bk, q, bank, labels, card, time_it=True):
    """#9 and #10 against their plain versions on one case (a dense
    (M, Q, D) bank or a 3-D QuantBank): the four statistics, the loss, dtau,
    the residuals (logits, and each routed query a maximum of the plain
    sims within the tolerance) and dfeats, against the plain backward from
    the kernel's residuals and against the one that recomputes the sims; a
    second launch gives the same bits. Timed, the forward runs on the
    tensor cores (`mq_fwd_tc_kernel`) and the backward only reads the
    residuals (`mq_routed_bwd_kernel`, no forward kernel), by the profiler's
    kernel names. Returns (fwd, bwd) records."""
    b, d = q.shape
    quant = isinstance(bank, bk.QuantBank)
    rows = bank.values if quant else bank
    m, nq = rows.shape[:2]
    gout = torch.tensor(1.0, device=q.device)
    loss, stats, dtau, res = mk.max_query_infonce_fwd(q, bank, labels,
                                                      BLIP2_TAU, routing=True)
    dq = mk.max_query_infonce_bwd(bank, labels, BLIP2_TAU, stats[0],
                                  stats[1], gout, res)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = mk.max_query_infonce_stats_reference(q, bank, labels, BLIP2_TAU)
        want_loss = mk.max_query_infonce_reference(q, bank, labels, BLIP2_TAU)
        want_dq = mk.max_query_infonce_bwd_reference(
            q, bank, labels, BLIP2_TAU, want[0], want[1], gout)
        routed_dq = mk.max_query_infonce_routed_bwd_reference(
            bank, labels, BLIP2_TAU, stats[0], stats[1], gout, res)
        sims = mk._sims(q, bank)
        want_l, want_r = mk.max_query_infonce_residuals_reference(
            q, bank, BLIP2_TAU)
        # the plain logit at the kernel's routed query: a maximum within the
        # logits' tolerance wherever the two routes part (a near-tie)
        at_route = sims.gather(-1, res[1].long()[..., None])[..., 0] / BLIP2_TAU
        flips = int((res[1] != want_r).sum())
        del sims
    for got_s, want_s in zip(stats, want):
        torch.testing.assert_close(got_s, want_s, atol=BANK_RTOL,
                                   rtol=BANK_RTOL)
    torch.testing.assert_close(loss, want_loss, atol=BANK_RTOL, rtol=BANK_RTOL)
    torch.testing.assert_close(dtau, bk.dtau_from_stats(want, BLIP2_TAU),
                               atol=10 * BANK_RTOL, rtol=BANK_RTOL)
    torch.testing.assert_close(res[0], want_l, atol=BANK_RTOL, rtol=BANK_RTOL)
    torch.testing.assert_close(at_route, want_l, atol=BANK_RTOL,
                               rtol=BANK_RTOL)
    torch.testing.assert_close(dq, want_dq, atol=BANK_DQ_ATOL, rtol=BANK_RTOL)
    torch.testing.assert_close(dq, routed_dq, atol=BANK_DQ_ATOL,
                               rtol=BANK_RTOL)
    loss2, _, _, res2 = mk.max_query_infonce_fwd(q, bank, labels, BLIP2_TAU,
                                                 routing=True)
    dq2 = mk.max_query_infonce_bwd(bank, labels, BLIP2_TAU, stats[0],
                                   stats[1], gout, res)
    assert torch.equal(loss, loss2) and torch.equal(dq, dq2) and all(
        torch.equal(a, b_) for a, b_ in zip(res, res2)), "not repeatable"
    if time_it:  # the timed cases, before any other phase's profiler
        names = launched_kernels(lambda: mk.max_query_infonce_fwd(
            q, bank, labels, BLIP2_TAU, routing=True))
        assert any("mq_fwd_tc_kernel" in n for n in names), names
        names = launched_kernels(lambda: mk.max_query_infonce_bwd(
            bank, labels, BLIP2_TAU, stats[0], stats[1], gout, res))
        assert any("mq_routed_bwd_kernel" in n for n in names), names
        assert not any("mq_fwd" in n for n in names), names
    # the distinct routed rows (m, q*) the backward must read
    seen = torch.zeros(m * nq, dtype=torch.bool, device=q.device)
    seen[(torch.arange(m, device=q.device)[None, :] * nq
          + res[1].long()).reshape(-1)] = True
    routed = int(seen.sum())
    del seen, res2
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
                  dtype=dtype_name(bank.dtype), routed_rows=routed,
                  routed_share=routed / (m * nq), route_flips=flips)
    # bytes: each input read once, each output written once. #9: feats, the
    # bank (with its scales), the labels; the statistics, loss, dtau and the
    # (M, B) float32 + int16 residuals written; products: three of
    # 2·B·M·Q·D, split TF32 at the TF32 peak over a float32 bank, bf16 at
    # the bf16 peak over a bf16 or int8 one (the routes of the kernel). #10:
    # the residuals, the distinct routed rows (and their scales), labels,
    # mx, se, gout read, dfeats written; 2·B·M·D float32 FMAs
    elem = rows.element_size()
    bank_bytes = rows.numel() * elem + (4 * bank.scales.numel() if quant
                                        else 0)
    res_bytes = m * b * (4 + 2)
    f_ms, f_by = bound_ms(b * d * 4 + bank_bytes + b * 4 + 4 * b * 4 + 8
                          + res_bytes, 3 * 2 * b * m * nq * d,
                          "tf32" if rows.dtype == torch.float32
                          else torch.bfloat16)
    b_ms, b_by = bound_ms(res_bytes + routed * (d * elem + (4 if quant else 0))
                          + b * 4 + 2 * b * 4 + 4 + b * d * 4,
                          2 * b * m * d, torch.float32)
    fwd = dict(common, rtol=BANK_RTOL, atol=BANK_RTOL, max_abs_err=fwd_err,
               max_err_over_tol=fwd_share, bound_ms=f_ms, bound_by=f_by)
    bwd = dict(common, rtol=BANK_RTOL, atol=BANK_DQ_ATOL, max_abs_err=bwd_err,
               max_err_over_tol=bwd_share, bound_ms=b_ms, bound_by=b_by)
    del want_dq, routed_dq, dq2, at_route, want_l, want_r
    if time_it:
        ce = torch.nn.functional.cross_entropy
        dense = bank.dequantize if quant else bank.float

        def library(feats):
            sims = torch.einsum("bd,mqd->bmq", feats, dense())
            return ce(sims.amax(dim=-1) / BLIP2_TAU, labels)

        def pair():
            _, st, _, r = mk.max_query_infonce_fwd(q, bank, labels, BLIP2_TAU,
                                                   routing=True)
            mk.max_query_infonce_bwd(bank, labels, BLIP2_TAU, st[0], st[1],
                                     gout, r)

        with torch.no_grad():
            fwd["ms"] = median_ms(lambda: mk.max_query_infonce_fwd(
                q, bank, labels, BLIP2_TAU, routing=True), reps=10)
            fwd["plain_ms"] = median_ms(
                lambda: mk.max_query_infonce_stats_reference(
                    q, bank, labels, BLIP2_TAU), reps=5, warmup=1)
            fwd["library_ms"] = median_ms(lambda: library(q), reps=5,
                                          warmup=1)
            bwd["ms"] = median_ms(lambda: mk.max_query_infonce_bwd(
                bank, labels, BLIP2_TAU, stats[0], stats[1], gout, res),
                reps=10)
            bwd["plain_ms"] = median_ms(
                lambda: mk.max_query_infonce_bwd_reference(
                    q, bank, labels, BLIP2_TAU, want[0], want[1], gout),
                reps=5, warmup=1)
            fwd["device_ms"] = device_ms(lambda: mk.max_query_infonce_fwd(
                q, bank, labels, BLIP2_TAU, routing=True), n=10)
            fwd["library_device_ms"] = device_ms(lambda: library(q), n=10)
            bwd["device_ms"] = device_ms(lambda: mk.max_query_infonce_bwd(
                bank, labels, BLIP2_TAU, stats[0], stats[1], gout, res), n=10)
            pair_ms = device_ms(pair, n=10)
        leaf = q.clone().requires_grad_()
        lib_loss = library(leaf)
        bwd["library_ms"] = median_ms(lambda: torch.autograd.grad(
            lib_loss, leaf, retain_graph=True), reps=5, warmup=1)
        bwd["library_device_ms"] = device_ms(lambda: torch.autograd.grad(
            lib_loss, leaf, retain_graph=True), n=10)
        del lib_loss
        lib_pair_ms = device_ms(lambda: torch.autograd.grad(
            library(leaf), leaf), n=10)
        del leaf
        for rec in (fwd, bwd):
            rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
            rec["pair_device_ms"] = pair_ms
            rec["library_pair_device_ms"] = lib_pair_ms
    routes = (", tensor-core forward, backward from the residuals"
              if time_it else "")
    for name, rec in (("max_query_infonce_fwd", fwd),
                      ("max_query_infonce_bwd", bwd)):
        times = (f"kernel {rec['ms']:.4f} ms a call, {rec['device_ms']:.4f} "
                 f"ms of device time back to back "
                 f"({100 * rec['bound_share']:.1f}% of the bound), plain "
                 f"{rec['plain_ms']:.4f} ms, library (einsum + amax + "
                 f"cross_entropy{' backward' if name.endswith('bwd') else ''}"
                 f") {rec['library_ms']:.4f} ms a call, "
                 f"{rec['library_device_ms']:.4f} back to back, "
                 if time_it else "")
        kind = ("#9 bound (bytes of the bank and the residuals, three "
                "tensor-core products)" if name.endswith("fwd") else
                "#10 bound (residuals, routed rows, dfeats)")
        phase(f"kernel {name} {rec['shape']} bank {rec['dtype']}: "
              f"max_abs_err={rec['max_abs_err']:.3e}, "
              f"{rec['max_err_over_tol']:.3f} of the tolerance "
              f"(atol={rec['atol']} + rtol={rec['rtol']}·|plain|), "
              f"repeatable{routes}; {times}{kind} {rec['bound_ms']:.5f} ms by "
              f"{rec['bound_by']}; {rec['routed_rows']} distinct routed rows "
              f"({100 * rec['routed_share']:.1f}% of M·Q), "
              f"{rec['route_flips']} near-tie routes off the plain argmax "
              f"[{card}]")
    if time_it:
        phase(f"pair #9 + #10 {fwd['shape']} bank {fwd['dtype']}: "
              f"{fwd['pair_device_ms']:.4f} ms of device time back to back, "
              f"library forward + autograd backward "
              f"{fwd['library_pair_device_ms']:.4f} ms [{card}]")
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
    argv = bf16_argv(root, "--batch-size", str(BLIP2_BATCH), "--num-epochs",
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

    args, fresh = fresh_sides(common, argv, "blip2")
    assert args.tau == BLIP2_TAU and args.clip_model_name == "pretrain"
    ckpt = os.path.join(out, "best.pt")
    t1 = time.perf_counter()
    _, trained = fresh_sides(common, argv, "blip2")
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
    eval_argv = bf16_argv(root, "--model_path", ckpt)
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
        prof = batch_profile(lambda: backbone.fusion_bank_features(images,
                                                                   text),
                             "eva_extract")
    phase(f"EVA ViT-g bf16 bank extraction at 224 (fusion_bank_features): "
          f"{BLIP2_BATCH / (ms / 1e3):.1f} images/s on the device (batch "
          f"{BLIP2_BATCH}, {ms:.3f} ms/batch; {EVA_LAYERS} long-attention "
          f"launches at its shape take {attn_ms:.1f} ms alone, "
          f"{100 * attn_ms / ms:.0f}% of the batch; "
          f"{extraction_line(*prof, ms)}) [{card}]")


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


# ---------------------------------------------------------------------------
# The LLaMA-2 7B rewriter: kernels #11 and #12 (phase 3f), the rewrite path
# (11a), int8 weights through #12 (11b), the CLI (11c), plain-route checks
# (11d)
# ---------------------------------------------------------------------------

def llama_launches(decode: int, quant: int = 0) -> dict:
    """The counts of a LLaMA path: #11 and #12 as given, none of the
    retrieval kernels."""
    return dict(short_attention=0, short_attention_bwd=0, **NO_LONG,
                **{**bank_launches(False, 0), "decode_attention": decode,
                   "quant_matmul": quant})


def decode_attention_case(da, q, k, v, li, bias, ks, vs, card, time_it=True):
    """#11 against its plain version on one case; a second launch gives the
    same bits. Returns the record."""
    import torch.nn.functional as F

    quant = ks is not None
    tol = DECODE_TOL[k.dtype]
    got = da.decode_attention(q, k, v, li, bias, ks, vs)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = da.decode_attention_reference(q, k, v, li, bias, ks, vs)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got, da.decode_attention(q, k, v, li, bias, ks, vs)), \
        "not repeatable"
    diff = (got.float() - want.float()).abs()
    n_layers, b, length, width = k.shape
    heads, hd = q.shape[1], q.shape[2]
    # bytes: layer li's K and V rows (and their scales), q, bias and the
    # output, each once; 4·B·H·L·hd float32 operations
    n_bytes = (2 * b * length * width * k.element_size()
               + q.numel() * q.element_size() + bias.numel() * 4
               + got.numel() * got.element_size()
               + (2 * b * length * 4 if quant else 0))
    b_ms, b_by = bound_ms(n_bytes, 4 * b * heads * length * hd, torch.float32)
    index = k.device.index or 0
    sm, per_sm = da.device_plan_inputs(index, da._CACHE_CODES[k.dtype], hd)
    rows, n_splits = da.split_plan(length, b * heads, sm)
    tile = (32 // da.lane_group(hd)) * da.GROUP_ROWS[k.dtype]
    rec = dict(shape=f"B={b}, H={heads}, hd={hd}, L={length}, layer {li} of "
                     f"{n_layers}", dtype=dtype_name(k.dtype), atol=tol,
               rtol=tol, max_abs_err=diff.max().item(),
               max_err_over_tol=(diff / (tol + tol * want.float().abs())
                                 ).max().item(), bound_ms=b_ms, bound_by=b_by,
               design=f"CUDA cores; {da.WARPS} warps a block, each a "
                      f"cp.async ring of 3 tiles of {tile} rows; softmax "
                      f"per tile; splits merged in a cluster",
               blocks_per_sm=per_sm, plan=dict(
                   rows_per_split=rows, n_splits=n_splits,
                   blocks=b * heads * n_splits))
    del want, diff
    if time_it:
        kv_heads = width // hd

        def library():
            kl, vl = k[li], v[li]
            if quant:
                kl = kl.float() * ks[li][..., None]
                vl = vl.float() * vs[li][..., None]
            kh = kl.view(b, length, kv_heads, hd).transpose(1, 2)
            vh = vl.view(b, length, kv_heads, hd).transpose(1, 2)
            return F.scaled_dot_product_attention(
                q[:, :, None, :].to(kh.dtype), kh, vh,
                attn_mask=bias[:, None, None, :].to(kh.dtype))

        with torch.no_grad():
            rec["ms"] = median_ms(lambda: da.decode_attention(
                q, k, v, li, bias, ks, vs))
            rec["device_ms"] = device_ms(lambda: da.decode_attention(
                q, k, v, li, bias, ks, vs))
            rec["plain_ms"] = median_ms(
                lambda: da.decode_attention_reference(q, k, v, li, bias, ks,
                                                      vs), reps=10)
            rec["library_ms"] = median_ms(library, reps=10)
            rec["library_device_ms"] = device_ms(library, n=20)
        rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
    times = (f"kernel {rec['ms']:.4f} ms a call, {rec['device_ms']:.4f} ms "
             f"of device time back to back "
             f"({100 * rec['bound_share']:.1f}% of the bound), plain "
             f"{rec['plain_ms']:.4f} ms, library (SDPA at query length 1"
             f"{', int8 dequantized first' if quant else ''}) "
             f"{rec['library_ms']:.4f} ms a call, "
             f"{rec['library_device_ms']:.4f} back to back, "
             if time_it else "")
    phase(f"kernel decode_attention {rec['shape']} cache {rec['dtype']}: "
          f"max_abs_err={rec['max_abs_err']:.3e}, "
          f"{rec['max_err_over_tol']:.3f} of the tolerance (atol={tol} + "
          f"rtol={tol}·|plain|), repeatable; {times}bound "
          f"{rec['bound_ms']:.5f} ms by {rec['bound_by']}; design: "
          f"{rec['design']}; {per_sm} blocks an SM, {n_splits} split(s) of "
          f"{rows} rows, {rec['plan']['blocks']} blocks [{card}]")
    return rec


def decode_inputs(b, heads, hd, length, layers, li, kind, generator, device):
    """q (B, H, hd) float32 (the decode step's q after RoPE); a stacked
    (layers, B, L, H·hd) cache whose layer li alone is written (the kernel
    and the plain version read no other); a bias masking the rows past the
    step's position and a left pad of row 0."""
    from spn4cir_tpu_torch.models.llama import _quant_rows

    q = torch.randn(b, heads, hd, generator=generator, device=device)
    shape = (layers, b, length, heads * hd)
    dtype = torch.int8 if kind == "int8" else getattr(torch, kind)
    k = torch.empty(shape, dtype=dtype, device=device)
    v = torch.empty(shape, dtype=dtype, device=device)
    ks = vs = None
    rows = [torch.randn(shape[1:], generator=generator, device=device)
            for _ in range(2)]
    if kind == "int8":
        ks = torch.empty(shape[:3], device=device)
        vs = torch.empty(shape[:3], device=device)
        (k[li], ks[li]), (v[li], vs[li]) = (_quant_rows(r) for r in rows)
    else:
        k[li], v[li] = (r.to(dtype) for r in rows)
    del rows
    pos = length - 1 - min(LLAMA_NEW // 2, length // 3)
    bias = torch.zeros(b, length, device=device)
    bias[:, pos + 1:] = -1e9
    bias[0, :min(40, pos)] = -1e9
    return q, k, v, bias, ks, vs


def check_decode_attention(da, device, card):
    """Phase 3f, #11: the 7B's decode geometry (32 heads of 128, layer 31 of
    32) at B = 1, 8, 16 over the CIRR prompts' 1,842 cache rows, at B=16
    over FIQ's 1,241 and over LLaVA's 547, each over float32, bf16 and int8
    caches, timed; then a
    ragged B=3, H=4, hd=8, L=37 (the tiny LM's head_dim) untimed."""
    g = torch.Generator(device=device).manual_seed(21)
    records = []
    shapes = [(bb, LLAMA_LEN_CIRR) for bb in (1, 8, LLAMA_BATCH)]
    shapes += [(LLAMA_BATCH, LLAMA_LEN_FIQ), (LLAVA_BATCH, LLAVA_LEN)]
    for b, length in shapes:
        for kind in ("bfloat16", "float32", "int8"):
            case = decode_inputs(b, 32, 128, length, 32, 31, kind, g, device)
            records.append(decode_attention_case(da, *case[:3], 31, *case[3:],
                                                 card))
            del case
            torch.cuda.empty_cache()
    for kind in ("float32", "bfloat16", "int8"):
        case = decode_inputs(3, 4, 8, 37, 2, 1, kind, g, device)
        records.append(decode_attention_case(da, *case[:3], 1, *case[3:],
                                             card, time_it=False))
    return records


def quant_matmul_case(qm, x, values, scales, w_bf16, card, time_it=True):
    """#12 against its plain version on one case; a second launch gives the
    same bits. Returns the record."""
    tol = QMM_TOL[x.dtype]
    got = qm.quant_matmul(x, values, scales)
    torch.cuda.synchronize()
    want = qm.quant_matmul_reference(x, values, scales)
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * scale)
    assert torch.equal(got, qm.quant_matmul(x, values, scales)), \
        "not repeatable"
    diff = (got.float() - want.float()).abs()
    rows, d = x.shape
    f = values.shape[1]
    # bytes: the int8 weight, its scales, x and y, each once; operations:
    # 2·R·D·F on the bf16 tensor cores, three times over for float32 x (its
    # three bf16 terms)
    terms = 3 if x.dtype == torch.float32 else 1
    b_ms, b_by = bound_ms(d * f + 4 * f + rows * (d + f) * x.element_size(),
                          terms * 2 * rows * d * f, torch.bfloat16)
    clusters = qm.device_plan_inputs(x.device.index or 0,
                                     qm._X_CODES[x.dtype],
                                     qm.n_tiles_for(rows))
    nt, per, n_splits = qm.split_plan(rows, d, f, clusters)
    rec = dict(shape=f"rows={rows}, D={d}, F={f}", dtype=dtype_name(x.dtype),
               atol=tol * scale, rtol=tol, max_abs_err=diff.max().item(),
               max_err_over_tol=(diff / (tol * scale + tol * want.float().abs())
                                 ).max().item(), bound_ms=b_ms, bound_by=b_by,
               design=f"bf16 tensor cores (mma.sync m16n8k16), {terms} "
                      f"product(s) a W fragment; {qm.COLS} columns x "
                      f"{8 * nt} rows a block, a cp.async ring of 4 stages "
                      f"of {qm.DEPTH} rows; splits of D merged in a cluster",
               plan=dict(n_tiles=nt, d_per_split=per, n_splits=n_splits,
                         blocks=n_splits * -(-f // qm.COLS)
                         * -(-rows // (8 * nt)),
                         clusters_at_once=clusters[n_splits - 1]))
    if time_it:
        xb = x.to(torch.bfloat16)

        def library():
            return (x @ values.to(x.dtype)) * scales.to(x.dtype)

        rec["ms"] = median_ms(lambda: qm.quant_matmul(x, values, scales))
        rec["device_ms"] = device_ms(lambda: qm.quant_matmul(x, values,
                                                             scales))
        rec["plain_ms"] = median_ms(
            lambda: qm.quant_matmul_reference(x, values, scales), reps=10)
        rec["library_ms"] = median_ms(library, reps=10)
        rec["library_device_ms"] = device_ms(library, n=20)
        rec["library_bf16_ms"] = median_ms(lambda: xb @ w_bf16, reps=10)
        rec["library_bf16_device_ms"] = device_ms(lambda: xb @ w_bf16)
        rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
    times = (f"kernel {rec['ms']:.4f} ms a call, {rec['device_ms']:.4f} ms "
             f"of device time back to back "
             f"({100 * rec['bound_share']:.1f}% of the bound), plain "
             f"{rec['plain_ms']:.4f} ms, library (x @ values.to(x.dtype) * "
             f"scales, the JAX package's dequant-after-matmul) "
             f"{rec['library_ms']:.4f} ms a call, "
             f"{rec['library_device_ms']:.4f} back to back, bf16 cuBLAS on "
             f"the dense weight {rec['library_bf16_ms']:.4f} ms a call, "
             f"{rec['library_bf16_device_ms']:.4f} back to back, "
             if time_it else "")
    phase(f"kernel quant_matmul {rec['shape']} x {rec['dtype']}: "
          f"max_abs_err={rec['max_abs_err']:.3e}, "
          f"{rec['max_err_over_tol']:.3f} of the tolerance (rtol={tol} of "
          f"max|plain| + rtol·|plain|), repeatable; {times}bound "
          f"{rec['bound_ms']:.5f} ms by {rec['bound_by']}; design: "
          f"{rec['design']}; {n_splits} split(s) of {per} rows of W, "
          f"{rec['plan']['blocks']} blocks, {rec['plan']['clusters_at_once']}"
          f" clusters of {n_splits} fit at once [{card}]")
    return rec


def check_quant_matmul(qm, device, card):
    """Phase 3f, #12: x float32 and bf16 at 1, 8 and 16 rows (the decode
    batches of phase 11b) against the 7B's four int8 weight shapes, timed;
    then a ragged rows=5, D=40, F=77 untimed."""
    g = torch.Generator(device=device).manual_seed(22)
    records = []
    for d, f in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)):
        values = torch.randint(-127, 128, (d, f), generator=g, device=device
                               ).to(torch.int8)
        scales = torch.rand(f, generator=g, device=device) * 1e-3 + 1e-4
        w_bf16 = (values.float() * scales).to(torch.bfloat16)
        for dtype in (torch.float32, torch.bfloat16):
            for rows in Q8_BATCHES:
                x = torch.randn(rows, d, generator=g, device=device).to(dtype)
                records.append(quant_matmul_case(qm, x, values, scales,
                                                 w_bf16, card))
        del values, w_bf16
    values = torch.randint(-127, 128, (40, 77), generator=g, device=device
                           ).to(torch.int8)
    scales = torch.rand(77, generator=g, device=device) + 0.1
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(5, 40, generator=g, device=device).to(dtype)
        records.append(quant_matmul_case(qm, x, values, scales, None, card,
                                         time_it=False))
    torch.cuda.empty_cache()
    return records


def llama_model(device, dtype=torch.bfloat16, layers=None, seed=0):
    """LLaMA-2-7B-chat at full width (32 layers unless `layers` cuts the
    depth), random weights drawn in place on the device from a seeded
    generator."""
    from spn4cir_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b_chat()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = LlamaForCausalLM(cfg, device="meta", dtype=dtype)
    model.to_empty(device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return cfg, model.eval()


def rewrite_world(tmp):
    """A synthetic CIRR tree whose train split holds REWRITE_PAIRS images,
    CIRR-like captions for them (an it-list on disk too), and the port's
    CIRDataset over it."""
    import random

    from spn4cir_tpu_torch.data.datasets import CIRDataset
    from spn4cir_tpu_torch.data.transforms import ImageTransform

    root = load_test_module("fixtures").make_cirr(
        os.path.join(tmp, "cirr_rewrite"), n_images=REWRITE_PAIRS,
        n_train=8 * REWRITE_PAIRS, n_val=8, extended=False)
    ds = CIRDataset("cirr", "train", "relative",
                    ImageTransform("targetpad", 224), root)
    assert len(ds.imagenames) == REWRITE_PAIRS, len(ds.imagenames)
    rng = random.Random(0)
    subjects = ("A brown dog", "Two parrots", "A red car", "A small cat",
                "An old church", "Three monkeys", "A white horse",
                "A blue bicycle", "A baby panda", "A tall tower")
    places = ("on the grass", "in a cage", "near a lake", "on a street",
              "under a tree", "in the snow", "by a window", "at the beach")
    details = ("looking up at the sky", "in the bright sun",
               "with a red collar", "seen from far above",
               "late in the evening", "next to a wooden fence")
    # 39-52 characters: any pair's prompt is 1,765-1,791 byte tokens, so
    # every group pads to 1,792 (LLAMA_LEN_CIRR - LLAMA_NEW)
    name2cap = {n: f"{rng.choice(subjects)} {rng.choice(places)}, "
                   f"{rng.choice(details)}." for n in ds.imagenames}
    it_path = os.path.join(tmp, "rewrite_it.json")
    with open(it_path, "w") as fh:
        json.dump([{"image_id": n, "caption": c}
                   for n, c in name2cap.items()], fh)
    return root, ds, name2cap, it_path


class StepClock:
    """Wraps the llama module's prefill and decode-step functions (which
    `llama_generate` calls through the module) with CUDA events and the host
    clock around every call; with `keep_state`, keeps the state of the last
    decode step (and so its cache alive)."""

    NAMES = ("llama_prefill", "llama_prefill_chunked", "llama_decode_step")

    def __init__(self, tl, keep_state=False):
        self.tl, self.calls, self.saved, self.last_state = tl, [], {}, None
        self.keep_state = keep_state

    def __enter__(self):
        for name in self.NAMES:
            self.saved[name] = getattr(self.tl, name)
            setattr(self.tl, name, self._wrap(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.tl, name, fn)

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.calls.append((name, start, end, t0, time.perf_counter()))
            if self.keep_state and name == "llama_decode_step":
                self.last_state = out[1]
            return out
        return wrapper

    def groups(self):
        """Per generate call: (prefill ms, decode steps, decode ms/step by
        CUDA events, decode ms/step by the host clock)."""
        torch.cuda.synchronize()
        out, cur = [], None
        for call in self.calls:
            if call[0] != "llama_decode_step":
                cur = [call, []]
                out.append(cur)
            else:
                cur[1].append(call)
        res = []
        for pre, steps in out:
            n = len(steps)
            res.append(dict(
                prefill_ms=pre[1].elapsed_time(pre[2]), steps=n,
                step_ms=steps[0][1].elapsed_time(steps[-1][2]) / n,
                step_host_ms=(steps[-1][4] - steps[0][3]) * 1e3 / n))
        return res


def left_padded(params, tok, prompts, device):
    """The batch generate function's layout: ids left-padded with EOS to the
    next multiple of 32 -> (embeddings, mask)."""
    from spn4cir_tpu_torch.models.llama import embed_tokens

    enc = [tok.encode(p) for p in prompts]
    plen = -(-max(len(e) for e in enc) // 32) * 32
    ids = torch.full((len(enc), plen), tok.eos_token_id, dtype=torch.long)
    mask = torch.zeros(len(enc), plen, dtype=torch.long)
    for r, e in enumerate(enc):
        ids[r, plen - len(e):] = torch.tensor(e)
        mask[r, plen - len(e):] = 1
    ids, mask = ids.to(device), mask.to(device)
    return embed_tokens(params, ids), mask


def decode_args(tl, params, cfg, tok, mask, step, device):
    """Arguments of decode step `step` (1-based) after a left-padded prefill
    of `mask`'s width: (x, pos, rope_pos, key_mask)."""
    b, plen = mask.shape
    x = tl.embed_tokens(params, torch.full((b,), tok.eos_token_id,
                                           device=device))
    valid = torch.cat([mask, torch.ones(b, LLAMA_NEW, dtype=mask.dtype,
                                        device=device)], 1)
    return x, plen + step - 1, mask.sum(1) + step - 1, valid


def step_line(path, prof):
    """The decode step's device summary: busy, #11's and #12's ms a step,
    idle share (phase 11)."""
    groups = prof["ms_by_group"]
    prof["kernel_11_ms"] = groups.get("decode attention (#11)", 0.0)
    prof["kernel_12_ms"] = groups.get("int8 matmul (#12)", 0.0)
    return (f"decode step on the device, {path}: busy "
            f"{prof['busy_ms']:.3f} ms/step, #11 {prof['kernel_11_ms']:.3f} "
            f"ms/step, #12 {prof['kernel_12_ms']:.3f} ms/step, idle "
            f"{100 * prof['idle_share']:.1f}% of {prof['step_ms']:.3f} "
            f"ms/step")


def profile_decode(tl, params, cfg, state, args, quant_kernel, tmp, tag):
    """Decode steps timed with CUDA events without the profiler, then a
    profiler window over as many: (ms/step, device busy ms/step, idle share
    of the unprofiled step, ms/step by kernel group)."""
    from torch.profiler import ProfilerActivity, profile

    x, pos, rope_pos, valid = args

    def steps(n):
        for _ in range(n):
            tl.llama_decode_step(params, cfg, state, x, pos,
                                 rope_pos=rope_pos, key_mask=valid,
                                 quant_kernel=quant_kernel, attn_kernel=True)

    steps(2)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    steps(LLAMA_PROFILE_STEPS)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / LLAMA_PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        steps(1)                 # the profiler's start-up, dropped
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(LLAMA_PROFILE_STEPS)
        torch.cuda.synchronize()
    trace = os.path.join(tmp, f"decode_trace_{tag}.json")
    prof.export_chrome_trace(trace)
    busy, n_ops, groups = device_busy(trace)
    assert n_ops > 0, "the profiler's trace holds no device interval"
    busy /= LLAMA_PROFILE_STEPS
    per = {k: round(v / LLAMA_PROFILE_STEPS, 4) for k, v in
           sorted(groups.items(), key=lambda kv: -kv[1])}
    return dict(step_ms=step_ms, busy_ms=busy,
                idle_share=1 - busy / step_ms,
                ops_per_step=n_ops / LLAMA_PROFILE_STEPS, ms_by_group=per)


def drive_rewrite(ak, bk, model, cfg, tok, world, tmp, card):
    """Phase 11a: the 7B rewriter through the datagen core at full width:
    `generate_extended_triplets` with the batch rewriter that
    `load_torch_rewriter` composes (16 prompts a group, 50 new tokens,
    prefill in chunks of 128), then `write_extended_triplets`; once with a
    bf16 cache, once with an int8 one. Each run is counted from zero; then,
    outside the count, the first group's prompts are prefilled again for a
    profiler window over decode steps and, over the bf16 cache, the first
    step's logits through #11 against the plain route from the same cache.
    Returns the launches of both runs, summed."""
    from spn4cir_tpu_torch.datagen import generate as gen
    from spn4cir_tpu_torch.datagen import llm_rewrite as lr
    from spn4cir_tpu_torch.models import llama as tl

    root, ds, name2cap, _ = world
    device = torch.device("cuda:0")
    count = counters(ak, bk)
    total = {}
    results = {}
    groups_n = -(-REWRITE_PAIRS // LLAMA_BATCH)
    for cache in (torch.bfloat16, torch.int8):
        name = dtype_name(cache)
        rewriter = lr.make_llm_batch_rewriter(
            lr.make_torch_batch_generate_fn(
                model, cfg, tok, batch_size=LLAMA_BATCH,
                max_new_tokens=LLAMA_NEW, prefill_chunk=LLAMA_CHUNK,
                cache_dtype=cache), "cirr", mod_type=0, llm_type=1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in count.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with StepClock(tl) as clock:
            triplets = gen.generate_extended_triplets(
                ds, name2cap, llm_rewrite=rewriter, seed=0)
        wall = time.perf_counter() - t0
        launches = read_counts(count)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        assert launches == llama_launches(
            cfg.num_layers * (LLAMA_NEW - 1) * groups_n), launches
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        path = gen.write_extended_triplets(ds, triplets, f"zs7b_{name}",
                                           llm=True)
        with open(path) as fh:
            written = json.load(fh)
        assert len(written) == REWRITE_PAIRS, len(written)
        assert all(isinstance(t["llm_caption"], str) for t in written)
        assert all(t["caption1"] == name2cap[t["reference"]]
                   for t in written)
        per = clock.groups()
        assert len(per) == groups_n and all(g["steps"] == LLAMA_NEW - 1
                                            for g in per), per
        step_ms = statistics.mean(g["step_ms"] for g in per)
        stats = dict(
            wall_s=wall, groups=per, peak_gb=peak_gb,
            decode_ms_per_step=step_ms,
            decode_host_ms_per_step=statistics.mean(
                g["step_host_ms"] for g in per),
            decode_tokens_s=LLAMA_BATCH * 1e3 / step_ms,
            generated_tokens_s=REWRITE_PAIRS * LLAMA_NEW / wall)

        # outside the count: the first group again, for the profiler and,
        # over bf16, the logits of #11 against the plain route
        prompts = [lr.build_rewrite_prompt(t["caption1"], t["caption2"],
                                           "cirr", 0, 1)
                   for t in triplets[:LLAMA_BATCH]]
        emb, mask = left_padded(model, tok, prompts, device)
        plen = mask.shape[1]
        assert plen + LLAMA_NEW == LLAMA_LEN_CIRR, plen
        state = tl.init_llama_state(cfg, LLAMA_BATCH, plen + LLAMA_NEW,
                                    dtype=cache, device=device)
        tl.llama_prefill_chunked(
            model, cfg, state, emb, chunk=LLAMA_CHUNK,
            positions=torch.clamp(torch.cumsum(mask, 1) - 1, min=0),
            pad_mask=mask)
        args = decode_args(tl, model, cfg, tok, mask, 1, device)
        if cache == torch.bfloat16:
            x, pos, rope_pos, valid = args
            # [0]: the logits alone, so that no name keeps a cache alive
            plain = tl.llama_decode_step(model, cfg, state.clone(), x, pos,
                                         rope_pos=rope_pos, key_mask=valid,
                                         attn_kernel=False)[0]
            kern = tl.llama_decode_step(model, cfg, state, x, pos,
                                        rope_pos=rope_pos, key_mask=valid,
                                        attn_kernel=True)[0]
            diff = (kern - plain).abs().max().item()
            same_top = (kern.argmax(-1) == plain.argmax(-1)).sum().item()
            stats["first_step_logits"] = dict(
                max_abs_diff=diff, tol=LLAMA_BF16_LOGIT_TOL,
                logit_std=plain.std().item(), same_top1=same_top)
            phase(f"rewrite, 7B bf16 at full depth: the first decode step's "
                  f"logits through #11 against the plain route from the same "
                  f"bf16 cache (B={LLAMA_BATCH}, {plen} prompt rows): max "
                  f"|diff| {diff:.4e} (tolerance {LLAMA_BF16_LOGIT_TOL}; "
                  f"logit std {plain.std().item():.3f}), the same top-1 in "
                  f"{same_top} of {LLAMA_BATCH} rows [{card}]")
            assert diff <= LLAMA_BF16_LOGIT_TOL, diff
            del plain, kern
        stats["profile"] = profile_decode(tl, model, cfg, state, args, False,
                                          tmp, f"rewrite_{name}")
        del state, emb
        torch.cuda.empty_cache()
        prof = stats["profile"]
        stats["kernel_11_device_ms_per_launch"] = prof["ms_by_group"].get(
            "decode attention (#11)", 0.0) / cfg.num_layers
        assert stats["kernel_11_device_ms_per_launch"] > 0, prof
        results[name] = stats
        phase(step_line(f"bf16 weights, {name} cache, B={LLAMA_BATCH}", prof)
              + f" [{card}]")
        phase(f"rewrite slice ({name} cache): generate_extended_triplets "
              f"rewrote {REWRITE_PAIRS} CIRR pairs with the 7B (bf16 weights, "
              f"B={LLAMA_BATCH}, {groups_n} groups, {plen}-row prompts, "
              f"{LLAMA_NEW} new tokens) in {wall:.2f} s: prefill "
              f"{[round(g['prefill_ms'], 1) for g in per]} ms per group; "
              f"decode {step_ms:.3f} ms/step by CUDA events (host clock "
              f"{stats['decode_host_ms_per_step']:.3f}), "
              f"{stats['decode_tokens_s']:.1f} tokens/s in decode, "
              f"{stats['generated_tokens_s']:.1f} generated tokens/s end to "
              f"end; peak device memory {peak_gb:.2f} GiB; #11 launched "
              f"{launches['decode_attention']} times ({cfg.num_layers} x "
              f"{LLAMA_NEW - 1} x {groups_n}); "
              f"profile over {LLAMA_PROFILE_STEPS} decode steps: "
              f"{prof['step_ms']:.3f} ms/step unprofiled, device busy "
              f"{prof['busy_ms']:.3f} ms/step in {prof['ops_per_step']:.0f} "
              f"device operations, idle share {100 * prof['idle_share']:.1f}%"
              f"; device ms per step by group {prof['ms_by_group']} (#11 "
              f"{1e3 * stats['kernel_11_device_ms_per_launch']:.1f} us a "
              f"launch); wrote "
              f"{os.path.relpath(path, root)} [{card}]")
    phase("rewrite slice stats " + json.dumps(results))
    return total


def drive_llama_q8(ak, bk, model, cfg, tok, prompts, tmp, card):
    """Phase 11b: the 7B's weights through `quantize_llama_weights`, then
    `llama_generate(..., quant_kernel=True, cache_dtype=int8)` at B = 1, 8
    and 16 on the CIRR prompts, each counted from zero (#12 in every decode
    step's 225 products, #11 in its 32 attentions). Outside the count, the
    A/B: decode steps from the generated cache through #12, through
    dequant-after-matmul (`quant_kernel=False`), and with the bf16 model
    over a bf16 cache of the same size. Returns the launches, summed."""
    from spn4cir_tpu_torch.models import llama as tl

    device = torch.device("cuda:0")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = tl.quantize_llama_weights(model)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    count = counters(ak, bk)
    total, results = {}, {}
    per_step = 7 * cfg.num_layers + 1
    for b in Q8_BATCHES:
        emb, mask = left_padded(qparams, tok, prompts[:b], device)
        plen = mask.shape[1]
        torch.cuda.empty_cache()
        for fn in count.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with StepClock(tl, keep_state=True) as clock:
            out = tl.llama_generate(
                qparams, cfg, emb, eos_id=tok.eos_token_id,
                pad_id=tok.eos_token_id, max_new_tokens=LLAMA_NEW,
                do_sample=True, top_k=10, attention_mask=mask,
                generator=torch.Generator(device=device).manual_seed(b),
                cache_dtype=torch.int8, quant_kernel=True,
                prefill_chunk=LLAMA_CHUNK)
            out = out.cpu()
        wall = time.perf_counter() - t0
        launches = read_counts(count)
        steps = LLAMA_NEW - 1
        assert launches == llama_launches(cfg.num_layers * steps,
                                          per_step * steps), launches
        assert out.shape == (b, LLAMA_NEW) and int(out.min()) >= 0
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        (group,) = clock.groups()
        state = clock.last_state
        clock.last_state = None
        # the last decode step's arguments, stepped again at that row
        args = decode_args(tl, qparams, cfg, tok, mask, steps, device)
        ways = dict(kernel_12=profile_decode(tl, qparams, cfg, state, args,
                                             True, tmp, f"q8_{b}_kernel"),
                    dequant_after_matmul=profile_decode(
                        tl, qparams, cfg, state, args, False, tmp,
                        f"q8_{b}_dequant"))
        del state
        torch.cuda.empty_cache()
        bstate = tl.init_llama_state(cfg, b, plen + LLAMA_NEW,
                                     dtype=torch.bfloat16, device=device)
        ways["bf16_model_bf16_cache"] = profile_decode(
            tl, model, cfg, bstate, decode_args(tl, model, cfg, tok, mask,
                                                steps, device),
            False, tmp, f"q8_{b}_bf16")
        del bstate
        torch.cuda.empty_cache()
        ab = {k: w["step_ms"] for k, w in ways.items()}
        phase(step_line(f"int8 weights through #12, int8 cache, B={b}",
                        ways["kernel_12"]) + f" [{card}]")
        kernel_dev = ways["kernel_12"]["ms_by_group"].get("int8 matmul (#12)",
                                                          0.0)
        assert kernel_dev > 0, ways["kernel_12"]
        results[b] = dict(generate_s=wall, prefill_ms=group["prefill_ms"],
                          step_ms=group["step_ms"],
                          step_host_ms=group["step_host_ms"],
                          decode_tokens_s=b * 1e3 / group["step_ms"],
                          ways=ways,
                          tokens_s_by_way={k: b * 1e3 / v
                                           for k, v in ab.items()},
                          kernel_12_device_ms_per_launch=kernel_dev / per_step)
        phase(f"llama_q8, int8 weights + int8 cache, B={b} ({plen}-row "
              f"prompts): llama_generate(quant_kernel=True) in {wall:.2f} s "
              f"(prefill {group['prefill_ms']:.1f} ms, float32 activations "
              f"over dequantized weights), decode {group['step_ms']:.3f} "
              f"ms/step by CUDA events (host clock "
              f"{group['step_host_ms']:.3f}); #12 launched "
              f"{launches['quant_matmul']} times ({per_step} x {steps}), #11 "
              f"{launches['decode_attention']}; the decode step three ways "
              f"({LLAMA_PROFILE_STEPS} steps, CUDA events; device busy and "
              f"idle share from a profiler window): "
              + "; ".join(f"{k} {w['step_ms']:.3f} ms, busy "
                          f"{w['busy_ms']:.3f}, idle "
                          f"{100 * w['idle_share']:.1f}%, by group "
                          f"{w['ms_by_group']}" for k, w in ways.items())
              + f"; #12 {1e3 * kernel_dev / per_step:.2f} us of device time "
              f"a launch [{card}]")
    del qparams
    torch.cuda.empty_cache()
    phase(f"llama_q8 stats (weights quantized on the device in {quant_s:.2f}"
          f" s) " + json.dumps(results))
    return total


def drive_get_cir_data(ak, bk, world, card, it_path=None):
    """Phase 14b (11c before PR 14): `python -m
    spn4cir_tpu_torch.cli.get_cir_data` through its main(): the tiny LM
    with random weights (`--llm_backend torch-tiny`, the byte tokenizer,
    head_dim 8) rewrites the tree's triplets at --llm_batch 8 on cuda:0 (the
    default --device), counted from zero; `it_path` (the LLaVA captioner's
    it-list: caption -> rewrite as one chain) replaces the tree's own."""
    from spn4cir_tpu_torch.cli import get_cir_data
    from spn4cir_tpu_torch.models.llama import LlamaConfig

    root, _, _, world_it = world
    it_path = it_path or world_it
    count = zero_counts(ak, bk)
    t0 = time.perf_counter()
    path = get_cir_data.main([
        "--dataset", "cirr", "--data_path", root, "--it_list", it_path,
        "--use_llm", "1", "--llm_backend", "torch-tiny", "--llm_batch", "8",
        "--model", "tiny"])
    wall = time.perf_counter() - t0
    launches = read_counts(count)
    with open(path) as fh:
        written = json.load(fh)
    assert len(written) == REWRITE_PAIRS, len(written)
    keys = {"reference", "target_hard", "caption", "pairid", "img_set",
            "caption1", "caption2", "llm_caption"}
    assert all(set(t) == keys and isinstance(t["llm_caption"], str)
               for t in written)
    groups_n = -(-REWRITE_PAIRS // 8)
    assert launches == llama_launches(
        LlamaConfig.tiny().num_layers * (LLAMA_NEW - 1) * groups_n), launches
    phase(f"get_cir_data slice: the CLI wrote {len(written)} triplets with "
          f"the captions of {os.path.relpath(it_path, root)!r} and "
          f"llm_caption to {os.path.relpath(path, root)} in {wall:.2f} s "
          f"(torch-tiny, --llm_batch 8, cuda:0); #11 launched "
          f"{launches['decode_attention']} times at head_dim 8 [{card}]")
    return launches


def plain_margin(tl, params, cfg, emb, mask, tokens, t, row, route):
    """The plain route's top-2 margin (and top logit) of `row` at generate
    step t (0: the prefill's logits), replayed from the prompt with the
    plain stream's own tokens."""
    b, plen = mask.shape
    state = tl.init_llama_state(cfg, b, plen + LLAMA_NEW,
                                device=emb.device)
    logits, state = tl.llama_prefill_chunked(
        params, cfg, state, emb, chunk=LLAMA_CHUNK,
        positions=torch.clamp(torch.cumsum(mask, 1) - 1, min=0),
        pad_mask=mask)
    valid = torch.cat([mask, torch.ones(b, LLAMA_NEW, dtype=mask.dtype,
                                        device=emb.device)], 1)
    for i in range(1, t + 1):
        x = tl.embed_tokens(params, tokens[:, i - 1])
        logits, state = tl.llama_decode_step(
            params, cfg, state, x, plen + i - 1,
            rope_pos=mask.sum(1) + i - 1, key_mask=valid, **route)
    top = logits[row].topk(2).values
    return (top[0] - top[1]).item(), top[0].item()


def check_llama_streams(tok, prompts, card):
    """Phase 11d: at full width, 2 layers, float32, greedy, B=4 on CIRR
    prompts: #11 on and off give the same 50-token streams, and so do #12 and
    dequant-after-matmul over int8 weights; where two streams part, the
    plain path's top-2 margin at that step must be under the float32
    tolerance."""
    from spn4cir_tpu_torch.models import llama as tl

    device = torch.device("cuda:0")
    cfg, model = llama_model(device, torch.float32, layers=2, seed=1)
    qparams = tl.quantize_llama_weights(model)
    emb, mask = left_padded(model, tok, prompts[:4], device)
    kw = dict(eos_id=tok.eos_token_id, pad_id=tok.eos_token_id,
              max_new_tokens=LLAMA_NEW, attention_mask=mask,
              prefill_chunk=LLAMA_CHUNK)
    report = {}
    for label, params, plain_route, kernel_route in (
            ("#11 on / off", model, dict(attn_kernel=False),
             dict(attn_kernel=True)),
            ("#12 on / dequant-after-matmul", qparams,
             dict(attn_kernel=True, quant_kernel=False),
             dict(attn_kernel=True, quant_kernel=True))):
        x = left_padded(params, tok, prompts[:4], device)[0]
        plain = tl.llama_generate(params, cfg, x, **plain_route, **kw).cpu()
        kern = tl.llama_generate(params, cfg, x, **kernel_route, **kw).cpu()
        parted = []
        for r in range(plain.shape[0]):
            where = (plain[r] != kern[r]).nonzero()
            if len(where):
                t = int(where[0])
                margin, top = plain_margin(tl, params, cfg, x, mask,
                                           plain.to(device), t, r,
                                           plain_route)
                parted.append(dict(row=r, step=t, margin=margin, top=top))
                assert margin < STREAM_MARGIN_TOL * max(1.0, abs(top)), \
                    (label, parted)
        report[label] = parted
        phase(f"streams, 2 layers at full width, float32, greedy, B=4: "
              f"{label}: {plain.shape[0] - len(parted)} of {plain.shape[0]} "
              f"{LLAMA_NEW}-token streams identical"
              f"{'; parted at ' + str(parted) if parted else ''} [{card}]")
    del model, qparams
    torch.cuda.empty_cache()
    return report


def tgcir_frozen(name: str) -> bool:
    """The image branch that tgcir's stage 2 freezes, and logit_scale."""
    return (name.startswith(("clip.visual.", "fc.", "tokenlearn.", "masks."))
            or name == "clip.logit_scale")


def drive_tgcir_serving(ak, bk, layers, root, card):
    """Phase 12a: `serve_main(backbone_name="tgcir")` at full ViT-B/16 width
    over the 1,024-image tree, concurrent and sequential /retrieve
    requests, then the checks. Returns the launch counts of the run."""
    import numpy as np

    from spn4cir_tpu_torch.cli.serve import serve_main

    argv = bf16_argv(root, "--batch-size", str(ENCODE_BATCH), "--serve_batch",
                     str(SERVE_BATCH), "--default_k", str(K), "--serve_host",
                     "127.0.0.1", "--serve_port", "0", "--no-block")
    count = zero_counts(ak, bk)
    t0 = time.perf_counter()
    server, service = serve_main(argv, backbone_name="tgcir")
    startup_s = time.perf_counter() - t0
    port = server.server_address[1]
    try:
        index = service.index
        names = list(index.names)
        # the first round takes the text side's warm-up
        rounds, sequential = drive_queries(port, names, 2)
        launches = read_counts(count)
        dispatches = service.metrics()["dispatches"]
    finally:
        server.shutdown()
        server.server_close()

    backbone = service.backbone
    cfg = backbone.cfg
    assert (cfg.vision_width, cfg.vision_layers, cfg.vision_heads,
            cfg.vision_patch_size, cfg.image_resolution, cfg.transformer_width,
            cfg.transformer_layers, cfg.transformer_heads,
            cfg.embed_dim) == (768, 12, 12, 16, 224, 512, 12, 8, 512), cfg
    n_images = len(names)
    encode_batches = math.ceil(n_images / ENCODE_BATCH)
    want = dict(long_attention=cfg.vision_layers * encode_batches,
                long_attention_bwd=0,
                short_attention=cfg.transformer_layers * dispatches,
                short_attention_bwd=0, **bank_launches(False, 0))
    phase(f"tgcir serving slice (serve_main, ViT-B/16 bf16 at 224, "
          f"{sum(p.numel() for p in backbone.parameters()) / 1e6:.1f} M "
          f"parameters): {n_images} images indexed in {encode_batches} "
          f"encode batches of {ENCODE_BATCH} ({startup_s:.1f} s with the "
          f"model's construction), {2 * N_CONCURRENT + N_SEQUENTIAL} queries "
          f"in {dispatches} fuse dispatches; launches {launches} (want 12 "
          f"long-attention forwards per encode batch at S=197 and 12 short "
          f"ones per dispatch: {want})")
    assert launches == want, (launches, want)
    target = index.target
    assert target.shape == (n_images, 512), target.shape
    assert index.refer.shape == (n_images, 12, 512), index.refer.shape
    assert torch.isfinite(target).all() and np.isfinite(index.refer).all()
    norms = target.float().norm(dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-3), norms

    plain_rescore("tgcir", ak, layers, service, root)

    stats = dict(startup_s=startup_s, dispatches=dispatches,
                 concurrent_round1_p50_ms=statistics.median(rounds[0]),
                 concurrent_round1_p99_ms=pct(rounds[0], 0.99),
                 concurrent_p50_ms=statistics.median(rounds[1]),
                 concurrent_p99_ms=pct(rounds[1], 0.99),
                 sequential_p50_ms=statistics.median(sequential),
                 sequential_p99_ms=pct(sequential, 0.99))
    phase(f"tgcir query latency, {N_CONCURRENT} concurrent (second round; "
          f"the first: p50 {stats['concurrent_round1_p50_ms']:.2f} ms): p50 "
          f"{stats['concurrent_p50_ms']:.2f} ms, p99 "
          f"{stats['concurrent_p99_ms']:.2f} ms; sequential: p50 "
          f"{stats['sequential_p50_ms']:.2f} ms, p99 "
          f"{stats['sequential_p99_ms']:.2f} ms [{card}]")
    phase("tgcir serving slice stats " + json.dumps(stats))
    return launches


def drive_tgcir_training(ak, bk, root, tmp, card, n_gallery):
    """Phase 12b: `train_main("tgcir")` through its argv at batch 256 over a
    float32 bank and, from the same bank cache, an int8 one; the checks;
    then `validate_main("tgcir")` and `submission_main("tgcir")` on the
    float32 run's checkpoint. Returns the launch counts of the training
    runs and of the two evaluation entry points."""
    from spn4cir_tpu_torch.bank.bank import Bank
    from spn4cir_tpu_torch.cli import common, submission, train, validate
    from spn4cir_tpu_torch.data.datasets import CIRDataset, iter_train_bank
    from spn4cir_tpu_torch.models.convert import load_tgcir_checkpoint

    out = os.path.join(tmp, "tgcir_run")
    argv = bf16_argv(root, "--batch-size", str(TRAIN_BATCH), "--num-epochs",
                     "1", "--output_path", out)
    bank_file = os.path.join(out, "cirr_bank.npz")
    count = zero_counts(ak, bk)
    runs = []
    t0 = time.perf_counter()
    for extra in ((), ("--bank_dtype", "int8", "--bank_path", bank_file,
                       "--output_path", out + "_int8")):
        tee = Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            best = train.train_main("tgcir", argv + list(extra), log_every=1)
        runs.append((best, logged_losses(tee.buffer_.getvalue())))
    launches = read_counts(count)
    train_s = time.perf_counter() - t0

    args, fresh = fresh_sides(common, argv, "tgcir")
    _, trained = fresh_sides(common, argv, "tgcir")
    trained.model.load_state_dict(load_tgcir_checkpoint(
        os.path.join(out, "best.pt")))
    cfg = trained.cfg
    preprocess = common.make_transform(trained, args)
    ds = CIRDataset("cirr", "train", "relative", preprocess, root,
                    args.dress_types, extend_suffix=trained.extend_suffix,
                    seed=args.seed, replace_extended=trained.replace_extended)
    m = ds.num_unique_images
    steps = len(ds.triplets) // TRAIN_BATCH
    extract_batches = math.ceil(m / TRAIN_BATCH)
    gallery_batches = math.ceil(n_gallery / 32)
    query_batches = math.ceil(N_VAL / 32)
    assert [len(losses) for _, losses in runs] == [steps, steps] and steps >= 4
    layers_v, layers_t = cfg.vision_layers, cfg.transformer_layers
    want = dict(
        long_attention=layers_v * (extract_batches + 2 * gallery_batches),
        long_attention_bwd=0,
        short_attention=2 * layers_t * (steps + query_batches),
        short_attention_bwd=2 * layers_t * steps,
        bank_infonce_fwd=steps, bank_infonce_bwd=steps,
        bank_infonce_q8_fwd=steps, bank_infonce_q8_bwd=steps,
        max_query_infonce_fwd=0, max_query_infonce_bwd=0, **NO_LLAMA)
    phase(f"tgcir training slice (train_main, ViT-B/16 bf16, batch "
          f"{TRAIN_BATCH}): bank of {m} images in {extract_batches} encode "
          f"batches, {steps} steps over a float32 bank, then {steps} over the "
          f"same bank cache quantized to int8, a validation over "
          f"{n_gallery} images after each, {train_s:.1f} s in "
          f"all; launches {launches} (want 12 short-attention forwards + 12 "
          f"backwards + 1 + 1 bank launches (#5/#6, then #7/#8) per step, 12 "
          f"long-attention forwards per encode batch of extraction and "
          f"validation, 12 short ones per query batch: {want})")
    assert launches == want, (launches, want)
    assert os.path.exists(bank_file)

    moved = 0
    for (name, before), after in zip(fresh.model.state_dict().items(),
                                     trained.model.state_dict().values()):
        if tgcir_frozen(name):
            assert torch.equal(before, after), f"frozen {name} changed"
        elif not torch.equal(before, after):
            moved += 1
    n_train = sum(1 for n in fresh.model.state_dict() if not tgcir_frozen(n))
    assert moved == n_train, (moved, n_train)

    bank = Bank.load(bank_file, device=trained.device)
    assert bank.target.shape == (m, 512) and bank.refer.shape == (m, 12, 512)
    raw = next(iter_train_bank(ds, TRAIN_BATCH, epoch_seed=args.seed))
    dev = trained.device
    batch = (torch.from_numpy(bank.gather_refer(raw)).to(dev),
             torch.from_numpy(trained.tokenize(raw["captions"])).to(dev),
             bank.target, torch.from_numpy(raw["target_image_id"]).to(dev))
    with torch.no_grad():
        before = fresh.stage2_loss(*batch).item()
        after = trained.stage2_loss(*batch).item()
    losses = runs[0][1]
    phase(f"tgcir training slice: per-step losses float32 bank "
          f"{[round(x, 4) for x in losses]}, int8 bank "
          f"{[round(x, 4) for x in runs[1][1]]}; first batch before "
          f"training {before:.4f} (logged {losses[0]:.4f}), after {steps} "
          f"steps {after:.4f}; best scores {runs[0][0]:.2f} / "
          f"{runs[1][0]:.2f}; {moved} tensors of the text branch moved, the "
          f"image branch (clip.visual, fc, tokenlearn, masks) and "
          f"logit_scale bit-identical [{card}]")
    assert abs(before - losses[0]) < 1e-3 * abs(before), (before, losses[0])
    assert after < before, (after, before)
    del fresh, bank

    ckpt_argv = argv + ["--model_path", os.path.join(out, "best.pt")]
    count = zero_counts(ak, bk)
    with contextlib.redirect_stdout(io.StringIO()):
        results = validate.validate_main("tgcir", ckpt_argv)
    assert all(math.isfinite(v) and 0.0 <= v <= 100.0
               for v in results.values()), results
    assert results["recall_at50"] > 0.0, results
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            paths = submission.submission_main(
                "tgcir", ckpt_argv + ["--submission-name", "smoke"])
        docs = []
        for path in paths:
            with open(path) as fh:
                docs.append(json.load(fh))
    finally:
        os.chdir(cwd)
    eval_launches = read_counts(count)
    pred, group = docs
    assert len(pred) - 2 == len(group) - 2 == N_VAL
    for pid in pred:
        if pid not in ("version", "metric"):
            assert len(pred[pid]) == min(50, n_gallery - 1), pid
            assert len(group[pid]) == 3, pid
    want = dict(long_attention=2 * layers_v * gallery_batches,
                long_attention_bwd=0,
                short_attention=2 * layers_t * query_batches,
                short_attention_bwd=0, **bank_launches(False, 0))
    phase(f"tgcir validate_main on best.pt {json.dumps(results)}; "
          f"submission_main wrote {[os.path.basename(p) for p in paths]}; "
          f"launches {eval_launches} (want {want})")
    assert eval_launches == want, (eval_launches, want)
    return launches, eval_launches


def drive_negtype(ak, bk, root, tmp, card, n_gallery):
    """Phase 13a: `cli.train_negtype` (clip4cir stage 1, `--wo_bank
    --neg_type 15`) with ViT-B/32 bf16 at batch 256 for an epoch of the
    tree, then the checks. Returns the launch counts of the run."""
    from spn4cir_tpu_torch.cli import train_negtype
    from spn4cir_tpu_torch.data.datasets import CIRDataset
    from spn4cir_tpu_torch.data.transforms import ImageTransform

    argv = ["--dataset", "cirr", "--data_path", root, "--clip-model-name",
            NEGTYPE_MODEL, "--bf16", "--seed", "0", "--batch-size",
            str(TRAIN_BATCH), "--num-epochs", "1",
            "--output_path", os.path.join(tmp, "negtype_run")]
    count = zero_counts(ak, bk)
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        best = train_negtype.main(argv, log_every=1)
    launches = read_counts(count)
    run_s = time.perf_counter() - t0
    text = tee.buffer_.getvalue()
    losses = logged_losses(text)
    assert "neg_type : 15" in text and "wo_bank : True" in text
    ds = CIRDataset("cirr", "train", "relative",
                    ImageTransform("targetpad", 224), root)
    steps = len(ds.triplets) // TRAIN_BATCH
    gallery_batches = math.ceil(n_gallery / 32)
    query_batches = math.ceil(N_VAL / 32)
    assert len(losses) == steps >= 3, (len(losses), steps)
    # two vision calls and one text call a step, 12 layers each (ViT-B/32:
    # S=50; text: S=77, causal)
    want = dict(short_attention=36 * steps + 12 * (gallery_batches
                                                   + query_batches),
                short_attention_bwd=36 * steps, **NO_LONG,
                **bank_launches(False, 0))
    phase(f"negtype slice (cli.train_negtype, {NEGTYPE_MODEL} bf16, batch "
          f"{TRAIN_BATCH}, --wo_bank --neg_type 15; the recipe's RN50x4 cut "
          f"to ViT-B/32): {steps} steps and a validation over "
          f"{n_gallery} images in {run_s:.1f} s; per-step losses "
          f"{[round(x, 4) for x in losses]}; best score {best:.2f}; launches "
          f"{launches} (want 24 + 12 short-attention forwards and backwards "
          f"per step, two vision calls and one text call, 12 forwards per "
          f"validation batch, no bank kernel: {want}) [{card}]")
    assert launches == want, (launches, want)
    return launches


def drive_zs_stage1(ak, bk, tmp, card):
    """Phase 13b: `cli.train_zs` (zscir stage 1, `--wo_bank`) at full
    ViT-L/14 width, batch 48, on a tree whose generated triplets
    (`cap.rc2.train.extend_zs.json`) replace the human ones; then the step
    on one resident batch: ms/step, a profiler window, the launches a
    step. Returns the launch counts of the CLI run."""
    from torch.profiler import ProfilerActivity, profile

    from spn4cir_tpu_torch.cli import train_zs
    from spn4cir_tpu_torch.data.datasets import CIRDataset
    from spn4cir_tpu_torch.data.transforms import ImageTransform
    from spn4cir_tpu_torch.models.api import build_backbone
    from spn4cir_tpu_torch.train.stage1 import (create_stage1_state,
                                                stage1_train_step)

    make_cirr = load_test_module("fixtures").make_cirr
    root = make_cirr(os.path.join(tmp, "cirr_zs"), n_images=ZS_IMAGES,
                     n_train=ZS_TRAIN, n_val=N_VAL, extended=True,
                     extend_suffix="zs")
    ds = CIRDataset("cirr", "train", "relative",
                    ImageTransform("targetpad", 224), root, extend_suffix="zs",
                    replace_extended=True)
    assert all(t["captions"][0].startswith("ext cirr") for t in ds.triplets)
    argv = ["--dataset", "cirr", "--data_path", root, "--bf16", "--seed", "0",
            "--batch-size", str(ZS_BATCH), "--num-epochs", "1",
            "--output_path", os.path.join(tmp, "zs_run")]
    count = zero_counts(ak, bk)
    torch.cuda.reset_peak_memory_stats()
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        best = train_zs.main(argv, log_every=1)
    launches = read_counts(count)
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    text = tee.buffer_.getvalue()
    losses = logged_losses(text)
    assert "clip_model_name : ViT-L/14" in text and "batch_size : 48" in text
    steps = len(ds.triplets) // ZS_BATCH
    gallery_batches = math.ceil(ZS_IMAGES / 32)
    query_batches = math.ceil(N_VAL / 32)
    assert len(losses) == steps >= 3, (len(losses), steps)
    # refer and target ride one 2B-batch tower call: 24 layers at S=257
    want = dict(long_attention=24 * (steps + gallery_batches),
                long_attention_bwd=24 * steps,
                short_attention=12 * (steps + query_batches),
                short_attention_bwd=12 * steps, **bank_launches(False, 0))
    phase(f"zs stage-1 slice (cli.train_zs, ViT-L/14 bf16 at 224, batch "
          f"{ZS_BATCH}, every weight training): {steps} steps and a "
          f"validation over {ZS_IMAGES} images in {run_s:.1f} s, peak "
          f"device memory {peak_gb:.2f} GiB; per-step losses "
          f"{[round(x, 4) for x in losses]}; best score {best:.2f}; launches "
          f"{launches} (want 24 long-attention forwards + 24 backwards at "
          f"(1536, 257, 64) and 12 + 12 short ones per step, 24 long "
          f"forwards per gallery batch, 12 short per query batch: {want}) "
          f"[{card}]")
    assert launches == want, (launches, want)

    # the step on one resident batch (no image decode)
    device = torch.device("cuda:0")
    backbone = build_backbone("zs", clip_model_name="ViT-L/14", tau=0.01,
                              dtype=torch.bfloat16, device=device)
    backbone.init_params(torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in backbone.parameters())
    state = create_stage1_state(backbone, 2e-6)
    g = torch.Generator(device=device).manual_seed(16)
    batch = {
        "refer_images": torch.randn(ZS_BATCH, 224, 224, 3, generator=g,
                                    device=device),
        "target_images": torch.randn(ZS_BATCH, 224, 224, 3, generator=g,
                                     device=device),
        "text_ids": torch.from_numpy(backbone.tokenize(
            [CAPTIONS[i % len(CAPTIONS)] for i in range(ZS_BATCH)])
        ).to(device)}
    backbone.train()
    stage1_train_step(backbone, state, batch)                    # warm-up
    count = zero_counts(ak, bk)
    step_ms = median_ms(lambda: stage1_train_step(backbone, state, batch),
                        reps=4, warmup=0)
    per_step = {k: v / 4 for k, v in read_counts(count).items() if v}
    assert per_step == dict(long_attention=24, long_attention_bwd=24,
                            short_attention=12, short_attention_bwd=12), \
        per_step
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        for n in (1, 2):    # the first window takes the profiler's start-up
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    stage1_train_step(backbone, state, batch)
                torch.cuda.synchronize()
        trace = os.path.join(trace_dir, "zs_stage1_trace.json")
        prof.export_chrome_trace(trace)
        busy_ms, n_ops, groups = device_busy(trace)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    assert n_ops > 0, "the profiler's trace holds no device interval"
    per = {k: round(v / 2, 3) for k, v in
           sorted(groups.items(), key=lambda kv: -kv[1])}
    assert per.get("attention kernels", 0) > 0, per
    stats = dict(ms_per_step=step_ms, busy_ms_per_step=busy_ms / 2,
                 idle_share=1 - busy_ms / 2 / step_ms,
                 device_ops_per_step=n_ops / 2, launches_per_step=per_step,
                 parameters=n_params, ms_per_step_by_group=per)
    phase(f"zs stage-1 step, ViT-L/14 bf16 ({n_params / 1e6:.1f} M "
          f"parameters, all training), batch {ZS_BATCH}, one resident batch: "
          f"{step_ms:.3f} ms/step (median of 4, CUDA events); device busy "
          f"{busy_ms / 2:.3f} ms/step in {n_ops / 2:.0f} device operations, "
          f"idle share {100 * stats['idle_share']:.1f}%; launches a step "
          f"{per_step}; device ms per step by group: {per} [{card}]")
    phase("zs stage-1 stats " + json.dumps(stats))
    del state, backbone
    torch.cuda.empty_cache()
    return launches


class CallClock:
    """Wraps methods of an object (or module) with CUDA events and the host
    clock around every call: {name: [device ms of each call]}."""

    def __init__(self, owner, names):
        self.owner, self.names, self.saved, self.calls = owner, names, {}, {}

    def __enter__(self):
        for name in self.names:
            self.saved[name] = getattr(self.owner, name)
            setattr(self.owner, name, self._wrap(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.owner, name, fn)

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.calls.setdefault(name, []).append((start, end))
            return out
        return wrapper

    def ms(self, name):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.calls.get(name, [])]


def llava_launches(groups: int, tower_batches: int) -> dict:
    """The counts of a LLaVA captioning run: #3 in the tower's 23 blocks per
    image batch, #11 in the LM's 32 layers per decode step, nothing else."""
    return dict(llama_launches(32 * (LLAVA_NEW - 1) * groups),
                long_attention=LLAVA_TOWER_LAYERS * tower_batches)


def llava_replay(tl, tv, cap, images, tokens, plain):
    """Every generate step's float32 logits (LLAVA_NEW, B, vocab) of the
    LLaVA path teacher-forced with `tokens` (B, LLAVA_NEW): the tower
    through #3 and the decode attention through #11, or both plain."""
    from spn4cir_tpu_torch.models.layers import set_attention_impl

    cfg = cap.cfg.llama
    model = cap.model
    set_attention_impl(model, "plain" if plain else "auto")
    try:
        feats = model.encode_images(images)
    finally:
        set_attention_impl(model, "auto")
    embeds = tv.splice_image_embeds(model.model.embed_tokens.weight,
                                    cap.prompt_ids(LLAVA_PROMPT), feats)
    b, plen, _ = embeds.shape
    state = tl.init_llama_state(cfg, b, plen + LLAVA_NEW,
                                dtype=torch.bfloat16, device=embeds.device)
    logits, state = tl.llama_prefill(model, cfg, state, embeds)
    out = [logits.float()]
    for i in range(1, LLAVA_NEW):
        x = tl.embed_tokens(model, tokens[:, i - 1])
        logits, state = tl.llama_decode_step(model, cfg, state, x,
                                             plen + i - 1,
                                             attn_kernel=not plain)
        out.append(logits.float())
    return torch.stack(out)


def check_llava_streams(tl, tv, cap, images, card):
    """Phase 14, outside the count: the first group's 64-token streams with
    the tower through #3 and the decode through #11, against the plain
    versions of both (plain attention in the tower, `attn_kernel=False`).
    Where two streams part, the routes' bf16 logits may differ: the plain
    stream's top-2 margin at that step must be within twice the two routes'
    largest logit difference at that step (one teacher-forced replay of
    each route over the plain stream's tokens), and that difference within
    LLAVA_LOGIT_TOL."""
    from spn4cir_tpu_torch.models.layers import set_attention_impl

    cfg = cap.cfg.llama
    eos = cap.tok.eos_token_id
    streams = {}
    for plain in (False, True):
        set_attention_impl(cap.model, "plain" if plain else "auto")
        try:
            feats = cap.model.encode_images(images)
        finally:
            set_attention_impl(cap.model, "auto")
        embeds = tv.splice_image_embeds(cap.model.model.embed_tokens.weight,
                                        cap.prompt_ids(LLAVA_PROMPT), feats)
        streams[plain] = tl.llama_generate(
            cap.model, cfg, embeds, eos_id=eos, pad_id=eos,
            max_new_tokens=LLAVA_NEW, do_sample=True, temperature=0.01,
            top_p=0.01, cache_dtype=torch.bfloat16,
            attn_kernel=not plain,
            generator=torch.Generator(device=images.device).manual_seed(0))
    kern, plain = streams[False], streams[True]
    lp = llava_replay(tl, tv, cap, images, plain, True)
    lk = llava_replay(tl, tv, cap, images, plain, False)
    diff = (lk - lp).abs().amax(dim=-1)             # (steps, B)
    parted = []
    for r in range(kern.shape[0]):
        where = (kern[r] != plain[r]).nonzero()
        if not len(where):
            continue
        t = int(where[0])
        # past an EOS both streams are padding: the part must come earlier
        top = lp[t, r].topk(2).values
        margin = (top[0] - top[1]).item()
        d = diff[t, r].item()
        parted.append(dict(row=r, step=t, margin=margin, logit_diff=d))
        assert margin <= 2 * d, ("parted above the noise", parted)
    noise = diff.max().item()
    phase(f"LLaVA streams, 7B bf16 at full width, the first group "
          f"(B={kern.shape[0]}, {LLAVA_NEW} tokens): the tower through #3 "
          f"and the decode through #11 against plain attention in both: "
          f"{kern.shape[0] - len(parted)} of {kern.shape[0]} streams "
          f"identical; largest logit difference between the routes over "
          f"the plain streams {noise:.4f} (tolerance {LLAVA_LOGIT_TOL}), at "
          f"the prefill {diff[0].max().item():.4f}"
          f"{'; parted ' + str(parted) if parted else ''} [{card}]")
    assert noise <= LLAVA_LOGIT_TOL, noise
    return dict(parted=parted, max_logit_diff=noise)


def drive_llava(ak, bk, world, tmp, card):
    """Phase 14a: LLaVA-v1-7B at full width through
    `datagen.captioner.make_llava_captioner` (byte tokenizer, random bf16
    weights from seed 0 on the card), `caption_images_batched` with a
    jsonl sidecar and `write_it_list`, over the 32 images of the rewrite
    tree in 2 groups of 16, counted from zero; then the sidecar resume
    (the second group torn off and captioned again, counted from zero: the
    same captions), a profiler window over decode steps, and the streams
    against the plain versions. Returns (launches of the first run, the
    it-list path, the captioner, its transform, its batched_fn)."""
    import numpy as np
    from PIL import Image

    from spn4cir_tpu_torch.datagen import captioner as dc
    from spn4cir_tpu_torch.models import llama as tl
    from spn4cir_tpu_torch.models import llava as tv
    from spn4cir_tpu_torch.tokenizer.bytelevel import ByteTokenizer

    root, ds, _, _ = world
    device = torch.device("cuda:0")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cap, transform, batched_fn = dc.make_llava_captioner(
        None, tokenizer=ByteTokenizer(), batch_size=LLAVA_BATCH)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = cap.cfg
    assert (cfg.llama.hidden_size, cfg.llama.num_layers, cfg.vision.width,
            cfg.vision.effective_layers) == (4096, 32, 1024, 23), cfg
    n_params = sum(p.numel() for p in cap.model.parameters())
    ids = cap.prompt_ids(LLAVA_PROMPT)
    assert len(ids) - 1 == LLAVA_PROMPT_IDS, len(ids)
    plen = LLAVA_PROMPT_IDS + cfg.vision.num_patches
    pairs = list(zip(ds.imagenames, ds.imagepaths))
    assert len(pairs) == LLAVA_IMAGES, len(pairs)

    def images(subset):
        for name, path in subset:
            yield name, transform(Image.open(path))

    sidecar = os.path.join(tmp, "llava_it.partial.jsonl")
    groups = LLAVA_IMAGES // LLAVA_BATCH
    count = zero_counts(ak, bk)
    t0 = time.perf_counter()
    with StepClock(tl) as clock, CallClock(cap.model,
                                           ["encode_images"]) as tower:
        it_list = dc.caption_images_batched(
            images(pairs), batched_fn, batch_size=LLAVA_BATCH,
            checkpoint_path=sidecar)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(count)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    want = llava_launches(groups, groups)
    assert launches == want, (launches, want)
    out_root = os.path.join(tmp, "mm_data")
    path = dc.write_it_list(it_list, "cirr", "llava", 10, out_root=out_root)
    with open(path) as fh:
        written = json.load(fh)
    assert [e["image_id"] for e in written] == [n for n, _ in pairs]
    assert all(isinstance(e["caption"], str) for e in written)
    per = clock.groups()
    assert len(per) == groups and all(g["steps"] == LLAVA_NEW - 1
                                      for g in per), per
    tower_ms = tower.ms("encode_images")
    step_ms = statistics.mean(g["step_ms"] for g in per)

    # the sidecar resume: keep the first group and a torn line, caption the
    # rest again
    with open(sidecar) as fh:
        lines = fh.read().splitlines()
    assert len(lines) == LLAVA_IMAGES, len(lines)
    with open(sidecar, "w") as fh:
        fh.write("\n".join(lines[:LLAVA_BATCH]) + "\n" + lines[-1][:20])
    done = dc.load_caption_checkpoint(sidecar)
    assert len(done) == LLAVA_BATCH, len(done)
    count = zero_counts(ak, bk)
    resumed = dc.caption_images_batched(
        images([p for p in pairs if p[0] not in done]), batched_fn,
        batch_size=LLAVA_BATCH, checkpoint_path=sidecar, already=done)
    resumed_launches = read_counts(count)
    assert resumed_launches == llava_launches(1, 1), resumed_launches
    assert sorted(resumed, key=lambda e: e["image_id"]) == sorted(
        written, key=lambda e: e["image_id"]), "the resume captioned anew"
    assert len(dc.load_caption_checkpoint(sidecar)) == LLAVA_IMAGES

    # outside the count: a profiler window over decode steps of the first
    # group, and the streams against the plain versions
    batch = torch.from_numpy(np.stack(
        [transform(Image.open(p)) for _, p in pairs[:LLAVA_BATCH]])).to(device)
    with torch.inference_mode():
        feats = cap.model.encode_images(batch)
        embeds = tv.splice_image_embeds(cap.model.model.embed_tokens.weight,
                                        ids, feats)
        state = tl.init_llama_state(cfg.llama, LLAVA_BATCH, LLAVA_LEN,
                                    dtype=torch.bfloat16, device=device)
        tl.llama_prefill(cap.model, cfg.llama, state, embeds)
        x = tl.embed_tokens(cap.model, torch.full(
            (LLAVA_BATCH,), cap.tok.eos_token_id, device=device))
        prof = profile_decode(tl, cap.model, cfg.llama, state,
                              (x, plen, None, None), False, tmp, "llava")
        del state, feats, embeds
        torch.cuda.empty_cache()
        streams = check_llava_streams(tl, tv, cap, batch, card)
    stats = dict(
        build_s=build_s, parameters=n_params, wall_s=wall,
        captions_per_s=LLAVA_IMAGES / wall, tower_ms_per_batch=tower_ms,
        prefill_ms=[g["prefill_ms"] for g in per],
        decode_ms_per_step=step_ms,
        decode_host_ms_per_step=statistics.mean(
            g["step_host_ms"] for g in per),
        peak_gb=peak_gb, profile=prof, streams=streams,
        launches=launches, resumed_launches=resumed_launches)
    phase(step_line(f"LLaVA-7B bf16, bf16 cache, B={LLAVA_BATCH}, "
                    f"{LLAVA_LEN}-row cache", prof) + f" [{card}]")
    phase(f"llava slice: make_llava_captioner built LLaVA-v1-7B ({n_params} "
          f"parameters, random bf16 LM, float32 tower) in {build_s:.2f} s; "
          f"caption_images_batched captioned {LLAVA_IMAGES} images (B="
          f"{LLAVA_BATCH}, {groups} groups, {plen}-row prompts = "
          f"{LLAVA_PROMPT_IDS} ids + {cfg.vision.num_patches} patches, "
          f"{LLAVA_NEW} new tokens) in {wall:.2f} s = "
          f"{stats['captions_per_s']:.2f} captions/s; tower "
          f"{[round(t, 3) for t in tower_ms]} ms per batch; prefill "
          f"{[round(g['prefill_ms'], 1) for g in per]} ms per group; decode "
          f"{step_ms:.3f} ms/step by CUDA events (host clock "
          f"{stats['decode_host_ms_per_step']:.3f}); peak device memory "
          f"{peak_gb:.2f} GiB; launches {launches} (want {want}); "
          f"write_it_list wrote {os.path.relpath(path, tmp)}; the sidecar "
          f"resume (16 kept, a torn line, 16 captioned again) launched "
          f"{resumed_launches['long_attention']} #3 and "
          f"{resumed_launches['decode_attention']} #11 and gave the same "
          f"captions [{card}]")
    phase("llava slice stats " + json.dumps(stats))
    return launches, path, cap, transform, batched_fn


def drive_llava_service(ak, bk, cap, transform, batched_fn, card):
    """Phase 14c: LLaVA's batched_fn behind a `CaptionService`: 8
    concurrent requests of one image each, half with a per-request prompt,
    counted from zero. Every reply is a string; the requests coalesce into
    one captioner call per prompt and window."""
    import numpy as np
    from PIL import Image

    from spn4cir_tpu_torch.serve.mllm import CaptionService

    # the service's worker thread keeps its batched_fn for good: hand it one
    # that lets the 7B go when this phase ends
    holder = {"fn": batched_fn}
    svc = CaptionService(
        lambda images, prompt=None: holder["fn"](images, prompt=prompt),
        transform, model_name="llava", max_batch=LLAVA_BATCH,
        max_delay_s=0.2, default_prompt=None)
    rng = np.random.RandomState(3)
    imgs = [Image.fromarray((rng.rand(224, 224, 3) * 255).astype(np.uint8))
            for _ in range(8)]
    prompts = [None, "what color is the item"] * 4
    count = zero_counts(ak, bk)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(lambda ip: svc.caption([ip[0]], ip[1]),
                             zip(imgs, prompts)))
    wall = time.perf_counter() - t0
    launches = read_counts(count)
    assert all(len(o) == 1 and isinstance(o[0], str) for o in outs), outs
    holder.clear()
    m = svc.metrics()
    assert m["requests"] == 8 and m["images"] == 8, m
    assert m["batches_dispatched"] < 8, m
    n = m["batches_dispatched"]
    assert launches == llava_launches(n, n), (launches, n)
    phase(f"llava service: 8 concurrent requests (two prompts) through "
          f"CaptionService in {wall:.2f} s, {n} captioner calls; /metrics "
          f"{json.dumps(m)}; launches {launches} [{card}]")
    return launches


def drive_blip_caption(ak, bk, tmp, card):
    """Phase 15: BLIP caption base at full width through `python -m
    spn4cir_tpu_torch.cli.captioner --mllm blip` (its main()) over a
    64-image synthetic CIRR tree, batch 32, beam 3, counted from zero: 12
    launches of #3 per batch of the ViT at 384 (S=577), the MED decoder's
    attention plain tensor code; then again (the resume loads no model),
    and once with --nucleus; then `cli.serve_mllm --mllm blip --no-block`
    with concurrent /caption requests. Returns (the captioner launches, the
    serving launches)."""
    import base64

    import numpy as np

    from PIL import Image

    from spn4cir_tpu_torch.cli import captioner as cli_captioner
    from spn4cir_tpu_torch.cli import serve_mllm
    from spn4cir_tpu_torch.models.blip_caption import BlipCaptioner

    root = load_test_module("fixtures").make_cirr(
        os.path.join(tmp, "cirr_caption"), n_images=BLIP_CAPTION_IMAGES,
        n_train=8 * BLIP_CAPTION_IMAGES, n_val=8, extended=False)
    vocab = os.environ["SPN4CIR_BERT_VOCAB"]
    argv = ["--mllm", "blip", "--blip_size", "base", "--bert_vocab", vocab,
            "--cir_data", "cirr", "--data_path", root, "--batch_size",
            str(BLIP_CAPTION_BATCH)]
    from spn4cir_tpu_torch.models.blip_vit import BlipViTConfig

    vit_layers = BlipViTConfig.base().layers
    batches = BLIP_CAPTION_IMAGES // BLIP_CAPTION_BATCH
    want = dict(short_attention=0, short_attention_bwd=0,
                long_attention=vit_layers * batches, long_attention_bwd=0,
                **bank_launches(False, 0))
    cwd = os.getcwd()
    work = os.path.join(tmp, "caption_cwd")
    os.makedirs(work, exist_ok=True)
    os.chdir(work)      # the it-list lands under the working directory
    stats = {}
    try:
        for label, extra in (("beam 3", []), ("resume", []),
                             ("nucleus", ["--nucleus", "--caption_ckpt",
                                          ""])):
            count = zero_counts(ak, bk)
            loads = []
            real = cli_captioner.make_blip_captioner

            def counted(*a, **k):
                loads.append(1)
                return real(*a, **k)

            cli_captioner.make_blip_captioner = counted
            t0 = time.perf_counter()
            try:
                with CallClock(BlipCaptioner, ["encode", "generate_ids"]) \
                        as clock, contextlib.redirect_stdout(io.StringIO()):
                    path = cli_captioner.main(argv + extra)
                    torch.cuda.synchronize()
            finally:
                cli_captioner.make_blip_captioner = real
            wall = time.perf_counter() - t0
            launches = read_counts(count)
            with open(path) as fh:
                written = json.load(fh)
            assert len(written) == BLIP_CAPTION_IMAGES, len(written)
            assert all(isinstance(e["caption"], str) for e in written)
            if label == "resume":
                assert loads == [] and launches == dict(
                    want, long_attention=0), (loads, launches)
            else:
                assert loads == [1] and launches == want, (loads, launches)
            enc, gen = clock.ms("encode"), clock.ms("generate_ids")
            stats[label] = dict(wall_s=wall, launches=launches,
                                encode_ms=enc, generate_ms=gen,
                                captions_per_s=BLIP_CAPTION_IMAGES / wall)
            phase(f"blip caption slice, cli.captioner {label}: wrote "
                  f"{len(written)} captions to {os.path.relpath(path, work)} "
                  f"in {wall:.2f} s ({BLIP_CAPTION_IMAGES / wall:.2f} "
                  f"captions/s; model loads {len(loads)}); ViT encode "
                  f"{[round(t, 3) for t in enc]} ms, generation "
                  f"{[round(t, 1) for t in gen]} ms per batch of "
                  f"{BLIP_CAPTION_BATCH}; launches {launches}; e.g. "
                  f"{written[0]['caption'][:60]!r} [{card}]")
        first = stats["beam 3"]["launches"]
    finally:
        os.chdir(cwd)

    # the caption service through its entry point
    rng = np.random.RandomState(5)
    blobs = []
    for _ in range(BLIP_SERVE_REQUESTS):
        buf = io.BytesIO()
        Image.fromarray((rng.rand(96, 128, 3) * 255).astype(np.uint8)).save(
            buf, format="PNG")
        blobs.append(base64.b64encode(buf.getvalue()).decode())
    with contextlib.redirect_stdout(io.StringIO()):
        server, service = serve_mllm.main([
            "--mllm", "blip", "--blip_size", "base", "--bert_vocab", vocab,
            "--batch_size", "16", "--max_delay_ms", "100", "--port", "0",
            "--host", "127.0.0.1", "--no-block"])
    port = server.server_address[1]

    def ask(i):
        body = ({"image_b64": blobs[i]} if i % 2 else
                {"images_b64": [blobs[i], blobs[i - 1]]})
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/caption", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        return out, (time.perf_counter() - t0) * 1e3

    try:
        count = zero_counts(ak, bk)
        with CallClock(BlipCaptioner, ["encode"]) as clock, \
                concurrent.futures.ThreadPoolExecutor(
                    BLIP_SERVE_REQUESTS) as pool:
            outs = list(pool.map(ask, range(BLIP_SERVE_REQUESTS)))
        serve_launches = read_counts(count)
        # a coalesced call may pass the cap by a request's images; the
        # captioner then runs two device batches
        device_batches = len(clock.ms("encode"))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as r:
            metrics = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
    caps = []
    for i, (out, _) in enumerate(outs):
        got = [out["caption"]] if i % 2 else out["captions"]
        assert len(got) == (1 if i % 2 else 2), out
        caps.extend(got)
    assert all(isinstance(c, str) and c for c in caps), caps
    n_images = len(caps)
    assert health == {"status": "ok", "model": "blip"}, health
    assert metrics["requests"] == BLIP_SERVE_REQUESTS, metrics
    assert metrics["images"] == n_images, metrics
    assert metrics["batches_dispatched"] < BLIP_SERVE_REQUESTS, metrics
    assert serve_launches == dict(
        want, long_attention=vit_layers * device_batches), (
        serve_launches, metrics, device_batches)
    ms = [m for _, m in outs]
    phase(f"blip caption service: {BLIP_SERVE_REQUESTS} concurrent "
          f"/caption requests ({n_images} images) through cli.serve_mllm: "
          f"every reply a non-empty string, client p50 {pct(ms, 0.5):.1f} ms,"
          f" max {max(ms):.1f} ms; /metrics {json.dumps(metrics)}; "
          f"{device_batches} device batches of 16; launches "
          f"{serve_launches} [{card}]")
    phase("blip caption slice stats " + json.dumps(stats))
    return first, serve_launches


def drive_cases(ak, bk, argv, tmp, card):
    """Phase 6b: `cli.validate_case` on the flagship RN50x4 checkpoint and
    on random weights of the same recipe, then `cli.analysis_case` over the
    two dumps, counted from zero: #1 in the text tower's layers (12) per
    query batch of 32, nothing else."""
    from spn4cir_tpu_torch.cli import analysis_case
    from spn4cir_tpu_torch.cli.validate_case import validate_case_main

    from spn4cir_tpu_torch.models.clip import CLIP_CONFIGS

    ckpt = os.path.join(argv[argv.index("--output_path") + 1], "best.pt")
    text_layers = CLIP_CONFIGS[argv[argv.index("--clip-model-name") + 1]
                               ].transformer_layers
    outs = {}
    count = zero_counts(ak, bk)
    for label, extra in (("best", ["--model_path", ckpt]), ("random", [])):
        out = os.path.join(tmp, "cases", f"{label}.json")
        with contextlib.redirect_stdout(io.StringIO()):
            (summary,) = validate_case_main(
                "clip", argv + extra + ["--cases_out", out])
        with open(out) as fh:
            cases = json.load(fh)
        assert len(cases) == summary["queries"] > 0, summary
        assert all(len(c["topk"]) == 10 and c["reference_name"] not in
                   c["topk"] and 0 <= c["rank"] for c in cases)
        outs[label] = (out, summary)
    launches = read_counts(count)
    want = dict(short_attention=text_layers * 2 * math.ceil(
                    outs["best"][1]["queries"] / 32),
                short_attention_bwd=0, **NO_LONG, **bank_launches(True, 0))
    assert launches == want, (launches, want)
    with contextlib.redirect_stdout(io.StringIO()):
        wins = analysis_case.main(["--cases_a", outs["random"][0],
                                   "--cases_b", outs["best"][0]])
    phase(f"cases slice: cli.validate_case on best.pt "
          f"{json.dumps(outs['best'][1])} and on random weights "
          f"{json.dumps(outs['random'][1])}; cli.analysis_case: {len(wins)} "
          f"queries where the random model misses the top 10 and best.pt "
          f"ranks the target first; launches {launches} [{card}]")
    return launches


def drive_retrieval(ak, bk, tmp, card):
    """Phase 16: `python -m spn4cir_tpu_torch.cli.retrieval` (its main())
    with ViT-L/14 at full width (random weights from seed 0, float32) over
    the 64 images of the caption tree: i2i of the gallery against itself,
    then t2i for 4 captions, each counted from zero: #3 in the 24 vision
    layers per batch of 32, #1 in the 12 text layers."""
    from spn4cir_tpu_torch.cli import retrieval as cli_retrieval
    from spn4cir_tpu_torch.models.clip import CLIP_CONFIGS

    cfg = CLIP_CONFIGS["ViT-L/14"]
    gallery = os.path.join(tmp, "cirr_caption", "dev")
    n = len(os.listdir(gallery))
    batches = math.ceil(n / 32)
    common = ["--gallery", gallery, "--topk", "5"]
    count = zero_counts(ak, bk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        top = cli_retrieval.main(common + ["--out_dir",
                                           os.path.join(tmp, "ret_i2i")])
    i2i_s = time.perf_counter() - t0
    i2i = read_counts(count)
    assert top.shape == (n, 5) and all(i not in top[i] for i in range(n))
    count = zero_counts(ak, bk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        top_t = cli_retrieval.main(common + [
            "--text", ",".join(CAPTIONS), "--out_dir",
            os.path.join(tmp, "ret_t2i")])
    t2i_s = time.perf_counter() - t0
    t2i = read_counts(count)
    assert top_t.shape == (len(CAPTIONS), 5)
    assert len(os.listdir(os.path.join(tmp, "ret_i2i"))) == n
    base = dict(short_attention_bwd=0, long_attention_bwd=0,
                **bank_launches(False, 0))
    assert i2i == dict(base, short_attention=0,
                       long_attention=cfg.vision_layers * batches), i2i
    assert t2i == dict(base, short_attention=cfg.transformer_layers,
                       long_attention=cfg.vision_layers * batches), t2i
    phase(f"retrieval slice: cli.retrieval ViT-L/14 float32 i2i over {n} "
          f"images in {i2i_s:.2f} s (launches {i2i}), t2i for "
          f"{len(CAPTIONS)} captions in {t2i_s:.2f} s (launches {t2i}); "
          f"t2i top-5 of the first caption {top_t[0].tolist()} [{card}]")
    return {k: i2i[k] + t2i[k] for k in i2i}


def drive_dedup(tmp, card):
    """Phase 17a: `cli.deduplicate_images` over a 1,024-image synthetic CIRR
    tree in which SRM_PLANTED images are pixel-identical re-saves (another
    PNG compression level) of others under their own names: every planted
    pair that the train set holds must come out as a group, and
    `CIRDataset` must read the map (one id per group, the duplicates gone
    from the unique images). Returns the tree's root."""
    from PIL import Image

    from spn4cir_tpu_torch.cli import deduplicate_images
    from spn4cir_tpu_torch.data.datasets import CIRDataset

    make_cirr = load_test_module("fixtures").make_cirr
    root = make_cirr(os.path.join(tmp, "cirr_srm"), n_images=SRM_IMAGES,
                     n_train=SRM_TRAIN, n_val=N_VAL, extended=False)
    dev = os.path.join(root, "dev")
    for i in range(SRM_PLANTED):
        with Image.open(os.path.join(dev, f"cirr_img{i}.png")) as img:
            img.convert("RGB").save(
                os.path.join(dev, f"cirr_img{i + SRM_IMAGES // 2}.png"),
                compress_level=1)
    before = CIRDataset("cirr", "train", "relative", None, root)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        deduplicate_images.main(["--dataset", "cirr", "--data_path", root])
    dedup_s = time.perf_counter() - t0
    with open(os.path.join(root, "same_image_list.json")) as fh:
        groups = json.load(fh)
    present = set(before.imagenames)
    want = {frozenset((f"cirr_img{i}", f"cirr_img{i + SRM_IMAGES // 2}"))
            for i in range(SRM_PLANTED)}
    want = {g for g in want if g <= present}
    assert {frozenset(g) for g in groups} == want, (groups, want)
    after = CIRDataset("cirr", "train", "relative", None, root)
    assert after.num_unique_images == before.num_unique_images - len(want)
    for group in groups:
        assert len({after.imagename2id[n] for n in group}) == 1, group
    phase(f"dedup slice: cli.deduplicate_images hashed "
          f"{before.num_unique_images} train images in {dedup_s:.2f} s, "
          f"found the {len(groups)} planted pairs that the train set holds "
          f"(of {SRM_PLANTED}); CIRDataset reads "
          f"{after.num_unique_images} unique images [{card}]")
    return root


def write_random_srm(tmp, device):
    """Random Unicom ViT-L/14 and BGE-base weights written as the
    reference's files: Unicom as a half-precision DDP save (`module.`
    keys), BGE as an HF BertModel save with its pooler. Returns (the
    Unicom path, the BGE path, the float32 Unicom tower on the card)."""
    from spn4cir_tpu_torch.models.med import MedBert, MedConfig
    from spn4cir_tpu_torch.models.unicom import UnicomConfig, UnicomViT

    with torch.device(device):
        tower = UnicomViT(UnicomConfig.vit_l14())
    tower.init_weights(torch.Generator(device=device).manual_seed(0))
    unicom = os.path.join(tmp, "FP16-ViT-L-14-random.pt")
    torch.save({f"module.{k}": (v.half() if v.is_floating_point() else v)
                for k, v in tower.state_dict().items()}, unicom)
    bge = MedBert(MedConfig.bge_base())
    bge.init_weights(torch.Generator().manual_seed(0))
    sd = dict(bge.state_dict())
    sd["pooler.dense.weight"] = torch.zeros(768, 768)
    sd["pooler.dense.bias"] = torch.zeros(768)
    bge_path = os.path.join(tmp, "bge-base-en-random.pt")
    torch.save(sd, bge_path)
    return unicom, bge_path, tower.eval()


def drive_srm(ak, bk, root, tmp, card):
    """Phase 17b: `python -m spn4cir_tpu_torch.cli.srm_utils` through its
    main() at full width over 17a's tree: random Unicom ViT-L/14 and
    BGE-base read from files in the reference's layout (Unicom a
    half-precision DDP save), the synthetic 30,522-word vocabulary, CLIP
    ViT-L/14 in the cross-modal role, counted from zero: #3 in Unicom's 24
    blocks (float32, S = 256) and CLIP's 24 vision layers (S = 257) per
    batch of 32, #1 in CLIP's 12 text layers per 64 captions, BGE's masked
    attention plain. Then the Unicom encode on a resident batch: images/s by
    CUDA events, the device share of #3 and of the GEMMs from a profiled
    batch, and the batch's embeddings against the plain attention route.
    Returns (launch counts, sims path)."""
    import numpy as np

    from spn4cir_tpu_torch.cli import srm_utils
    from spn4cir_tpu_torch.data.datasets import CIRDataset, iter_unique_images
    from spn4cir_tpu_torch.data.transforms import ImageTransform
    from spn4cir_tpu_torch.datagen.srm import load_srm
    from spn4cir_tpu_torch.models.layers import set_attention_impl

    device = torch.device("cuda:0")
    t0 = time.perf_counter()
    unicom, bge, tower = write_random_srm(tmp, device)
    write_s = time.perf_counter() - t0
    out = os.path.join(tmp, "srm_out")
    os.makedirs(out, exist_ok=True)
    sims_path = os.path.join(out, "sims.npz")
    scores_path = os.path.join(out, "srm.npz")
    count = zero_counts(ak, bk)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        srm_utils.main(["--dataset", "cirr", "--data_path", root,
                        "--unicom_ckpt", unicom, "--bge_ckpt", bge,
                        "--batch_size", str(SRM_BATCH), "--k_negatives",
                        str(SRM_K), "--out", scores_path,
                        "--sims_out", sims_path])
    cli_s = time.perf_counter() - t0
    launches = read_counts(count)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    ds = CIRDataset("cirr", "train", "relative", None, root)
    m, n = ds.num_unique_images, len(ds.triplets)
    image_batches = math.ceil(m / SRM_BATCH)
    text_chunks = math.ceil(n / srm_utils.TEXT_CHUNK)
    want = dict(long_attention=(24 + 24) * image_batches,
                short_attention=12 * text_chunks, long_attention_bwd=0,
                short_attention_bwd=0, **bank_launches(False, 0))
    assert launches == want, (launches, want)
    sims, scores = dict(np.load(sims_path)), load_srm(scores_path)
    assert sims["i2i"].shape == (m, m) and sims["t2t"].shape == (n, n)
    assert sims["i2t"].shape == (m, n)
    assert np.allclose(np.diag(sims["i2i"]), 1.0, atol=1e-5)
    assert np.allclose(np.diag(sims["t2t"]), 1.0, atol=1e-5)
    refer = np.array([ds.imagename2id[t["reference_name"]]
                      for t in ds.triplets])
    assert scores["r_fn"].shape == (n, min(SRM_K, m))
    assert scores["m_fn"].shape == (n, min(SRM_K, n))
    if m <= SRM_K:      # the whole row is kept: the self index comes last
        assert (scores["r_fn"][:, -1] == refer).all()
    for key in ("rt", "rm", "mt"):
        assert scores[key].dtype == np.int64 and (scores[key] >= 0).all()
    phase(f"srm slice: cli.srm_utils over {m} unique train images and {n} "
          f"captions in {cli_s:.1f} s (random Unicom ViT-L/14 + BGE-base "
          f"files written in {write_s:.1f} s and read strictly; CLIP "
          f"ViT-L/14 float32), peak device memory {peak_gb:.2f} GiB; "
          f"launches {launches} (want 24 + 24 #3 per batch of {SRM_BATCH} "
          f"and 12 #1 per {srm_utils.TEXT_CHUNK} captions); r_fn "
          f"{scores['r_fn'].shape}, m_fn {scores['m_fn'].shape}, rank sums "
          f"rt median {int(np.median(scores['rt']))} [{card}]")

    # the Unicom encode on a resident batch of the tree's images
    tf = ImageTransform("clip", 224)
    ds_img = CIRDataset("cirr", "train", "relative", tf, root)
    _, images = next(iter_unique_images(ds_img, SRM_BATCH))
    images = torch.from_numpy(images).to(device)

    def encode():
        with torch.inference_mode():
            return tower(images)

    count = zero_counts(ak, bk)
    encode()
    assert read_counts(count)["long_attention"] == 24
    batch_ms = median_ms(encode, reps=5, warmup=1)
    busy_ms, n_ops, groups = batch_profile(encode, "unicom")
    with torch.inference_mode():
        got = encode()
        got = got / got.norm(dim=-1, keepdim=True)
        set_attention_impl(tower, "plain")
        plain = tower(images)
        plain = plain / plain.norm(dim=-1, keepdim=True)
    err = (got - plain).abs().max().item()
    assert err <= SRM_EMBED_TOL, err
    share = {k: groups.get(k, 0.0) / busy_ms
             for k in ("attention kernels", "GEMMs")}
    stats = dict(images_per_s=SRM_BATCH / batch_ms * 1e3, batch_ms=batch_ms,
                 busy_ms=busy_ms, device_ops=n_ops,
                 attention_share=share["attention kernels"],
                 gemm_share=share["GEMMs"], embed_err_vs_plain=err,
                 ms_by_group={k: round(v, 3) for k, v in sorted(
                     groups.items(), key=lambda kv: -kv[1])})
    phase(f"srm slice: Unicom ViT-L/14 float32 encode of a resident batch of "
          f"{SRM_BATCH}: {batch_ms:.3f} ms a batch (median of 5, CUDA "
          f"events), {stats['images_per_s']:.1f} images/s; "
          f"{extraction_line(busy_ms, n_ops, groups, batch_ms)}: #3 "
          f"{100 * share['attention kernels']:.1f}% of the device time, GEMMs "
          f"{100 * share['GEMMs']:.1f}%; unit embeddings through #3 against "
          f"the plain attention route: max_abs_err={err:.3e} (tol "
          f"{SRM_EMBED_TOL}) [{card}]")
    phase("srm encode stats " + json.dumps(stats))
    del tower, images
    torch.cuda.empty_cache()
    return launches, sims_path


def _assert_same_up_to_ties(mat, selves, got, want):
    """Negatives of two runs over the same rows: the same values in the
    same order; inside a run of equal values the same index set (the run
    that the K boundary cuts: its value's lowest indices in both)."""
    mat = mat.clone()
    mat[torch.arange(len(selves)), selves] = -1e4
    gv, wv = mat.gather(1, got), mat.gather(1, want)
    assert torch.equal(gv, wv)
    same = torch.equal(got, want)
    if not same:        # compare index sets run by run where they differ
        for r in torch.nonzero((got != want).any(dim=1)).flatten().tolist():
            vals = gv[r]
            edge = torch.nonzero(vals[1:] != vals[:-1]).flatten() + 1
            bounds = [0] + edge.tolist() + [len(vals)]
            for s, e in zip(bounds[:-1], bounds[1:]):
                assert set(got[r, s:e].tolist()) == set(
                    want[r, s:e].tolist()), (r, s, e)
    return same


def drive_srm_scale(card):
    """Phase 17c: `srm_scores` at CIRR's size, 16,939 images x 28,225
    triplets, K = 1000, on seeded random unit features (768 wide): the four
    products and the scores timed by CUDA events, their peak device memory;
    256 sampled triplets held against the port's CPU version (`score_rows`)
    on the same similarities copied to the host: ranks exactly, the
    negatives' values exactly and their index sets within each run of
    equal values. No sims file is written at this size (8 GB)."""
    from spn4cir_tpu_torch.datagen.srm import (compute_sims, score_rows,
                                               srm_scores)

    device = torch.device("cuda:0")
    g = torch.Generator(device=device).manual_seed(17)

    def unit(rows):
        x = torch.randn(rows, SRM_DIM, generator=g, device=device)
        return x / x.norm(dim=1, keepdim=True)

    m, n = CIRR_SRM_IMAGES, CIRR_SRM_TRIPLETS
    feats = [unit(m), unit(n), unit(m), unit(n)]
    refer = torch.randint(0, m, (n,), generator=g, device=device)
    target = torch.randint(0, m, (n,), generator=g, device=device)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    sims = compute_sims(*feats)
    ev[1].record()
    scores = srm_scores(sims, refer, target, SRM_K)
    ev[2].record()
    ev[2].synchronize()
    sims_ms, scores_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    sims_gb = sum(v.numel() * 4 for k, v in sims.items() if k != "t2i") / 1e9
    assert scores["r_fn"].shape == (n, SRM_K) and scores["m_fn"].shape == (
        n, SRM_K)

    rows = torch.randperm(n, generator=g, device=device)[:SRM_CHECK_ROWS]
    t0 = time.perf_counter()
    i2t = sims["i2t"].cpu()
    host = {"i2t": i2t, "t2i": i2t.T, "i2i": sims["i2i"].cpu(),
            "t2t": sims["t2t"].cpu()}
    want = score_rows(host, refer.cpu(), target.cpu(), rows.cpu(), SRM_K)
    cpu_s = time.perf_counter() - t0
    got = {k: v[rows].cpu() for k, v in scores.items()}
    for key in ("rt", "rm", "mt"):
        assert torch.equal(got[key], want[key]), key
    r, t, rc = refer.cpu()[rows.cpu()], target.cpu()[rows.cpu()], rows.cpu()
    exact = [_assert_same_up_to_ties(host["i2i"][r], r, got["r_fn"],
                                     want["r_fn"]),
             _assert_same_up_to_ties(host["i2i"][t], t, got["t_fn"],
                                     want["t_fn"]),
             _assert_same_up_to_ties(host["t2t"][rc], rc, got["m_fn"],
                                     want["m_fn"])]
    stats = dict(images=m, triplets=n, k=SRM_K, sims_ms=sims_ms,
                 scores_ms=scores_ms, sims_gb=sims_gb,
                 peak_gb_over_inputs=peak_gb - base_gb, peak_gb=peak_gb,
                 checked_rows=SRM_CHECK_ROWS, cpu_check_s=cpu_s,
                 negatives_index_identical=all(exact))
    phase(f"srm scale: CIRR size, {m} images x {n} triplets, K = {SRM_K}: "
          f"compute_sims {sims_ms:.2f} ms ({sims_gb:.2f} GB of float32 "
          f"similarities), srm_scores {scores_ms:.2f} ms (CUDA events), peak "
          f"device memory {peak_gb:.2f} GiB ({peak_gb - base_gb:.2f} over "
          f"the features); {SRM_CHECK_ROWS} sampled triplets equal the CPU "
          f"version on the host copy (ranks exactly, negatives' values "
          f"exactly, indices {'identical' if all(exact) else 'equal as sets within runs of equal values'}"
          f"; {cpu_s:.1f} s) [{card}]")
    phase("srm scale stats " + json.dumps(stats))
    del sims, scores, host, feats
    torch.cuda.empty_cache()


def drive_srm_train(ak, bk, root, sims_path, tmp, card):
    """Phase 17d: `cli.captioner --mllm stub` writes the tree's it-list,
    `cli.get_cir_data --srm <17b's sims> --i2i_rank 1 --i2i_rank_max 50
    --model clip` writes the extended triplets from partners in that rank
    window of i2i, then `train_main("clip", [... "--plus"])` (ViT-B/32
    bf16, batch 256) takes one epoch of stage-2 steps on them, counted from
    zero: 12 + 12 short attentions and 1 + 1 bank kernels a step, 12 per
    extraction batch. Returns (launch counts, its argv, which names the
    bank cache that phase 17e's runs load)."""
    from spn4cir_tpu_torch.cli import captioner, get_cir_data, train
    from spn4cir_tpu_torch.data.datasets import CIRDataset

    cwd = os.getcwd()
    os.chdir(tmp)       # the it-list lands under the working directory
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            it_path = os.path.abspath(captioner.main(
                ["--dataset", "cirr", "--data_path", root, "--mllm",
                 "stub"]))
    finally:
        os.chdir(cwd)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ext_path = get_cir_data.main(
            ["--dataset", "cirr", "--data_path", root, "--it_list", it_path,
             "--srm", sims_path, "--i2i_rank", "1", "--i2i_rank_max", "50",
             "--model", "clip"])
    gen_s = time.perf_counter() - t0
    with open(ext_path) as fh:
        n_ext = len(json.load(fh))
    ds = CIRDataset("cirr", "train", "relative", None, root, plus=True,
                    extend_suffix="clip", seed=0)
    human = len(CIRDataset("cirr", "train", "relative", None, root).triplets)
    assert len(ds.triplets) == human + n_ext and n_ext > 0
    bank_path = os.path.join(tmp, "srm_bank.npz")
    argv = ["--dataset", "cirr", "--data_path", root, "--clip-model-name",
            "ViT-B/32", "--bf16", "--seed", "0", "--batch-size",
            str(TRAIN_BATCH), "--num-epochs", "1", "--plus", "--bank_path",
            bank_path, "--validation-frequency", "99"]
    count = zero_counts(ak, bk)
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        train.train_main("clip", argv + ["--output_path",
                                         os.path.join(tmp, "srm_train")],
                         log_every=1, **train.CLIP4CIR_DEFAULTS)
    train_s = time.perf_counter() - t0
    launches = read_counts(count)
    losses = logged_losses(tee.buffer_.getvalue())
    steps = len(ds.triplets) // TRAIN_BATCH
    extract = math.ceil(ds.num_unique_images / TRAIN_BATCH)
    assert len(losses) == steps >= 4 and all(map(math.isfinite, losses)), \
        losses
    want = dict(short_attention=12 * (steps + extract),
                short_attention_bwd=12 * steps, **NO_LONG,
                **bank_launches(False, steps))
    assert launches == want, (launches, want)
    phase(f"srm train slice: cli.captioner (stub) -> cli.get_cir_data "
          f"--srm --i2i_rank 1..50 wrote {n_ext} extended triplets in "
          f"{gen_s:.2f} s; train_main clip --plus (ViT-B/32 bf16, batch "
          f"{TRAIN_BATCH}) over {len(ds.triplets)} triplets: {steps} steps "
          f"in {train_s:.1f} s, losses {[round(x, 4) for x in losses]}; "
          f"launches {launches} (want {want}) [{card}]")
    return launches, argv


def drive_resume(argv, tmp, card):
    """Phase 17e: 17d's run through `python -m spn4cir_tpu_torch.cli.train
    clip ... --resume --ckpt_every_steps 2` in subprocesses, all with
    CUBLAS_WORKSPACE_CONFIG=:4096:8 and 17d's bank cache: an uninterrupted
    run with `--profile_dir` and, beside it, a run killed by SIGKILL once
    its first checkpoint lands, then started again to the end. The two
    final states' trainable parameters: bitwise equal, or their max abs
    difference (reported as such)."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    flags = argv + ["--resume", "--ckpt_every_steps", "2"]

    def start(out, *extra):
        log = open(os.path.join(tmp, os.path.basename(out) + ".log"), "w")
        return subprocess.Popen(
            [sys.executable, "-m", "spn4cir_tpu_torch.cli.train", "clip",
             *flags, "--output_path", out, *extra], cwd=REPO, env=env,
            stdout=log, stderr=subprocess.STDOUT), log

    def finish(proc, log):
        rc = proc.wait(timeout=600)
        log.close()
        with open(log.name) as fh:
            text = fh.read()
        assert rc == 0, text[-3000:]
        return text

    whole, part = os.path.join(tmp, "resume_whole"), os.path.join(
        tmp, "resume_part")
    prof = os.path.join(tmp, "resume_prof")
    t0 = time.perf_counter()
    a = start(whole, "--profile_dir", prof)
    b, blog = start(part)
    first = os.path.join(part, "resume", "2.pt")
    try:
        while not os.path.exists(first):
            assert b.poll() is None, "the run ended before its first save"
            assert time.perf_counter() - t0 < 600, "no first checkpoint"
            time.sleep(0.005)
    finally:
        b.kill()
        b.wait()
        blog.close()
    assert b.returncode == -signal.SIGKILL, b.returncode
    killed_s = time.perf_counter() - t0
    kept = sorted(int(f[:-3]) for f in os.listdir(os.path.join(
        part, "resume")) if f.endswith(".pt") and f[:-3].isdigit())
    text = finish(*start(part))
    resumed_s = time.perf_counter() - t0 - killed_s
    resumed = re.search(r"resumed from epoch (\d+) step (\d+)", text)
    assert resumed, text[-2000:]
    finish(*a)
    wall = time.perf_counter() - t0
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert traces, os.listdir(prof)

    def final(out):
        d = os.path.join(out, "resume")
        step = max(int(f[:-3]) for f in os.listdir(d)
                   if f.endswith(".pt") and f[:-3].isdigit())
        return step, torch.load(os.path.join(d, f"{step}.pt"),
                                map_location="cpu", weights_only=True)

    (sa, fa), (sb, fb) = final(whole), final(part)
    assert sa == sb == fa["step"] == fb["step"], (sa, sb)
    assert fa["params"].keys() == fb["params"].keys()
    bitwise = all(torch.equal(fa["params"][k], fb["params"][k])
                  for k in fa["params"])
    diff = max((fa["params"][k] - fb["params"][k]).abs().max().item()
               for k in fa["params"])
    assert all(torch.isfinite(v).all() for v in fb["params"].values())
    phase(f"resume slice: cli.train clip --plus --resume --ckpt_every_steps "
          f"2 killed by SIGKILL with checkpoints {kept} on disk, resumed "
          f"from epoch {resumed.group(1)} step {resumed.group(2)} to step "
          f"{sb}: its {len(fb['params'])} trainable tensors "
          + ("are BITWISE EQUAL to" if bitwise else
             f"differ by max abs {diff:.3e} from")
          + f" the uninterrupted run's (CUBLAS_WORKSPACE_CONFIG=:4096:8); "
          f"--profile_dir wrote {traces[0]}; {wall:.1f} s for the three "
          f"processes (the killed one {killed_s:.1f} s from the start, its "
          f"resumption {resumed_s:.1f} s, the uninterrupted one beside them) "
          f"[{card}]")
    return dict(bitwise=bitwise, max_abs_diff=diff, resumed_at=[
        int(resumed.group(1)), int(resumed.group(2))], final_step=sb)


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
    t_start = time.perf_counter()
    laps = {}

    def lap(label):
        """The seconds since the start at the end of phase `label`."""
        laps[label] = round(time.perf_counter() - t_start, 1)

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
        from spn4cir_tpu_torch.ops import decode_attn as da
        from spn4cir_tpu_torch.ops import maxquery_kernels as mk
        from spn4cir_tpu_torch.ops import quant_matmul as qm

        device = torch.device("cuda:0")
        card = card_line()
        phase(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
              f"torch {torch.__version__}, CUDA {torch.version.cuda}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        phase("TF32 off for matmul and cuDNN (float32 comparisons)")

        # phase 2: build
        build_kernels(cuda_build)

        lap("2 (build)")
        # phase 3: kernels against their plain versions
        fwd_records = check_attention_fwd(ak, device, card)
        bwd_records = check_attention_bwd(ak, device, card)
        bank_records = check_bank(bk, device, card)
        long_fwd_records, long_bwd_records = check_long_attention(
            ak, device, card)
        mq_records = check_max_query(mk, bk, device, card)
        decode_records = check_decode_attention(da, device, card)
        qmm_records = check_quant_matmul(qm, device, card)

        lap("3 (kernels)")
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

        lap("4")
        # phase 5: the training slice through its entry point
        train_launches, _, _ = drive_training_cli(ak, bk, root, tmp, card)

        lap("5")
        # phase 6: the flagship recipe through its three entry points
        flagship_launches, argv, trained = drive_training_cli(
            ak, bk, flagship_root, tmp, card, model=FLAGSHIP,
            bank_dtype="int8", n_gallery=FLAGSHIP_IMAGES,
            n_train=FLAGSHIP_TRAIN)
        eval_launches = drive_flagship_eval(ak, bk, argv, trained, tmp, card)
        cases_launches = drive_cases(ak, bk, argv, tmp, card)
        del trained
        torch.cuda.empty_cache()

        lap("6")
        # phase 7: the training loop at the recipe's bank size
        drive_training_recipe(ak, bk, tmp, card, "ViT-B/32", ("bfloat16",))
        drive_training_recipe(ak, bk, tmp, card, FLAGSHIP,
                              ("int8", "float32"))

        lap("7")
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

        lap("9")
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

        lap("10")
        # phase 11: the LLaMA-2 7B rewriter of the datagen pipeline
        from spn4cir_tpu_torch.datagen.llm_rewrite import build_rewrite_prompt
        from spn4cir_tpu_torch.tokenizer.bytelevel import ByteTokenizer

        tok = ByteTokenizer()
        world = rewrite_world(tmp)
        caps = list(world[2].values())
        prompts = [build_rewrite_prompt(caps[i], caps[(i + 1) % len(caps)],
                                        "cirr", 0, 1)
                   for i in range(len(caps))]
        cfg7, model7 = llama_model(device)
        rewrite_launches = drive_rewrite(ak, bk, model7, cfg7, tok, world,
                                         tmp, card)
        torch.cuda.empty_cache()
        q8_launches = drive_llama_q8(ak, bk, model7, cfg7, tok, prompts, tmp,
                                     card)
        del model7
        torch.cuda.empty_cache()
        check_llama_streams(tok, prompts, card)

        lap("11")
        # phase 14: LLaVA-v1-7B captions the rewrite tree, its batched_fn
        # behind the caption service, then the it-list into get_cir_data
        (llava_launches_, llava_it, llava_cap, llava_tf,
         llava_fn) = drive_llava(ak, bk, world, tmp, card)
        llava_service_launches = drive_llava_service(
            ak, bk, llava_cap, llava_tf, llava_fn, card)
        del llava_cap, llava_fn
        torch.cuda.empty_cache()
        get_cir_data_launches = drive_get_cir_data(ak, bk, world, card,
                                                   it_path=llava_it)

        lap("14")
        # phase 12: tgcir at full ViT-B/16 width through its entry points,
        # on the flagship slice's tree
        tgcir_serve_launches = drive_tgcir_serving(ak, bk, layers,
                                                   flagship_root, card)
        torch.cuda.empty_cache()
        tgcir_train_launches, tgcir_eval_launches = drive_tgcir_training(
            ak, bk, flagship_root, tmp, card, FLAGSHIP_IMAGES)
        torch.cuda.empty_cache()
        drive_training_recipe(ak, bk, tmp, card, "ViT-B/16",
                              ("float32", "int8"), kind="tgcir")
        torch.cuda.empty_cache()

        lap("12")
        # phase 13: the negative-type ablation and zscir stage 1
        negtype_launches = drive_negtype(ak, bk, flagship_root, tmp, card,
                                         FLAGSHIP_IMAGES)
        torch.cuda.empty_cache()
        zs_launches = drive_zs_stage1(ak, bk, tmp, card)
        torch.cuda.empty_cache()

        lap("13")
        # phase 15: BLIP caption base through cli.captioner and
        # cli.serve_mllm; phase 16: cli.retrieval with ViT-L/14
        blip_caption_launches, blip_caption_serve_launches = \
            drive_blip_caption(ak, bk, tmp, card)
        torch.cuda.empty_cache()
        lap("15")
        retrieval_launches = drive_retrieval(ak, bk, tmp, card)
        torch.cuda.empty_cache()

        lap("16")
        # phase 17: the scaling-positives datagen (dedup, the SRM matcher at
        # full width, CIRR-size scoring, --plus training on its triplets)
        # and a stage-2 run killed and resumed
        srm_root = drive_dedup(tmp, card)
        srm_launches, sims_path = drive_srm(ak, bk, srm_root, tmp, card)
        torch.cuda.empty_cache()
        drive_srm_scale(card)
        srm_train_launches, srm_argv = drive_srm_train(
            ak, bk, srm_root, sims_path, tmp, card)
        torch.cuda.empty_cache()
        drive_resume(srm_argv, tmp, card)

        lap("17")
        # phase 8: kernels vs plain versions through one whole loss
        check_plain_step(layers, bk, card)
        check_blip_plain_step(layers, card)
        check_blip2_plain_step(layers, bk, mk, card)
        check_plain_step(layers, bk, card, kind="tgcir", model="ViT-B/16",
                         probe=TGCIR_PROBE, seed=14)

        lap("8")
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
                                    + blip2_eval_launches[name]),
                    "rewrite": rewrite_launches[name],
                    "llama_q8": q8_launches[name],
                    "get_cir_data": get_cir_data_launches[name],
                    "tgcir_serve": tgcir_serve_launches[name],
                    "tgcir_train": (tgcir_train_launches[name]
                                    + tgcir_eval_launches[name]),
                    "negtype": negtype_launches[name],
                    "zs_stage1": zs_launches[name],
                    "cases": cases_launches[name],
                    "llava": llava_launches_[name],
                    "llava_service": llava_service_launches[name],
                    "blip_caption": blip_caption_launches[name],
                    "blip_caption_serve": blip_caption_serve_launches[name],
                    "retrieval": retrieval_launches[name],
                    "srm": srm_launches[name],
                    "srm_train": srm_train_launches[name]}

        at_bank = f"B={TRAIN_BATCH}, M={RECIPE_BANK}, D={BANK_DIM}"
        at_flag = f"B={TRAIN_BATCH}, M={RECIPE_BANK}, D={FLAGSHIP_DIM}"
        csrc = "spn4cir_tpu_torch/csrc/"
        jax_ops = "spn4cir_tpu/ops/"
        entries = [kernel_entry(
            "short_attention", jax_ops + "attention_kernels.py:257",
            csrc + "short_attention.cu", by_path("short_attention"),
            ("serve", "train", "flagship", "tgcir_serve", "tgcir_train",
             "negtype", "zs_stage1", "cases", "retrieval", "srm",
             "srm_train"), fwd_records,
            pick(fwd_records, tower="vision", dtype="bfloat16"),
            also=[pick(fwd_records, tower=t, dtype="bfloat16") for t in
                  ("text", "train-text", "flagship-text",
                   "flagship-eval-text")])]
        entries.append(kernel_entry(
            "short_attention_bwd", jax_ops + "attention_kernels.py:279",
            csrc + "short_attention.cu", by_path("short_attention_bwd"),
            ("train", "flagship", "tgcir_train", "negtype", "zs_stage1",
             "srm_train"),
            bwd_records,
            pick(bwd_records, tower="train-text", dtype="bfloat16"),
            also=[pick(bwd_records, tower="flagship-text",
                       dtype="bfloat16")]))
        for name, line in (("bank_infonce_fwd", 53), ("bank_infonce_bwd", 148)):
            recs = bank_records[name]
            entries.append(kernel_entry(
                name, f"{jax_ops}bank_kernels.py:{line}",
                csrc + "bank_infonce.cu", by_path(name),
                ("train", "blip_train", "tgcir_train", "srm_train"), recs,
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
                csrc + "bank_infonce.cu", by_path(name),
                ("flagship", "tgcir_train"), recs,
                pick(recs, shape=at_flag, dtype="int8"),
                also=[pick(recs, shape=at_bank, dtype="int8")]))
        for name, line, on_paths, recs in (
                ("long_attention", 74,
                 ("blip_serve", "blip_train", "blip_stage1", "blip2_serve",
                  "blip2_train", "tgcir_serve", "tgcir_train", "zs_stage1",
                  "llava", "llava_service", "blip_caption",
                  "blip_caption_serve", "retrieval", "srm"),
                 long_fwd_records),
                ("long_attention_bwd", 109, ("blip_stage1", "zs_stage1"),
                 long_bwd_records)):
            entries.append(kernel_entry(
                name, f"{jax_ops}attention_kernels.py:{line}",
                csrc + "long_attention.cu", by_path(name), on_paths, recs,
                pick(recs, tower="blip-index", dtype="bfloat16"),
                also=[pick(recs, tower="blip-extract", dtype="bfloat16"),
                      pick(recs, tower="blip-extract", dtype="float32"),
                      pick(recs, tower="blip-index", dtype="float32"),
                      pick(recs, tower="eva-g-extract", dtype="bfloat16"),
                      pick(recs, tower="eva-g-extract", dtype="float32"),
                      pick(recs, tower="zs-stage1", dtype="bfloat16"),
                      pick(recs, tower="tgcir-extract", dtype="bfloat16"),
                      pick(recs, tower="llava-tower", dtype="bfloat16"),
                      pick(recs, tower="unicom-encode", dtype="float32")]))
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
        at_dec = (f"B={LLAMA_BATCH}, H=32, hd=128, L={LLAMA_LEN_CIRR}, "
                  f"layer 31 of 32")
        entries.append(kernel_entry(
            "decode_attention", jax_ops + "decode_attn.py:97",
            csrc + "decode_attention.cu", by_path("decode_attention"),
            ("rewrite", "llama_q8", "get_cir_data", "llava", "llava_service"),
            decode_records,
            pick(decode_records, shape=at_dec, dtype="bfloat16"),
            also=[pick(decode_records, shape=at_dec, dtype=t)
                  for t in ("float32", "int8")]
            + [pick(decode_records, shape=at_dec.replace(
                f"B={LLAMA_BATCH}", f"B={b}"), dtype=t)
               for b in (1, 8) for t in ("bfloat16", "int8")]
            + [pick(decode_records, shape=at_dec.replace(
                f"L={LLAMA_LEN_CIRR}", f"L={length}"), dtype="bfloat16")
               for length in (LLAMA_LEN_FIQ, LLAVA_LEN)]))
        entries.append(kernel_entry(
            "quant_matmul", jax_ops + "quant_matmul.py:54",
            csrc + "quant_matmul.cu", by_path("quant_matmul"), ("llama_q8",),
            qmm_records,
            pick(qmm_records, shape="rows=16, D=4096, F=11008",
                 dtype="float32"),
            also=[pick(qmm_records, shape=f"rows={r}, D={d}, F={f}",
                       dtype="float32")
                  for r in Q8_BATCHES
                  for d, f in ((4096, 4096), (4096, 11008), (11008, 4096),
                               (4096, 32000))
                  if (r, d, f) != (16, 4096, 11008)]))
        assert len(entries) == 12, len(entries)
        phase(f"every phase passed in {time.perf_counter() - t_start:.1f} s; "
              f"seconds since the start at the end of each phase: {laps}")
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
