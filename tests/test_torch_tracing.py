"""The port's spans (`utils.logging.span`) on the CPU under `torch.profiler`.

Each test runs a tiny model under the program's recorder
(`utils.logging.profiler_trace`, what `--profile_dir` starts), reads the
Chrome trace it writes, and checks the `user_annotation` ranges by name and
by interval: the stage-2 loop's `stage2.step` and its children, a backbone's
`bank.encode` and its children, a service's `serve.dispatch` and its
children, and the training CLI's traces of its bank extraction and its
epochs. Without a profiler a span is one shared no-op, and the program's
numbers are the same to the bit with the profiler on or off.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from spn4cir_tpu_torch.bank.bank import Bank, extract_banks
from spn4cir_tpu_torch.cli.train import train_main
from spn4cir_tpu_torch.eval.retrieval import GalleryIndex
from spn4cir_tpu_torch.models.api import build_backbone
from spn4cir_tpu_torch.models.clip4cir import ClipCIR, ZsCIR
from spn4cir_tpu_torch.models.tgcir import TgcirCIR
from spn4cir_tpu_torch.serve import BatchingRetrievalService, RetrievalService
from spn4cir_tpu_torch.train import stage2
from spn4cir_tpu_torch.utils import logging as obs
from tests.fixtures import make_cirr
from tests.torch_fixtures import synthetic_tokenizer

torch.set_num_threads(1)

M, B = 24, 4
CAPTIONS = ["make it like number 7 but red", "is darker and has longer sleeves",
            "a zebra on the beach", "same shirt with blue stripes"]
STEP_CHILDREN = ("stage2.gather_refer", "text.tokenize", "stage2.to_device",
                 "stage2.forward", "stage2.backward", "stage2.optimizer")
DISPATCH_CHILDREN = ("text.tokenize", "serve.fuse", "serve.score_topk",
                     "serve.to_host")


@pytest.fixture(scope="module")
def tok():
    return synthetic_tokenizer()


def trace_files(logdir):
    return sorted(os.path.join(logdir, f) for f in os.listdir(logdir)
                  if f.endswith(".pt.trace.json"))


def spans_of(path):
    """The trace's spans as (name, start us, end us, thread id)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("tid")) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def traced(fn, logdir):
    """Run `fn` under `profiler_trace(logdir)`, which records every thread
    (a batching service's worker too); (its result, the spans of the one
    trace written)."""
    with obs.profiler_trace(str(logdir)):
        out = fn()
    (path,) = trace_files(logdir)
    return out, spans_of(path)


def named(spans, name):
    return [s for s in spans if s[0] == name]


def inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def clip_setup(tok, seed=0):
    """A tiny clip4cir, its AdamW state and a bank of M images."""
    backbone = ClipCIR("test-tiny", tokenizer=tok)
    backbone.init_params(torch.Generator().manual_seed(seed))
    backbone.train()
    state = stage2.create_train_state(backbone, 1e-3)
    rng = np.random.RandomState(seed)
    target = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(M, backbone.embed_dim).astype(np.float32)),
        dim=-1)
    bank = Bank(refer=rng.randn(M, backbone.embed_dim).astype(np.float32),
                target=target, refer_key="image")
    return backbone, state, bank


def clip_batches(n, seed=1):
    rng = np.random.RandomState(seed)
    return [{"captions": [CAPTIONS[(i + j) % len(CAPTIONS)] for j in range(B)],
             "target_image_id": rng.randint(0, M, B).astype(np.int64),
             "refer_image_id": rng.randint(0, M, B).astype(np.int64),
             "triplet_idx": np.arange(B, dtype=np.int64)} for i in range(n)]


def test_train_epoch_spans_nest_in_each_step(tok, tmp_path):
    backbone, state, bank = clip_setup(tok)
    (_, mean), spans = traced(lambda: stage2.train_epoch(
        backbone, state, bank, iter(clip_batches(2)), log_every=0),
        tmp_path / "trace")
    assert np.isfinite(mean)
    steps = named(spans, "stage2.step")
    assert len(steps) == 2
    for step in steps:
        for child in STEP_CHILDREN:
            assert any(inside(s, step) for s in named(spans, child)), child
    # the loop's two copies and the step's two optimizer stretches
    # (zero_grad before the forward, the AdamW update after the backward)
    for child, count in (("stage2.to_device", 2), ("stage2.optimizer", 2)):
        assert all(sum(inside(s, step) for s in named(spans, child)) == count
                   for step in steps), child
    # the consumer waits for each batch and for the end of the stream, on
    # the loop's thread, outside the steps
    waits = named(spans, "prefetch.wait")
    assert len(waits) == 3
    assert {s[3] for s in waits} == {s[3] for s in steps}
    assert not any(inside(w, s) for w in waits for s in steps)
    assert not named(spans, "stage2.grad_reduce")   # not data-parallel


def test_sampled_negatives_span(tok, tmp_path):
    backbone, state, bank = clip_setup(tok)
    _, spans = traced(lambda: stage2.train_epoch(
        backbone, state, bank, iter(clip_batches(1)), neg_num=5, neg_seed=3,
        log_every=0), tmp_path / "trace")
    (step,) = named(spans, "stage2.step")
    assert [inside(s, step) for s in named(spans, "stage2.negatives")] == [True]
    assert sum(inside(s, step) for s in named(spans, "stage2.to_device")) == 3


def test_fusion_bank_features_nests_its_parts(tmp_path):
    backbone = build_backbone("blip2", blip2_size="test-tiny")
    backbone.init_params(torch.Generator().manual_seed(0))
    backbone.eval()
    side = backbone.input_dim
    images = torch.randn(2, side, side, 3, generator=torch.Generator()
                         .manual_seed(1))

    def encode():
        with torch.no_grad():
            ids = torch.from_numpy(backbone.tokenize(CAPTIONS[:2]))
            return backbone.fusion_bank_features(images, ids)

    _, spans = traced(encode, tmp_path / "trace")
    (outer,) = named(spans, "bank.encode")
    parts = [named(spans, f"bank.encode.{p}") for p in
             ("vision", "fusion", "query")]
    assert all(len(p) == 1 and inside(p[0], outer) for p in parts)
    # in order, one after the other
    assert parts[0][0][2] <= parts[1][0][1] and parts[1][0][2] <= parts[2][0][1]
    (tokenize,) = named(spans, "text.tokenize")
    assert tokenize[2] <= outer[1]


def _backbone(kind, tok):
    if kind == "clip":
        return ClipCIR("test-tiny", tokenizer=tok)
    if kind == "zs":
        return ZsCIR("test-tiny", tokenizer=tok)
    if kind == "tgcir":
        return TgcirCIR("test-tgcir", tokenizer=tok)
    return build_backbone("blip", blip_size="test-tiny")


@pytest.mark.parametrize("kind", ["clip", "zs", "tgcir", "blip"])
def test_bank_extraction_spans(kind, tok, tmp_path):
    """Every backbone's `bank_features` is a `bank.encode` with its image
    tower inside, between the extractor's copies; its `tokenize` is a
    `text.tokenize`."""
    backbone = _backbone(kind, tok)
    backbone.init_params(torch.Generator().manual_seed(0))
    backbone.eval()
    side = backbone.input_dim
    rng = np.random.RandomState(2)
    batches = [(np.array([0, 1]), rng.randn(2, side, side, 3)
                .astype(np.float32)),
               (np.array([2, -1]), rng.randn(2, side, side, 3)
                .astype(np.float32))]

    def run():
        backbone.tokenize(CAPTIONS[:2])
        return extract_banks(backbone.bank_features, iter(batches), 3)

    bank, spans = traced(run, tmp_path / "trace")
    assert bank.refer.shape[0] == 3
    assert len(named(spans, "text.tokenize")) == 1
    encodes = named(spans, "bank.encode")
    ins, outs = named(spans, "bank.to_device"), named(spans, "bank.to_host")
    assert len(encodes) == len(ins) == len(outs) == 2
    for enc, a, b in zip(sorted(encodes, key=lambda s: s[1]),
                         sorted(ins, key=lambda s: s[1]),
                         sorted(outs, key=lambda s: s[1])):
        assert a[2] <= enc[1] and enc[2] <= b[1]
        assert any(inside(v, enc) for v in named(spans, "bank.encode.vision"))


def _service_world(tok):
    backbone = ClipCIR("test-tiny", tokenizer=tok)
    backbone.init_params(torch.Generator().manual_seed(0))
    backbone.eval()
    rng = np.random.RandomState(3)
    feats = rng.randn(12, backbone.embed_dim).astype(np.float32)
    index = GalleryIndex(
        target=torch.nn.functional.normalize(torch.from_numpy(feats), dim=-1),
        refer=feats, names=[f"img{i}" for i in range(12)])
    return backbone, index


@pytest.mark.parametrize("batching", [False, True])
def test_service_dispatch_spans(batching, tok, tmp_path):
    backbone, index = _service_world(tok)
    if batching:
        service = BatchingRetrievalService(backbone, index, max_batch=4,
                                           max_delay_s=0.05)
    else:
        service = RetrievalService(backbone, index)

    def queries():
        threads = [threading.Thread(
            target=service.query_by_name, args=(f"img{i}", CAPTIONS[i], 3))
            for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    _, spans = traced(queries, tmp_path / "trace")
    dispatches = named(spans, "serve.dispatch")
    assert 1 <= len(dispatches) <= 3
    for d in dispatches:
        for child in DISPATCH_CHILDREN:
            assert sum(inside(s, d) for s in named(spans, child)) == 1, child
    fills = named(spans, "serve.batch_fill")
    if batching:
        # the worker's coalescing wait, on the worker's thread, before each
        # dispatch
        assert len(fills) >= len(dispatches)
        assert {s[3] for s in fills} == {s[3] for s in dispatches}
    else:
        assert not fills
    m = service.metrics()
    assert m["queries"] == 3 and m["dispatches"] == len(dispatches)
    assert m["dispatch_ms_avg"] > 0 and m["queue_wait_ms_avg"] >= 0


def test_batching_counts_the_queue_wait(tok):
    """A query that waits out the coalescing window is counted with the
    wait, from its enqueue to its dispatch taking the lock."""
    backbone, index = _service_world(tok)
    service = BatchingRetrievalService(backbone, index, max_batch=8,
                                       max_delay_s=0.2)
    service.query_by_name("img1", CAPTIONS[0], 3)
    m = service.metrics()
    assert m["queries"] == 1 and m["dispatches"] == 1
    assert m["queue_wait_ms_avg"] >= 150
    assert set(m) >= {"dispatch_ms_avg", "queue_wait_ms_avg"}
    assert not {"latency_ms_sum", "latency_ms_avg"} & set(m)


def test_span_without_a_profiler_is_the_shared_noop(tok, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first, second = obs.span("stage2.step"), obs.span("bank.encode")
    assert first is second
    with first:
        pass
    backbone, state, bank = clip_setup(tok)
    _, mean = stage2.train_epoch(backbone, state, bank, iter(clip_batches(2)),
                                 log_every=0)
    assert np.isfinite(mean)
    backbone.eval()
    with torch.no_grad():
        backbone.bank_features(torch.zeros(1, backbone.input_dim,
                                           backbone.input_dim, 3))


def test_numbers_are_the_same_with_the_profiler_on(tok, tmp_path):
    def epoch():
        backbone, state, bank = clip_setup(tok, seed=5)
        losses = []
        stage2.train_epoch(backbone, state, bank, iter(clip_batches(2, 6)),
                           log_every=1, log_fn=lambda s, l: losses.append(l))
        return losses, [p.detach().clone() for p in backbone.parameters()]

    plain_losses, plain_params = epoch()
    (losses, params), spans = traced(epoch, tmp_path / "trace")
    assert named(spans, "stage2.step")
    assert losses == plain_losses
    assert all(torch.equal(a, b) for a, b in zip(params, plain_params))

    blip2 = build_backbone("blip2", blip2_size="test-tiny")
    blip2.init_params(torch.Generator().manual_seed(0))
    blip2.eval()
    side = blip2.input_dim
    images = torch.randn(2, side, side, 3,
                         generator=torch.Generator().manual_seed(4))

    def encode():
        with torch.no_grad():
            ids = torch.from_numpy(blip2.tokenize(CAPTIONS[2:]))
            return blip2.fusion_bank_features(images, ids)

    plain = encode()
    got, _ = traced(encode, tmp_path / "trace2")
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_train_cli_traces_its_bank_extraction_and_its_epochs(tok, tmp_path):
    """`cli.train --profile_dir` writes two traces: the bank extraction's
    (`bank.encode` between `bank.to_device` and `bank.to_host`) and the
    epoch loop's (`stage2.step`)."""
    root = make_cirr(str(tmp_path / "cirr_dataset"), n_images=8, n_train=8,
                     extended=False)
    prof = str(tmp_path / "prof")
    train_main("clip", ["--dataset", "cirr", "--data_path", root,
                        "--clip-model-name", "test-tiny", "--device", "cpu",
                        "--batch-size", "4", "--num-epochs", "1",
                        "--seed", "0", "--validation-frequency", "99",
                        "--output_path", str(tmp_path / "out"),
                        "--profile_dir", prof],
               log_every=0, tokenizer=tok)
    traces = [{s[0] for s in spans_of(f)} for f in trace_files(prof)]
    assert len(traces) == 2
    (bank,) = [names for names in traces if "bank.encode" in names]
    (epochs,) = [names for names in traces if "stage2.step" in names]
    assert {"bank.encode.vision", "bank.to_device", "bank.to_host"} <= bank
    assert set(STEP_CHILDREN) <= epochs
