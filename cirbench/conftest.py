"""Fixtures of the benchmark's CPU tests: throwaway cells at tiny widths in
a temporary checkout of their own (BENCHMARK.json plus cirbench/ data files),
driven on the CPU through the same harness functions as the GPU runs.

Run them with `python -m pytest cirbench -q` from the root of the checkout.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

ADAMW_CLIP = {"b1": 0.9, "b2": 0.999, "eps": 1e-07, "weight_decay": 0.01}
ADAMW_BLIP2 = {"b1": 0.9, "b2": 0.98, "eps": 1e-07, "weight_decay": 0.05}

TINY_CONFIGS = {
    "clip-tiny": {
        "family": "clip", "model_name": "test-tiny", "dtype": "float32",
        "embed_dim": 32, "context_length": 77, "vocab_size": 49408,
        "transformer_width": 32, "transformer_heads": 2,
        "transformer_layers": 2, "tau": 0.02, "adamw": ADAMW_CLIP,
        "scalars": {"logit_scale": 2.659260036932778}, "reduced": []},
    "blip2-tiny": {
        "family": "blip2", "dtype": "float32",
        "vision": {"image_size": 28, "patch_size": 14, "width": 32,
                   "layers": 2, "heads": 2, "mlp_ratio": 4.0},
        "qformer": {"hidden_size": 32, "num_layers": 2, "num_heads": 2,
                    "intermediate_size": 64, "max_position_embeddings": 512,
                    "encoder_width": 32, "num_query_tokens": 8,
                    "cross_attention_freq": 2},
        "bert_vocab": 300, "qformer_vocab": 302, "embed_dim": 256,
        "max_text_tokens": 32, "tau": 0.05, "adamw": ADAMW_BLIP2,
        "scalars": {"temp": 0.05}, "reduced": []},
}

TINY_TRAFFIC = {
    "stage2-tiny": {"driver": "stage2", "bank_rows": 512,
                    "bank_dtype": "float32", "refer_key": "image",
                    "refer_scale": 1.0, "batch": 8, "batch_pool": 8,
                    "caption_words": [8, 24], "lr": 2e-05, "check_steps": 3,
                    "profile_steps": 2},
    "stage2mq-tiny": {"driver": "stage2", "bank_rows": 256,
                      "bank_dtype": "float32", "refer_key": "triplet",
                      "refer_rows": 64, "refer_scale": 1.0, "batch": 8,
                      "batch_pool": 8, "caption_words": [8, 24],
                      "lr": 1e-05, "check_steps": 3, "profile_steps": 2},
    "extract-tiny": {"driver": "extract", "batch": 4, "pixel_batches": 2,
                     "caption_words": [8, 24], "profile_batches": 2},
    "serve-tiny": {"driver": "serve", "gallery": 300,
                   "gallery_dtype": "bfloat16", "refer_scale": 1.0,
                   "max_batch": 8, "max_delay_s": 0.05, "k": 50,
                   "caption_words": [8, 24], "rate": 100.0,
                   "check_queries": 16, "profile_seconds": 1.0,
                   "warm_seconds": 0.5},
}

#: float32 on the CPU: the program and the reference differ by round-off
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}
TINY_CELLS = {
    "clip-tiny.stage2-tiny": ("clip-tiny", "stage2-tiny", TRAIN_LIMITS),
    "blip2-tiny.stage2mq-tiny": ("blip2-tiny", "stage2mq-tiny", TRAIN_LIMITS),
    "blip2-tiny.extract-tiny": ("blip2-tiny", "extract-tiny",
                                {"fused_gap": 1e-4, "feat_gap": 1e-4}),
    "clip-tiny.serve-tiny": ("clip-tiny", "serve-tiny",
                             {"score_gap": 1e-4, "rank_gap": 1e-4}),
}
METRICS_BY_KIND = {
    "stage2": (["stage2_step_ms"], ["stage2_mfu", "device_idle.train"]),
    "extract": (["extract_images_per_s"],
                ["extract_mfu", "device_idle.extract"]),
    "serve": (["query_p50_ms", "query_p95_ms"],
              ["serve.queries_per_dispatch", "device_idle.serve"]),
}


def write_tiny_root(root: Path, cells=TINY_CELLS) -> Path:
    """A checkout of its own holding the tiny cells' files and a
    BENCHMARK.json that names them; the metric readers are copied."""
    bench = root / "cirbench"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "cirbench" / "metrics", bench / "metrics")
    configs, workloads = {}, []
    e2e = {"setup_s": {"name": "setup_s", "unit": "s", "better": "lower",
                       "bound": 0.25, "source": "host_clock"}}
    per_layer = {}
    for cell, (config, traffic, limits) in cells.items():
        (bench / "configs" / f"{config}.json").write_text(
            json.dumps(TINY_CONFIGS[config]))
        (bench / "traffic" / f"{traffic}.json").write_text(
            json.dumps(TINY_TRAFFIC[traffic]))
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(limits))
        configs[config] = {"name": config, "source": "https://example.org",
                           "file": f"cirbench/configs/{config}.json",
                           "reduced": [], "why": "a CPU test"}
        workloads.append({"name": cell, "config": config, "traffic": traffic,
                          "chips": 1, "why": "a CPU test"})
        ends, layers = METRICS_BY_KIND[TINY_TRAFFIC[traffic]["driver"]]
        for name in ends:
            e2e.setdefault(name, {"name": name, "unit": "ms", "better": "lower",
                                  "bound": 0.1, "source": "host_clock",
                                  "workloads": []})["workloads"].append(cell)
        for name in layers:
            per_layer.setdefault(name, {
                "name": name, "unit": "%", "better": "higher",
                "source": "device_trace", "layer": "a CPU test",
                "moves": ends[0], "workloads": []})["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps({
        "command": ["python3", "-m", "cirbench.run"], "paths": ["cirbench"],
        "run_seconds": 2, "configs": list(configs.values()),
        "workloads": workloads, "end_to_end": list(e2e.values()),
        "per_layer": list(per_layer.values())}))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return write_tiny_root(tmp_path_factory.mktemp("tiny_checkout"))


def drive(root: Path, cell: str, faults=(), trace: bool = False,
          seconds: float = 1.0):
    """One CPU run of `cell` under `root`: (correct, checks, output)."""
    from cirbench import harness
    from cirbench.run import execute

    c = harness.load_cell(cell, root)
    line, checks, ok, out = execute(c, 2 ** 31 + 977, seconds, trace, "cpu",
                                    time.perf_counter(), faults)
    parsed = json.loads(line)
    assert parsed["correct"] == ok
    return ok, {ch.name: ch.value for ch in checks}, parsed
