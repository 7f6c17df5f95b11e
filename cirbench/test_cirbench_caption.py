"""The `caption` cell at tiny widths on the CPU: the driver against the plain
reference (`cirbench/reference/moonlight.py`), the faults its check has to
catch, the control against the real cell's limits, the FLOP and byte counts
against hand counts, and the real cell found by name from its files."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import REPO

CELL = "llava-moonlight-16b-a3b.caption"
TINY_CELL = "moonlight-tiny.caption-tiny"
TINY_CONFIG = {
    "family": "llava-deepseek_v3", "model_type": "deepseek_v3",
    "hidden_act": "silu", "scoring_func": "sigmoid", "topk_method": "noaux_tc",
    "attention_bias": False, "tie_word_embeddings": False,
    "vocab_size": 512, "hidden_size": 32, "intermediate_size": 64,
    "moe_intermediate_size": 16, "num_hidden_layers": 3,
    "num_attention_heads": 4, "q_lora_rank": None, "kv_lora_rank": 16,
    "qk_nope_head_dim": 8, "qk_rope_head_dim": 8, "v_head_dim": 8,
    "n_routed_experts": 8, "n_shared_experts": 2, "num_experts_per_tok": 3,
    "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "routed_scaling_factor": 2.446, "norm_topk_prob": True, "n_group": 1,
    "topk_group": 1, "rope_theta": 50000, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 512, "dtype": "float32",
    "vision_dtype": "float32",
    "vision": {"image_size": 28, "patch_size": 14, "width": 32, "layers": 3,
               "heads": 4, "select_layer": -2},
    "reduced": []}
TINY_TRAFFIC = {"driver": "caption", "batch": 3, "pixel_batches": 2,
                "category": "image", "num_words": 10, "max_new_tokens": 5,
                "cache_dtype": "float32", "check_rows": 2,
                "profile_batches": 1}
#: float32 on the CPU: the program and the reference differ by round-off
TINY_LIMITS = {"logits_gap": 1e-4, "route_gap": 1e-4, "route_flip_share": 0.05}


@pytest.fixture(scope="module")
def caption_root(tmp_path_factory):
    """A checkout of its own with the tiny caption cell and the real cell's
    metric readers."""
    root = tmp_path_factory.mktemp("caption_checkout")
    bench = root / "cirbench"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(REPO / "cirbench" / "metrics", bench / "metrics")
    (bench / "configs" / "moonlight-tiny.json").write_text(
        json.dumps(TINY_CONFIG))
    (bench / "traffic" / "caption-tiny.json").write_text(
        json.dumps(TINY_TRAFFIC))
    (bench / "limits" / f"{TINY_CELL}.json").write_text(
        json.dumps(TINY_LIMITS))
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    per_layer = [dict(m, workloads=[TINY_CELL]) for m in real["per_layer"]
                 if CELL in m.get("workloads", [])]
    (root / "BENCHMARK.json").write_text(json.dumps({
        "command": real["command"], "paths": real["paths"],
        "run_seconds": 1,
        "configs": [{"name": "moonlight-tiny", "source": "https://example.org",
                     "file": "cirbench/configs/moonlight-tiny.json",
                     "reduced": [], "why": "a CPU test"}],
        "workloads": [{"name": TINY_CELL, "config": "moonlight-tiny",
                       "traffic": "caption-tiny", "chips": 1,
                       "why": "a CPU test"}],
        "end_to_end": [
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"},
            {"name": "extract_images_per_s", "unit": "images/s",
             "better": "higher", "bound": 0.25, "source": "host_clock",
             "workloads": [TINY_CELL]}],
        "per_layer": per_layer}))
    return root


def drive(root, faults=(), trace=False):
    from cirbench import harness
    from cirbench.run import execute

    cell = harness.load_cell(TINY_CELL, root)
    line, checks, ok, out = execute(cell, 2 ** 31 + 977, 0.5, trace, "cpu",
                                    time.perf_counter(), faults)
    parsed = json.loads(line)
    assert parsed["correct"] == ok
    return ok, {c.name: c.value for c in checks}, parsed, out


def test_caption_driver_agrees_with_the_reference(caption_root):
    ok, values, line, out = drive(caption_root, trace=True)
    assert ok, values
    assert line["attempted"] > 0 and line["failed"] == 0
    metrics = line["metrics"]
    assert metrics["caption_mfu"]["value"] > 0
    # no device intervals on the CPU: the device readers stay silent, the
    # spans they read are in the window
    assert "moe_expert_roofline" not in metrics
    assert "long_attention_roofline" not in metrics
    assert "caption.decode_idle_ms" not in metrics
    names = [name for name, _, _ in out["trace"].host]
    steps = TINY_TRAFFIC["max_new_tokens"] - 1
    assert names.count("llm.decode") == steps
    assert names.count("llm.prefill") == names.count("caption.vision") == 1
    assert names.count("moe.experts") == 2 * (steps + 1)
    assert out["detail"]["routes"] == 2 * 2 * 2 * (
        out["shapes"]["prompt_len"] + TINY_TRAFFIC["max_new_tokens"] - 1)


@pytest.mark.parametrize("fault", ["shared", "answer"])
def test_a_broken_caption_path_is_not_correct(caption_root, fault):
    ok, values, _, _ = drive(caption_root, faults=(fault,))
    assert not ok, values
    assert values["logits_gap"] > TINY_LIMITS["logits_gap"]


def test_control_fails_the_cell_limits(caption_root):
    from cirbench import harness
    from cirbench.drivers import caption

    limits = json.loads((REPO / "cirbench" / "limits" /
                         f"{CELL}.json").read_text())
    cell = harness.load_cell(TINY_CELL, caption_root)
    control = caption.calibrate(cell, 31337, "cpu", ["control"])["control"]
    assert any(v > limits[k] for k, v in control.items()), (control, limits)


def test_the_cell_is_found_by_name_from_its_files():
    from cirbench import harness

    cell = harness.load_cell(CELL)
    assert cell.kind == "caption" and cell.chips == 1
    assert set(cell.limits) == {"logits_gap", "route_gap", "route_flip_share"}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                    "extract_images_per_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "caption_mfu", "device_idle.caption", "moe_expert_roofline",
        "caption.decode_idle_ms", "long_attention_roofline"}
    catalog = {
        "vocab_size": 163840, "hidden_size": 2048, "intermediate_size": 11264,
        "moe_intermediate_size": 1408, "num_hidden_layers": 27,
        "num_attention_heads": 16, "kv_lora_rank": 512, "q_lora_rank": None,
        "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
        "n_routed_experts": 64, "n_shared_experts": 2,
        "num_experts_per_tok": 6, "first_k_dense_replace": 1,
        "routed_scaling_factor": 2.446, "rope_theta": 50000,
        "rms_norm_eps": 1e-5, "topk_method": "noaux_tc",
        "scoring_func": "sigmoid", "norm_topk_prob": True}
    assert {k: cell.config[k] for k in catalog} == catalog


def test_the_program_reads_the_configuration_file():
    from spn4cir_tpu_torch.models.deepseek_v3 import DeepseekV3Config

    cfg = json.loads((REPO / "cirbench" / "configs" /
                      "llava-moonlight-16b-a3b.json").read_text())
    assert DeepseekV3Config.from_hf(cfg) == DeepseekV3Config.moonlight_16b_a3b()
    assert all(cfg[k] == v for k, v in
               DeepseekV3Config.moonlight_16b_a3b().to_hf().items())


def test_the_reference_loads_no_program_module():
    code = ("import sys; import cirbench.reference.moonlight, "
            "cirbench.wordtok, cirbench.counts.moonlight; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'spn4cir_tpu_torch', 'spn4cir_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_cell_prompt_is_the_issue_length():
    """The llava_v1 caption prompt through the benchmark's tokenizer: 44
    text tokens before the image (with BOS), 16 after it, long words in
    pieces that decode back to the words."""
    from cirbench.reference.moonlight import prompt_halves
    from cirbench.wordtok import WordTokenizer

    tok = WordTokenizer(163840)
    pre, post = prompt_halves("image", 10)
    assert len(tok.encode(pre)) == 44 and len(tok.encode(post)) - 1 == 16
    assert tok.decode(tok.encode("an artificial intelligence",
                                 add_bos=False)) == \
        "an artificial intelligence"
    assert len(tok.encode("intelligence", add_bos=False)) == 3


@pytest.mark.parametrize("pick", [3, 7])     # the (k+1)-th, the last
def test_route_gap_reads_how_wrong_the_programs_expert_is(pick):
    """At a flip the reference reads its own k-th biased score less the
    lowest it gives an expert the program chose: a program that takes the
    worst-scored expert reads the whole spread, one that takes the
    (k+1)-th reads only the near tie."""
    from cirbench.reference.common import Precision
    from cirbench.reference.moonlight import moe

    n, d, e, k = 5, 8, 8, 3
    g = torch.Generator().manual_seed(pick)
    params = {"m.gate.weight": torch.randn(e, d, generator=g),
              "m.gate.e_score_correction_bias": torch.zeros(e)}
    for name in ("experts.%d." % i for i in range(e)):
        for w, shape in (("gate_proj", (4, d)), ("up_proj", (4, d)),
                         ("down_proj", (d, 4))):
            params[f"m.{name}{w}.weight"] = torch.randn(*shape, generator=g)
    for w, shape in (("gate_proj", (4, d)), ("up_proj", (4, d)),
                     ("down_proj", (d, 4))):
        params[f"m.shared_experts.{w}.weight"] = torch.randn(*shape,
                                                             generator=g)
    cfg = {"num_experts_per_tok": k, "norm_topk_prob": True,
           "routed_scaling_factor": 2.446}
    x = torch.randn(n, d, generator=g)
    biased = torch.sigmoid(x @ params["m.gate.weight"].t())
    order = biased.argsort(-1, descending=True)
    chosen = order[:, :k].clone()
    chosen[0, k - 1] = order[0, pick]                  # row 0 flips
    _, st = moe(params.__getitem__, "m.", x, cfg, Precision(), chosen)
    assert st["flips"] == 1
    want = biased[0, order[0, k - 1]] - biased[0, chosen[0, k - 1]]
    assert st["gap"] == pytest.approx(float(want))
    _, same = moe(params.__getitem__, "m.", x, cfg, Precision(),
                  order[:, :k])
    assert same["flips"] == 0 and same["gap"] == 0.0


# --- counts ---------------------------------------------------------------

def _moonlight():
    return json.loads((REPO / "cirbench" / "configs" /
                       "llava-moonlight-16b-a3b.json").read_text())


@pytest.mark.parametrize("rows,hit,d,i", [(768, 64, 2048, 1408),
                                          (5, 2, 8, 4)])
def test_moe_expert_counts(rows, hit, d, i):
    from cirbench.counts import moonlight as cm

    want_bytes = 2 * (hit * (i * d + i * d + d * i)       # gate, up, down
                      + rows * d + rows * i + rows * i + rows * d)
    want_flops = 2 * rows * (d * i + d * i + i * d)
    assert cm.moe_expert_bytes(rows, hit, d, i) == want_bytes
    assert cm.moe_expert_flops(rows, d, i) == want_flops
    bound = max(want_bytes / 3.35e12, want_flops / 989e12)
    stats = {"small": [rows, hit, 1], "large": [0, 0, 0]}
    assert cm.moe_expert_s(stats, d, i) == pytest.approx(bound)


def test_moe_expert_decode_bound_is_the_weights():
    from cirbench.counts import moonlight as cm

    # one decode layer at batch 128: 64 experts' 17.3 MB each, ~0.33 ms
    s = cm.moe_expert_s({"small": [768, 64, 1]}, 2048, 1408)
    assert 0.33e-3 < s < 0.34e-3


@pytest.mark.parametrize("rows,prompt,steps", [(128, 316, 63), (1, 3, 2)])
def test_caption_counts_by_hand(rows, prompt, steps):
    from cirbench.counts import moonlight as cm

    cfg = _moonlight()
    d, h, v = 2048, 16, 163840
    proj_pre = d * h * 192 + d * 576 + 512 * h * 256 + h * 128 * d
    proj_dec = d * h * 192 + d * 576 + h * 128 * 512 + h * 512 * 128 + h * 128 * d
    dense = 3 * d * 11264
    moe = d * 64 + 3 * d * 1408 * 8
    mlp = dense + 26 * moe
    pre = (rows * prompt * (27 * proj_pre + mlp)
           + 27 * rows * prompt * (prompt + 1) // 2 * h * 320 + rows * d * v)
    attended = sum(prompt + j for j in range(1, steps + 1))
    dec = (rows * steps * (27 * proj_dec + mlp)
           + 27 * rows * attended * h * (512 + 64 + 512) + rows * steps * d * v)
    assert cm.prefill(rows, prompt, cfg) == pytest.approx(2 * pre)
    assert cm.decode(rows, prompt, steps, cfg) == pytest.approx(2 * dec)


def test_caption_batch_is_about_two_hundred_forty_teraflop():
    from cirbench.counts import moonlight as cm

    cfg = _moonlight()
    # 2.24 G multiply-adds a token through the layers, 0.34 G in the head:
    # the tower ~20 TFLOP, the prefill of 128 x 316 ~183, 63 steps ~44
    assert 1.9e13 < cm.tower(128, cfg["vision"], 2048) < 2.1e13
    assert 1.8e14 < cm.prefill(128, 316, cfg) < 1.9e14
    assert 4.2e13 < cm.decode(128, 316, 63, cfg) < 4.6e13
    assert 2.4e14 < cm.caption_batch(128, 316, 64, cfg) < 2.6e14
