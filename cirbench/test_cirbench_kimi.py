"""The `caption_kda` cell at tiny widths on the CPU: the driver against the
plain reference (`cirbench/reference/kimi_linear.py`), the faults its check
has to catch, the controls against the real cell's limits, #15's byte and
FLOP counts against hand counts, and the real cell found by name from its
files."""

from __future__ import annotations

import json
import shutil
import time

import pytest

from conftest import REPO

CELL = "llava-kimi-linear-48b-a3b.caption-b256"
TINY_CELL = "kimi-tiny.caption-tiny"
TINY_CONFIG = {
    "family": "llava-kimi_linear", "model_type": "kimi_linear",
    "hidden_act": "silu", "moe_router_activation_func": "sigmoid",
    "use_grouped_topk": True, "num_nextn_predict_layers": 0,
    "rope_scaling": None, "tie_word_embeddings": False,
    "vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
    "moe_intermediate_size": 32, "num_hidden_layers": 6,
    "num_attention_heads": 4, "num_key_value_heads": 4, "q_lora_rank": None,
    "kv_lora_rank": 16, "qk_nope_head_dim": 8, "qk_rope_head_dim": 8,
    "v_head_dim": 8, "num_experts": 4, "published": {"num_experts": 8},
    "first_expert_held": 0, "num_shared_experts": 1,
    "num_experts_per_token": 2, "first_k_dense_replace": 1,
    "moe_layer_freq": 1, "routed_scaling_factor": 2.446,
    "moe_renormalize": True, "num_expert_group": 1, "topk_group": 1,
    "rope_theta": 10000, "rms_norm_eps": 1e-5, "model_max_length": 512,
    "mla_use_nope": True,
    "linear_attn_config": {"kda_layers": [1, 2, 3, 5],
                           "full_attn_layers": [4, 6], "num_heads": 4,
                           "head_dim": 16, "short_conv_kernel_size": 4},
    "dtype": "float32", "vision_dtype": "float32",
    "vision": {"image_size": 28, "patch_size": 14, "width": 32, "layers": 3,
               "heads": 4, "select_layer": -2},
    "reduced": ["num_experts"]}
TINY_TRAFFIC = {"driver": "caption_kda", "batch": 3, "pixel_batches": 2,
                "category": "image", "num_words": 10, "max_new_tokens": 4,
                "cache_dtype": "float32", "check_rows": 2,
                "profile_batches": 1}
#: float32 on the CPU: the program and the reference differ by round-off
TINY_LIMITS = {"logits_gap": 1e-4, "route_gap": 1e-4, "route_flip_share": 0.05,
               "recurrence_gap": 1e-5, "kda_inputs_gap": 1e-5}


@pytest.fixture(scope="module")
def kimi_root(tmp_path_factory):
    """A checkout of its own with the tiny cell and the real cell's metric
    readers."""
    root = tmp_path_factory.mktemp("kimi_checkout")
    bench = root / "cirbench"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(REPO / "cirbench" / "metrics", bench / "metrics")
    (bench / "configs" / "kimi-tiny.json").write_text(json.dumps(TINY_CONFIG))
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
        "configs": [{"name": "kimi-tiny", "source": "https://example.org",
                     "file": "cirbench/configs/kimi-tiny.json",
                     "reduced": ["num_experts"], "why": "a CPU test"}],
        "workloads": [{"name": TINY_CELL, "config": "kimi-tiny",
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
    line, checks, ok, out = execute(cell, 2 ** 31 + 4099, 0.5, trace, "cpu",
                                    time.perf_counter(), faults)
    parsed = json.loads(line)
    assert parsed["correct"] == ok
    return ok, {c.name: c.value for c in checks}, parsed, out


def test_kda_driver_agrees_with_the_reference(kimi_root):
    ok, values, line, out = drive(kimi_root, trace=True)
    assert ok, values
    assert line["attempted"] > 0 and line["failed"] == 0
    metrics = line["metrics"]
    assert metrics["kimi_linear_caption_mfu"]["value"] > 0
    # no device intervals on the CPU: the device readers stay silent
    for name in ("kda_decode_roofline", "kda_prefill_roofline",
                 "moe_expert_roofline", "long_attention_roofline",
                 "caption.decode_idle_ms"):
        assert name not in metrics
    names = [name for name, _, _ in out["trace"].host]
    steps = TINY_TRAFFIC["max_new_tokens"] - 1
    assert names.count("llm.decode") == steps
    assert names.count("kda.attend") == names.count("kda.recur") == 4 * (
        steps + 1)
    assert names.count("mla.attend") == 2 * (steps + 1)
    assert names.count("moe.experts") == 5 * (steps + 1)
    # the CPU runs #15's and #14's plain versions, which count nothing
    assert out["counters"]["kda_decode"] == out["counters"]["kda_prefill"] == 0
    assert out["detail"]["routes"] == 2 * 2 * 5 * (
        out["shapes"]["prompt_len"] + TINY_TRAFFIC["max_new_tokens"] - 1)


@pytest.mark.parametrize("fault,caught", [
    ("shared", "logits_gap"), ("answer", "logits_gap"),
    ("state", "logits_gap"), ("state_bf16", "recurrence_gap"),
    ("state_bf16_decode", "recurrence_gap"), ("conv", "kda_inputs_gap")])
def test_a_broken_kda_caption_path_is_not_correct(kimi_root, fault, caught):
    ok, values, _, _ = drive(kimi_root, faults=(fault,))
    assert not ok, values
    assert values[caught] > TINY_LIMITS[caught]


def test_controls_fail_the_cell_limits(kimi_root):
    """Every control fails the real cell's limits: the float8 reference in
    the program's place, and the program with a bf16 state in #15's place
    or in its decode entry alone (the latter two by `recurrence_gap`: their
    logits move less than the program's bf16 projections move them)."""
    from cirbench import harness
    from cirbench.drivers import caption_kda

    limits = json.loads((REPO / "cirbench" / "limits" /
                         f"{CELL}.json").read_text())
    cell = harness.load_cell(TINY_CELL, kimi_root)
    got = caption_kda.calibrate(cell, 31337, "cpu", ["control"])
    assert set(got) == {"control", "control_state_bf16",
                        "control_state_bf16_decode"}
    assert any(v > limits[k] for k, v in got["control"].items()), got
    for name in ("control_state_bf16", "control_state_bf16_decode"):
        assert got[name]["recurrence_gap"] > limits["recurrence_gap"], got


def test_the_cell_is_found_by_name_from_its_files():
    from cirbench import harness
    from spn4cir_tpu_torch.models.deepseek_v3 import DeepseekV3Config

    cell = harness.load_cell(CELL)
    assert cell.kind == "caption_kda" and cell.chips == 1
    assert set(cell.limits) == {"logits_gap", "route_gap", "route_flip_share",
                                "recurrence_gap", "kda_inputs_gap"}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                    "extract_images_per_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "device_idle.caption", "moe_expert_roofline", "caption.decode_idle_ms",
        "long_attention_roofline", "kda_decode_roofline",
        "kda_prefill_roofline", "kimi_linear_caption_mfu"}
    assert cell.traffic["batch"] == 256
    cfg = DeepseekV3Config.from_hf(cell.config)
    assert cfg == DeepseekV3Config.kimi_linear_48b_a3b(experts_held=64)
    catalog = {
        "vocab_size": 163840, "hidden_size": 2304, "intermediate_size": 9216,
        "moe_intermediate_size": 1024, "num_hidden_layers": 27,
        "num_attention_heads": 32, "kv_lora_rank": 512, "q_lora_rank": None,
        "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
        "num_experts": 64, "num_shared_experts": 1,
        "num_experts_per_token": 8, "first_k_dense_replace": 1,
        "routed_scaling_factor": 2.446, "mla_use_nope": True,
        "moe_router_activation_func": "sigmoid", "moe_renormalize": True}
    assert {k: cell.config[k] for k in catalog} == catalog
    assert cell.config["published"] == {"num_experts": 256}
    assert cell.config["reduced"] == ["num_experts"]


@pytest.mark.parametrize("rows,tokens,heads,d", [(256, 1, 32, 128),
                                                 (3, 5, 2, 4)])
def test_kda_counts(rows, tokens, heads, d):
    from cirbench.counts import kimi_linear as ck

    state = rows * heads * d * d * 4
    io = rows * tokens * heads * (4 * d + 1 + d) * 4      # q k g v, β; o
    assert ck.kda_bytes(rows, tokens, heads, d, True) == 2 * state + io
    assert ck.kda_bytes(rows, tokens, heads, d, False) == state + io
    assert ck.recurrence_flops(rows * tokens, heads, d) == \
        7 * rows * tokens * heads * d * d
    bound = max((2 * state + io) / 3.35e12,
                7 * rows * heads * d * d / 989e12)
    if tokens == 1:
        assert ck.kda_decode_s(rows, heads, d) == pytest.approx(bound)


def test_kda_decode_bound_is_the_state():
    from cirbench.counts import kimi_linear as ck

    # 256 x 32 states of 64 KB, read and written: 1.07 GB, ~0.33 ms
    assert 0.32e-3 < ck.kda_decode_s(256, 32, 128) < 0.33e-3
    # the prefill of 256 x 316 tokens reads 5.3 GB of inputs: ~2.1 ms
    assert 2.0e-3 < ck.kda_prefill_s(256, 316, 32, 128) < 2.2e-3


def test_caption_batch_is_about_three_hundred_eighty_teraflop():
    from cirbench.counts import kimi_linear as ck

    cfg = json.loads((REPO / "cirbench" / "configs" /
                      "llava-kimi-linear-48b-a3b.json").read_text())
    # 1.66 G multiply-adds a token through the layers at the held share
    # (2 of 8 routed experts a token on average), 0.38 G in the head
    assert 3.9e13 < ck.tower(256, cfg["vision"], 2304) < 4.1e13
    assert 2.6e14 < ck.prefill(256, 316, cfg) < 2.8e14
    assert 6.5e13 < ck.decode(256, 316, 63, cfg) < 7.0e13
    assert 3.7e14 < ck.caption_batch(256, 316, 64, cfg) < 3.9e14
