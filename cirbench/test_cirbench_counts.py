"""The FLOP and byte counters against counts made by hand, at two shapes
each."""

from __future__ import annotations

import pytest

from cirbench.counts import kernels, model, peaks


@pytest.mark.parametrize("b,ctx,w,layers,bank,d", [
    (256, 77, 640, 12, 65536, 640),     # clip4cir RN50x4
    (4, 5, 8, 1, 10, 3),                # small enough to count by hand
])
def test_clip_text_step(b, ctx, w, layers, bank, d):
    tokens = b * ctx
    per_layer = (2 * tokens * 3 * w * w        # qkv
                 + 2 * tokens * w * w          # out projection
                 + 2 * tokens * w * 4 * w * 2  # the MLP's two matrices
                 + 2 * 2 * b * (ctx * (ctx + 1) // 2) * w)  # causal scores, values
    fwd = layers * per_layer + 2 * b * w * w   # the projection of pooled rows
    want = 3 * fwd + 2 * b * bank * d + 2 * b * bank * d
    assert model.clip_text_step(b, ctx, w, layers, w, bank, d) == want


def test_clip_text_step_rn50x4_is_about_seven_teraflop():
    f = model.clip_text_step(256, 77, 640, 12, 640, 65536, 640)
    assert 7.0e12 < f < 7.2e12


@pytest.mark.parametrize("bh,s,d,causal,dtype", [
    (2560, 77, 64, True, "bfloat16"),
    (512, 257, 88, False, "bfloat16"),
])
def test_attention_bounds(bh, s, d, causal, dtype):
    pairs = s * (s + 1) // 2 if causal else s * s
    fwd = max(4 * bh * s * d * 2 / 3.35e12, 4 * pairs * d * bh / 989e12)
    bwd = max(7 * bh * s * d * 2 / 3.35e12, 10 * pairs * d * bh / 989e12)
    assert kernels.attention_fwd_s(bh, s, d, causal, dtype) == pytest.approx(fwd)
    assert kernels.attention_bwd_s(bh, s, d, causal, dtype) == pytest.approx(bwd)


def test_eva_attention_bound_matches_the_kernel_table():
    # PERF.md: EVA-g (512, 257, 88) bf16 -> 92.6 MB, 0.02765 ms by bytes
    assert kernels.attention_fwd_s(512, 257, 88, False, "bfloat16") == \
        pytest.approx(0.02765e-3, rel=1e-3)


@pytest.mark.parametrize("b,m,d,dtype,terms,item", [
    (256, 65536, 640, "float32", 3, 4),
    (128, 2049, 256, "bfloat16", 2, 2),
])
def test_bank_infonce_bound(b, m, d, dtype, terms, item):
    fwd = max((m * d * item + b * d * 4) / 3.35e12, terms * 2 * b * m * d / 495e12)
    bwd = max((m * d * item + 2 * b * d * 4) / 3.35e12,
              terms * 4 * b * m * d / 495e12)
    assert kernels.bank_infonce_s(b, m, d, dtype) == pytest.approx(fwd + bwd)


def test_bank_infonce_bound_matches_the_kernel_table():
    # PERF.md: D=640 split TF32, fwd 0.13015 ms + bwd 0.26030 ms
    assert kernels.bank_infonce_s(256, 65536, 640, "float32") == \
        pytest.approx((0.13015 + 0.26030) * 1e-3, rel=1e-3)


@pytest.mark.parametrize("b,m,q,d", [(32, 65536, 32, 256), (2, 3, 4, 5)])
def test_max_query_bound(b, m, q, d):
    fwd = max((m * q * d * 4 + b * m * 4 * 2) / 3.35e12,
              3 * 2 * b * m * q * d / 495e12)
    bwd = max((b * m * 4 * 2 + m * d * 4) / 3.35e12, 2 * b * m * d / 67e12)
    assert kernels.max_query_s(b, m, q, d, "float32", m) == pytest.approx(fwd + bwd)


@pytest.mark.parametrize("images", [32, 1])
def test_blip2_bank_features(images):
    vision = {"image_size": 224, "patch_size": 14, "width": 1408,
              "layers": 39, "heads": 16, "mlp_ratio": 4.3637}
    q = {"hidden_size": 768, "num_layers": 12, "num_heads": 12,
         "intermediate_size": 3072, "num_query_tokens": 32,
         "cross_attention_freq": 2}
    t, w, mlp = 257, 1408, 6144
    vit = (2 * 256 * 588 * w
           + 39 * (2 * t * (4 * w * w + 2 * w * mlp) + 4 * t * t * w))
    qf = 0
    for s in (64, 32):
        qf += 12 * (2 * s * (4 * 768 * 768 + 2 * 768 * 3072) + 4 * s * s * 768)
        qf += 6 * (2 * 32 * 2 * 768 * 768 + 2 * t * 2 * w * 768
                   + 4 * 32 * t * 768)
    want = images * (vit + qf + 2 * 32 * 768 * 256)
    got = model.blip2_bank_features(images, vision, q, 32, 256)
    assert got == pytest.approx(want)
    assert 5.0e11 < got / images < 5.6e11


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(3.35e12, 0, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(0, 989e12, "bfloat16") == pytest.approx(1.0)
