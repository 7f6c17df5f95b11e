"""Tests of the port that need an NVIDIA GPU: the CUDA kernels have no CPU
mode. They are marked `cuda` and skip elsewhere. This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances. Attention forward: float32 atol = rtol = 1e-5 (summation order
only); bf16 atol = rtol = 2e-2 (P is rounded to bf16 before P·V in both
versions). Attention backward: float32 1e-4 (sums of up to 128 products of
O(1) values in another order), bf16 5e-2 (P and dS are rounded to bf16
before their products in both versions; one rounding step that falls the
other way moves an output by up to 2^-8 of its value, and the outputs are
themselves stored in bf16). Bank InfoNCE: statistics, loss, dQ and dtau
within 1e-4 relative (float32 sums over up to 65,536 bank rows in another
order), with an absolute floor of 1e-6 for dQ. The long-sequence attention
holds the same four tolerances: its forward rounds the un-normalised P
(online softmax) where the plain version rounds the normalised one, both
one bf16 rounding of a value in [0, 1]; its backward takes rowsum(dO∘O) for
the plain version's rowsum(dP∘P), equal in exact arithmetic.
"""

import pytest
import torch

from spn4cir_tpu_torch.models import clip as tclip
from spn4cir_tpu_torch.models import layers
from spn4cir_tpu_torch.ops import bank_kernels as bk
from spn4cir_tpu_torch.ops.attention_kernels import (
    long_attention, long_attention_bwd, long_attention_bwd_reference,
    long_attention_fwd, long_attention_reference, short_attention,
    short_attention_bwd, short_attention_bwd_reference,
    short_attention_reference, short_route)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,causal", [
    (3072, 50, 64, False), (256, 77, 64, True), (3, 29, 16, True),
    (4, 128, 128, False)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_version_on_card(cuda_device, bh, s, d, causal,
                                              dtype, tol):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device,
                           dtype=dtype) for _ in range(3))
    q = q * d ** -0.5
    before = short_attention.launches
    with torch.inference_mode():
        got = short_attention(q, k, v, causal)
        torch.cuda.synchronize()
        want = short_attention_reference(q, k, v, causal)
    assert short_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# the edges of the bf16 tensor-core kernels (slices padded to 64, 80 or 128
# rows, head dims to 64 or 128), at a BH that is no multiple of anything and
# at one past the blocks the card holds at once
SHORT_EDGES = [(bh, s, d, causal) for bh in (5, 1001)
               for s in (1, 15, 16, 17, 50, 77, 128) for d in (8, 64, 72, 128)
               for causal in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,causal", [
    (2048, 77, 64, True), (3072, 50, 64, False), (3, 29, 16, True),
    (5, 17, 40, False), (2, 117, 64, True), (2, 128, 64, True),
    (3, 128, 128, False), (3, 128, 128, True), (2, 96, 128, True)]
    + SHORT_EDGES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_backward_kernel_matches_plain_version_on_card(cuda_device, bh, s, d,
                                                       causal, dtype, tol):
    """bf16 at a head dim % 8 == 0 on the tensor cores, the rest on the
    CUDA cores: within the tolerance of the plain backward, one launch
    counted, and a second launch gives the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(bh, s, d, generator=g, device=cuda_device,
                               dtype=dtype) for _ in range(4))
    q = q * d ** -0.5
    assert short_route(dtype, d, True) == (
        "tensor_cores" if dtype == torch.bfloat16 and d % 8 == 0
        else "cuda_cores")
    before = short_attention_bwd.launches
    got = short_attention_bwd(q, k, v, do, causal)
    torch.cuda.synchronize()
    assert short_attention_bwd.launches == before + 1
    again = short_attention_bwd(q, k, v, do, causal)
    want = short_attention_bwd_reference(q, k, v, do, causal)
    for a, a2, b in zip(got, again, want):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_layer_trains_through_the_kernels_at_the_longest_slice(cuda_device):
    """A self-attention layer at S = 128, head_dim = 128 under autograd goes
    through both kernels, as every slice the forward takes does."""
    attn = layers.MultiHeadAttention(256, 2, causal=True).to(cuda_device)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    x = torch.randn(3, 128, 256, generator=g).to(cuda_device)
    grads = []
    before = (short_attention.launches, short_attention_bwd.launches)
    for impl in ("auto", "plain"):
        attn.fused = impl
        attn.zero_grad()
        attn(x).square().sum().backward()
        grads.append(attn.in_proj_weight.grad.clone())
    assert (short_attention.launches, short_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_attention_is_differentiable_through_the_kernels(cuda_device):
    """autograd through `short_attention` launches both kernels and agrees
    with autograd through the plain version (float32)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(16, 77, 64, generator=g, device=cuda_device)
               for _ in range(3))
    w = torch.randn(16, 77, 64, generator=g, device=cuda_device)
    grads = []
    before = (short_attention.launches, short_attention_bwd.launches)
    for fn in (short_attention, short_attention_reference):
        leaves = [t.clone().requires_grad_() for t in (q * 0.125, k, v)]
        (fn(*leaves, True) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    assert (short_attention.launches, short_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _bank_case(device, b, m, d, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.nn.functional.normalize(
        torch.randn(b, d, generator=g, device=device), dim=-1)
    bank = torch.nn.functional.normalize(
        torch.randn(m, d, generator=g, device=device), dim=-1).to(dtype)
    labels = torch.randint(0, m, (b,), generator=g, device=device)
    return q, bank, labels


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,d", [(256, 2049, 512), (256, 65536, 512),
                                   (5, 2049, 512), (9, 130, 16),
                                   (64, 128, 64), (70, 4000, 256),
                                   (256, 65536, 640), (5, 2049, 640),
                                   (70, 4001, 768), (3, 300, 1040),
                                   (33, 1000, 240)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bank_infonce_kernels_match_plain_versions_on_card(cuda_device, b, m,
                                                           d, dtype):
    """Kernels 5 and 6 against their plain versions; the forward forms its
    logits on the tensor cores from D = 256 on and on the CUDA cores below
    (D = 240, 64, 16), by the backward's rule."""
    q, bank, labels = _bank_case(cuda_device, b, m, d, dtype)
    tau = 0.02
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert bk.fwd_plan(b, m, d, sms).tc_logits == (d >= 256) == \
        bk.bwd_plan(b, m, d, sms).tc_logits
    before = (bk.bank_infonce_fwd.launches, bk.bank_infonce_bwd.launches)
    loss, stats, dtau = bk.bank_infonce_fwd(q, bank, labels, tau)
    gout = torch.tensor(1.5, device=cuda_device)
    dq = bk.bank_infonce_bwd(q, bank, labels, tau, stats[0], stats[1], gout)
    torch.cuda.synchronize()
    assert (bk.bank_infonce_fwd.launches, bk.bank_infonce_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = bk.bank_infonce_stats_reference(q, bank, labels, tau)
    # mx and pos are single logits; se and el are sums over the bank
    for got_s, want_s in zip(stats, want):
        torch.testing.assert_close(got_s, want_s, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        loss, bk.bank_infonce_reference(q, bank, labels, tau),
        atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dtau, bk.dtau_from_stats(want, tau),
                               atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(
        dq, bk.bank_infonce_bwd_reference(q, bank, labels, tau, want[0],
                                          want[1], gout),
        atol=1e-6, rtol=1e-4)
    # every sum has a fixed order: a second launch gives the same bits
    loss2, _, _ = bk.bank_infonce_fwd(q, bank, labels, tau)
    dq2 = bk.bank_infonce_bwd(q, bank, labels, tau, stats[0], stats[1], gout)
    assert torch.equal(loss, loss2) and torch.equal(dq, dq2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,d", [(33, 1000, 240), (33, 1000, 256),
                                   (256, 4097, 768), (5, 300, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_dense_bank_backward_takes_either_logits_route_on_card(cuda_device, b,
                                                               m, d, dtype):
    """The backward, over a dense or an int8 bank (a QuantBank of the same
    rows, through `bank_infonce_q8_bwd`), forms its logits in split TF32 on
    the tensor cores from D = 256 on and in float32 FMAs below; the dQ
    product runs in split TF32 at every D. Either way dQ holds the bank
    tolerance against the plain version, the wrapper counts one launch, and
    a second call gives the same bits."""
    quant = dtype == torch.int8
    q, bank, labels = _bank_case(cuda_device, b, m, d,
                                 torch.float32 if quant else dtype, seed=3)
    if quant:
        bank = bk.quantize_bank(bank)
        bwd, ref = bk.bank_infonce_q8_bwd, bk.bank_infonce_q8_bwd_reference
        stats = bk.bank_infonce_q8_stats_reference(q, bank, labels, 0.02)
    else:
        bwd, ref = bk.bank_infonce_bwd, bk.bank_infonce_bwd_reference
        stats = bk.bank_infonce_stats_reference(q, bank, labels, 0.02)
    tau = 0.02
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert bk.bwd_plan(b, m, d, sms).tc_logits == (d >= 256)
    gout = torch.tensor(1.5, device=cuda_device)
    before = bwd.launches
    dq = bwd(q, bank, labels, tau, stats[0], stats[1], gout)
    dq2 = bwd(q, bank, labels, tau, stats[0], stats[1], gout)
    torch.cuda.synchronize()
    assert bwd.launches == before + 2
    assert torch.equal(dq, dq2)
    torch.testing.assert_close(
        dq, ref(q, bank, labels, tau, stats[0], stats[1], gout),
        atol=1e-6, rtol=1e-4)


@pytest.mark.cuda
def test_bank_infonce_autograd_on_card(cuda_device):
    """`bank_infonce` on CUDA tensors: loss, dQ (cast back to a bf16 query's
    dtype) and dtau through the kernels against autograd through the plain
    version."""
    q, bank, labels = _bank_case(cuda_device, 32, 3000, 128, torch.float32, 1)
    grads = []
    for fn in (bk.bank_infonce, bk.bank_infonce_reference):
        qq = q.clone().requires_grad_()
        tau = torch.tensor(0.05, device=cuda_device, requires_grad=True)
        loss = fn(qq, bank, labels, tau)
        loss.backward()
        grads.append((loss.detach(), qq.grad, tau.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    q16 = q.to(torch.bfloat16).requires_grad_()
    bk.bank_infonce(q16, bank, labels, 0.05).backward()
    assert q16.grad.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="QuantBank"):
        bk.bank_infonce_q8_fwd(q, bank, labels, 0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,d", [(256, 65536, 640), (5, 2049, 512),
                                   (9, 130, 16), (70, 4001, 768),
                                   (64, 128, 64), (3, 300, 1040),
                                   (33, 1000, 240)])
def test_int8_bank_kernels_match_plain_versions_on_card(cuda_device, b, m, d):
    """Kernels 7 and 8 against their plain versions (scales after the
    product), the tail of the scale buffer poisoned behind a view: rows past
    M must contribute nothing. Both forward routes: the tensor cores from
    D = 256 on, the CUDA cores below."""
    q, bank, labels = _bank_case(cuda_device, b, m, d, torch.float32)
    full = bk.quantize_bank(bank)
    scales = torch.full((m + 200,), float("nan"), device=cuda_device)
    scales[:m] = full.scales
    qbank = bk.QuantBank(full.values, scales[:m])
    tau = 0.02
    before = (bk.bank_infonce_q8_fwd.launches, bk.bank_infonce_q8_bwd.launches,
              bk.bank_infonce_fwd.launches, bk.bank_infonce_bwd.launches)
    loss, stats, dtau = bk.bank_infonce_q8_fwd(q, qbank, labels, tau)
    gout = torch.tensor(1.5, device=cuda_device)
    dq = bk.bank_infonce_q8_bwd(q, qbank, labels, tau, stats[0], stats[1], gout)
    torch.cuda.synchronize()
    assert (bk.bank_infonce_q8_fwd.launches, bk.bank_infonce_q8_bwd.launches,
            bk.bank_infonce_fwd.launches, bk.bank_infonce_bwd.launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    want = bk.bank_infonce_q8_stats_reference(q, qbank, labels, tau)
    for got_s, want_s in zip(stats, want):
        torch.testing.assert_close(got_s, want_s, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        loss, bk.bank_infonce_q8_reference(q, qbank, labels, tau),
        atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dtau, bk.dtau_from_stats(want, tau),
                               atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(
        dq, bk.bank_infonce_q8_bwd_reference(q, qbank, labels, tau, want[0],
                                             want[1], gout),
        atol=1e-6, rtol=1e-4)
    loss2, _, _ = bk.bank_infonce_q8_fwd(q, qbank, labels, tau)
    dq2 = bk.bank_infonce_q8_bwd(q, qbank, labels, tau, stats[0], stats[1],
                                 gout)
    assert torch.equal(loss, loss2) and torch.equal(dq, dq2)


@pytest.mark.cuda
def test_int8_bank_infonce_autograd_on_card(cuda_device):
    """`bank_infonce` on a CUDA QuantBank goes through kernels 7 and 8 and
    agrees with autograd through the plain version."""
    q, bank, labels = _bank_case(cuda_device, 32, 3000, 640, torch.float32, 1)
    qbank = bk.quantize_bank(bank)
    grads = []
    before = (bk.bank_infonce_q8_fwd.launches, bk.bank_infonce_q8_bwd.launches)
    for fn in (bk.bank_infonce, bk.bank_infonce_q8_reference):
        qq = q.clone().requires_grad_()
        tau = torch.tensor(0.05, device=cuda_device, requires_grad=True)
        loss = fn(qq, qbank, labels, tau)
        loss.backward()
        grads.append((loss.detach(), qq.grad, tau.grad))
    assert (bk.bank_infonce_q8_fwd.launches,
            bk.bank_infonce_q8_bwd.launches) == (before[0] + 1, before[1] + 1)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    q16 = q.to(torch.bfloat16).requires_grad_()
    bk.bank_infonce(q16, qbank, labels, 0.05).backward()
    assert q16.grad.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="dense"):
        bk.bank_infonce_fwd(q, qbank, labels, 0.05)


@pytest.mark.cuda
def test_towers_kernel_route_matches_plain_route_on_card(cuda_device):
    """ViT/32 at 224 (S=50) and the causal text tower (S=77), 2 layers,
    head_dim 64, float32: every attention layer launches the kernel."""
    cfg = tclip.CLIPConfig(embed_dim=64, image_resolution=224, vision_layers=2,
                           vision_width=128, vision_patch_size=32,
                           transformer_width=128, transformer_heads=2,
                           transformer_layers=2)
    model = tclip.CLIP(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    images = torch.randn(3, 224, 224, 3, generator=g, device=cuda_device)
    ids = torch.randint(1, 49000, (3, 77), generator=g, device=cuda_device)
    ids[:, 40] = 49407                                  # EOT
    before = short_attention.launches
    with torch.inference_mode():
        kern = (model.encode_image(images), model.encode_text(ids))
        assert short_attention.launches == before + 4
        layers.set_attention_impl(model, "plain")
        plain = (model.encode_image(images), model.encode_text(ids))
    for a, b in zip(kern, plain):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_tgcir_stage2_step_takes_the_kernels_on_card(cuda_device):
    """tgcir at ViT-B/16's widths, two layers a tower, float32: its index
    encode launches the long attention (S=197) in each vision layer, its
    stage-2 loss the short attention forward and backward in each text
    layer and one bank forward and backward; the loss equals the plain
    route's within the bank tolerance (1e-4 relative), each gradient within
    2e-3 of its norm (phase 8's bound on the same comparison)."""
    from spn4cir_tpu_torch.models.tgcir import TgcirCIR
    from spn4cir_tpu_torch.train.stage2 import create_train_state

    cfg = tclip.CLIPConfig(512, 224, 2, 768, 16, transformer_width=512,
                           transformer_heads=8, transformer_layers=2)
    tclip.CLIP_CONFIGS["card-tgcir"] = cfg
    try:
        tb = TgcirCIR("card-tgcir", device=cuda_device)
    finally:
        del tclip.CLIP_CONFIGS["card-tgcir"]
    tb.init_params(torch.Generator().manual_seed(0))
    create_train_state(tb, 2e-5)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    images = torch.randn(3, 224, 224, 3, generator=g, device=cuda_device)
    before = long_attention.launches
    with torch.inference_mode():
        index = tb.index_features(images)
    assert long_attention.launches == before + 2
    assert index["refer"].shape == (3, 12, 512)
    bank = torch.nn.functional.normalize(
        torch.randn(1000, 512, generator=g, device=cuda_device), dim=-1)
    refer = torch.randn(8, 12, 512, generator=g, device=cuda_device)
    labels = torch.randint(0, 1000, (8,), generator=g, device=cuda_device)
    ids = torch.randint(1, 49000, (8, 77), generator=g, device=cuda_device)
    ids[:, 30] = 49407                                  # EOT
    counts = (short_attention, short_attention_bwd, bk.bank_infonce_fwd,
              bk.bank_infonce_bwd)
    before = [c.launches for c in counts]
    loss = tb.stage2_loss(refer, ids, bank, labels)
    loss.backward()
    assert [c.launches - b for c, b in zip(counts, before)] == [2, 2, 1, 1]
    grads = {n: p.grad.clone() for n, p in tb.named_parameters()
             if p.grad is not None}
    tb.zero_grad(set_to_none=True)
    layers.set_attention_impl(tb, "plain")
    plain = bk.bank_infonce_reference(tb.fuse(refer, ids), bank, labels,
                                      tb.tau)
    plain.backward()
    torch.testing.assert_close(loss, plain, atol=0, rtol=1e-4)
    assert "model.masks_text.weight" in grads
    for name, p in tb.named_parameters():
        if name in grads:
            rel = (grads[name] - p.grad).norm() / p.grad.norm()
            assert rel < 2e-3, (name, rel.item())


# the long-sequence shapes of the card's smoke run: BLIP's ViT-B/16 at 384
# (extraction and index batches), ViT-L/14 (at 32 images, and zscir's stage
# 1: 96 images, batch 48), EVA-g (head_dim 88), ViT-B/16 at 224, a ragged
# slice; then head_dim 128, one key tile and one key; then the
# edges of the bf16 kernels' tiles (64 query rows or keys a block, 64 keys /
# 32 query rows a ring stage): one partial tile, a one-row query tile and a
# one-key key tile in one slice, a one-key stage in both walks; last LLaVA's
# tower (ViT-L/14 over a group of 16)
LONG_SHAPES = [(1536, 577, 64), (384, 577, 64), (512, 257, 64),
               (1536, 257, 64), (256, 257, 88), (384, 197, 64), (5, 130, 40), (3, 300, 128),
               (2, 64, 8), (2, 1, 16), (3, 63, 64), (1, 65, 64),
               (2, 129, 88), (256, 257, 64)]


def _long_inputs(bh, s, d, dtype, device, n=3, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    ts = [torch.randn(bh, s, d, generator=g, device=device, dtype=dtype)
          for _ in range(n)]
    ts[0] = ts[0] * d ** -0.5
    return ts


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d", LONG_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_long_attention_matches_plain_version_on_card(cuda_device, bh, s, d,
                                                      dtype, tol):
    q, k, v = _long_inputs(bh, s, d, dtype, cuda_device)
    before = long_attention.launches
    with torch.inference_mode():
        got = long_attention(q, k, v)
        again = long_attention(q, k, v)
    assert long_attention.launches == before + 2
    want = long_attention_reference(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got, again), "two launches differ"
    _, lse = long_attention_fwd(q, k, v)
    want_lse = torch.logsumexp(q.float() @ k.float().transpose(-1, -2), -1)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d", LONG_SHAPES[1:])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_long_attention_backward_matches_plain_version_on_card(
        cuda_device, bh, s, d, dtype, tol):
    """Against the plain backward and against float32 autograd through the
    plain forward; two launches give the same bits."""
    q, k, v, do = _long_inputs(bh, s, d, dtype, cuda_device, n=4, seed=1)
    out, lse = long_attention_fwd(q, k, v)
    before = long_attention_bwd.launches
    got = long_attention_bwd(q, k, v, do, out, lse)
    again = long_attention_bwd(q, k, v, do, out, lse)
    assert long_attention_bwd.launches == before + 2
    want = long_attention_bwd_reference(q, k, v, do)
    exact = [t.to(torch.float32, copy=True).requires_grad_()
             for t in (q, k, v)]
    auto = torch.autograd.grad(long_attention_reference(*exact), exact,
                               do.float())
    for a, a2, b, c in zip(got, again, want, auto):
        assert torch.equal(a, a2), "two launches differ"
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(a.float(), c.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,btol", [(torch.float32, 1e-5, 1e-4),
                                            (torch.bfloat16, 2e-2, 5e-2)])
def test_long_attention_takes_every_head_dim_on_card(cuda_device, dtype, tol,
                                                     btol):
    """Every D in 8..128 step 8 at S = 100 (a partial tile), forward and
    backward against the plain versions: each padded depth of the bf16
    kernels (64, 96, 128) and both depth classes of the float32 ones, with
    the zeroed pad columns."""
    for d in range(8, 129, 8):
        q, k, v, do = _long_inputs(3, 100, d, dtype, cuda_device, n=4,
                                   seed=d)
        out, lse = long_attention_fwd(q, k, v)
        want = long_attention_reference(q, k, v)
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol, msg=f"D={d}")
        got = long_attention_bwd(q, k, v, do, out, lse)
        for a, b in zip(got, long_attention_bwd_reference(q, k, v, do)):
            torch.testing.assert_close(a.float(), b.float(), atol=btol,
                                       rtol=btol, msg=f"D={d}")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 15, 16, 17, 50, 77, 128])
@pytest.mark.parametrize("d", [8, 64, 72, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_short_attention_tensor_core_edges_on_card(cuda_device, s, d, causal):
    """bf16 short attention on the tensor cores at the edges of its padding
    (slices padded to 64, 80 or 128 rows, head dims to 64 or 128), within
    2e-2 of the plain version; two launches give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(s * 1000 + d)
    q, k, v = (torch.randn(5, s, d, generator=g, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    q = q * d ** -0.5
    assert short_route(q.dtype, d, True) == "tensor_cores"
    with torch.inference_mode():
        got = short_attention(q, k, v, causal)
        again = short_attention(q, k, v, causal)
        torch.cuda.synchronize()
        want = short_attention_reference(q, k, v, causal)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,causal", [(1001, 77, True), (1001, 50, False),
                                         (1, 77, True), (397, 128, True)])
def test_short_attention_walks_more_slices_than_blocks_on_card(cuda_device, bh,
                                                               s, causal):
    """The tensor-core forward launches at most as many blocks as the card
    holds at once, each walking its slices through a two-stage ring: a BH
    past that, and a single slice, come out as the plain version does."""
    g = torch.Generator(device=cuda_device).manual_seed(bh)
    q, k, v = (torch.randn(bh, s, 64, generator=g, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    q = q * 0.125
    before = short_attention.launches
    with torch.inference_mode():
        got = short_attention(q, k, v, causal)
        torch.cuda.synchronize()
        want = short_attention_reference(q, k, v, causal)
    assert short_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_short_attention_bf16_refuses_a_misaligned_tensor(cuda_device):
    """The tensor-core forward copies with 16-byte cp.async: a bf16 tensor
    whose data starts off a 16-byte boundary is refused, never sent to the
    plain version; at a head dim that is no multiple of 8 the CUDA-core
    kernel takes it."""
    for d, refused in ((64, True), (12, False)):
        flat = torch.randn(3 * 77 * d + 1, device=cuda_device).to(
            torch.bfloat16)
        odd = flat[1:].view(3, 77, d)
        ok = torch.randn(3, 77, d, device=cuda_device).to(torch.bfloat16)
        assert odd.data_ptr() % 16
        before = short_attention.launches
        if refused:
            with pytest.raises(ValueError, match="16-byte"):
                short_attention(odd, ok, ok, True)
            assert short_attention.launches == before
        else:
            with torch.inference_mode():
                got = short_attention(odd, ok, ok, True)
            assert short_attention.launches == before + 1
            torch.testing.assert_close(
                got.float(), short_attention_reference(odd, ok, ok,
                                                       True).float(),
                atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_long_attention_bf16_refuses_a_misaligned_tensor(cuda_device):
    """The bf16 kernels copy with 16-byte cp.async: a tensor whose data
    starts off a 16-byte boundary is refused, never sent to the plain
    version; float32 takes it."""
    flat = torch.randn(2 * 130 * 64 + 1, device=cuda_device)
    odd = flat[1:].view(2, 130, 64)
    ok = torch.randn(2, 130, 64, device=cuda_device)
    long_attention_fwd(odd, ok, ok)
    odd16, ok16 = odd.to(torch.bfloat16), ok.to(torch.bfloat16)
    odd16 = torch.cat([odd16.new_zeros(1), odd16.flatten()])[1:].view(
        2, 130, 64)
    assert odd16.data_ptr() % 16
    before = long_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        long_attention(odd16, ok16, ok16)
    out, lse = long_attention_fwd(ok16, ok16, ok16)
    with pytest.raises(ValueError, match="16-byte"):
        long_attention_bwd(ok16, ok16, ok16, odd16, out, lse)
    assert long_attention.launches == before + 1


@pytest.mark.cuda
def test_long_attention_refuses_what_the_kernel_cannot_take(cuda_device):
    bad = torch.zeros(2, 200, 36, device=cuda_device)       # 36 % 8 != 0
    with pytest.raises(ValueError, match="multiple of 8"):
        long_attention(bad, bad, bad)
    wide = torch.zeros(2, 200, 136, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        long_attention(wide, wide, wide)
    ok = torch.zeros(2, 200, 64, device=cuda_device)
    strided = torch.zeros(2, 64, 200, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        long_attention(strided, ok, ok)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 5e-2)])
def test_blip_vit_block_trains_through_the_long_kernels_on_card(cuda_device,
                                                                dtype, tol):
    """One BLIP ViT block (width 768, 12 heads, S=577) under autograd: the
    kernel route against the plain route, output and input gradient; the
    launch counters move by one each."""
    from spn4cir_tpu_torch.models.blip_vit import Block

    g = torch.Generator().manual_seed(0)
    block = Block(768, 12)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (
                p.shape[-1] ** -0.5 if p.dim() > 1 else 0.02))
        block.norm1.weight.fill_(1.0)
        block.norm2.weight.fill_(1.0)
    block.to(cuda_device)
    x = torch.randn(2, 577, 768, generator=g).to(cuda_device, dtype)
    outs = {}
    for impl in ("auto", "plain"):
        layers.set_attention_impl(block, impl)
        leaf = x.clone().requires_grad_()
        fwd, bwd = long_attention.launches, long_attention_bwd.launches
        y = block(leaf)
        y.float().square().mean().backward()
        moved = (long_attention.launches - fwd,
                 long_attention_bwd.launches - bwd)
        assert moved == ((1, 1) if impl == "auto" else (0, 0)), (impl, moved)
        outs[impl] = (y.detach().float(), leaf.grad.float())
    for a, b in zip(outs["auto"], outs["plain"]):
        torch.testing.assert_close(a, b, atol=tol * float(b.abs().max()),
                                   rtol=tol)


# ---- max-over-query bank InfoNCE (#9, #10) ----

def _mq_case(device, b, m, q, d, kind, seed=0):
    from spn4cir_tpu_torch.ops import maxquery_kernels as mk

    g = torch.Generator(device=device).manual_seed(seed)
    feats = torch.nn.functional.normalize(
        torch.randn(b, d, generator=g, device=device), dim=-1)
    bank = torch.nn.functional.normalize(
        torch.randn(m, q, d, generator=g, device=device), dim=-1)
    labels = torch.randint(0, m, (b,), generator=g, device=device)
    if kind == "int8":
        bank = bk.quantize_bank(bank)
    elif kind == "bfloat16":
        bank = bank.to(torch.bfloat16)
    return mk, feats, bank, labels


def _mq_launched(fn):
    """The names of the CUDA kernels `fn` launches (a profiler trace)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _mq_check(mk, feats, bank, labels, tau, atol_dq=1e-6):
    """#9 with its residuals and #10 from them against the plain versions:
    statistics, loss, dtau, the residual logits, each routed query a
    maximum of the plain sims within the tolerance, and dfeats against the
    plain backward from the kernel's residuals and against the one that
    recomputes the sims. Returns the kernels' outputs."""
    gout = torch.tensor(1.0, device=feats.device)
    loss, stats, dtau, res = mk.max_query_infonce_fwd(feats, bank, labels,
                                                      tau, routing=True)
    dq = mk.max_query_infonce_bwd(bank, labels, tau, stats[0], stats[1],
                                  gout, res)
    torch.cuda.synchronize()
    want = mk.max_query_infonce_stats_reference(feats, bank, labels, tau)
    for got_s, want_s in zip(stats, want):
        torch.testing.assert_close(got_s, want_s, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        loss, mk.max_query_infonce_reference(feats, bank, labels, tau),
        atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dtau, bk.dtau_from_stats(want, tau),
                               atol=1e-3, rtol=1e-4)
    want_l, _ = mk.max_query_infonce_residuals_reference(feats, bank, tau)
    assert res[0].shape == res[1].shape == want_l.shape
    assert res[1].dtype == torch.int16
    torch.testing.assert_close(res[0], want_l, atol=1e-4, rtol=1e-4)
    at_route = mk._sims(feats, bank).gather(
        -1, res[1].long()[..., None])[..., 0] / tau
    torch.testing.assert_close(at_route, want_l, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        dq, mk.max_query_infonce_bwd_reference(feats, bank, labels, tau,
                                               want[0], want[1], gout),
        atol=atol_dq, rtol=1e-4)
    torch.testing.assert_close(
        dq, mk.max_query_infonce_routed_bwd_reference(
            bank, labels, tau, stats[0], stats[1], gout, res),
        atol=atol_dq, rtol=1e-4)
    return loss, stats, res, dq


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,q", [(32, 65536, 32), (5, 1000, 8), (70, 4001, 3),
                                   (1, 1, 1), (64, 777, 4), (9, 300, 300)])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_max_query_kernels_match_plain_versions_on_card(cuda_device, b, m, q,
                                                        kind):
    """Statistics, loss, dtau, residuals and dfeats of #9 / #10 against the
    plain versions, at the recipe's shape (B=32: one 32-row tile of feats,
    the register epilogue at Q = 32), ragged ones (B=70: three row tiles,
    the last one of 6 rows; Q = 3, 4, 8: the staged scan; Q = 300: one m
    over two tiles, its max carried), and a second launch giving the same
    bits."""
    mk, feats, bank, labels = _mq_case(cuda_device, b, m, q, 256, kind)
    tau = 0.05
    before = (mk.max_query_infonce_fwd.launches,
              mk.max_query_infonce_bwd.launches)
    loss, stats, res, dq = _mq_check(mk, feats, bank, labels, tau)
    assert (mk.max_query_infonce_fwd.launches,
            mk.max_query_infonce_bwd.launches) == (before[0] + 1,
                                                   before[1] + 1)
    loss2, _, _, res2 = mk.max_query_infonce_fwd(feats, bank, labels, tau,
                                                 routing=True)
    dq2 = mk.max_query_infonce_bwd(bank, labels, tau, stats[0], stats[1],
                                   torch.tensor(1.0, device=cuda_device), res)
    assert torch.equal(loss, loss2) and torch.equal(dq, dq2)
    assert torch.equal(res[0], res2[0]) and torch.equal(res[1], res2[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_max_query_forward_takes_the_tensor_cores_on_card(cuda_device, kind):
    """At Q = 32, D = 256 the forward runs `mq_fwd_tc_kernel` (split TF32
    on the tensor cores) and the backward `mq_routed_bwd_kernel` from the
    residuals: no forward kernel, so no sim is recomputed."""
    mk, feats, bank, labels = _mq_case(cuda_device, 32, 4099, 32, 256, kind)
    gout = torch.tensor(1.0, device=cuda_device)
    out = {}

    def fwd():
        out["fwd"] = mk.max_query_infonce_fwd(feats, bank, labels, 0.05,
                                              routing=True)
    names = _mq_launched(fwd)
    assert any("mq_fwd_tc_kernel" in n for n in names), names
    _, stats, _, res = out["fwd"]
    names = _mq_launched(lambda: mk.max_query_infonce_bwd(
        bank, labels, 0.05, stats[0], stats[1], gout, res))
    assert any("mq_routed_bwd_kernel" in n for n in names), names
    assert not any("mq_fwd" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("q", [5, 32])
def test_max_query_tie_routes_to_the_first_query_on_card(cuda_device, q):
    """Two equal query rows of every bank row (1 and 3, query 1 made the
    largest): their sims tie exactly in the kernel too, and #9 routes every
    (b, m) to query 1, as the Pallas kernel's `taken` mask does; #10's
    dfeats is the plain version's."""
    mk, feats, bank, labels = _mq_case(cuda_device, 6, 513, q, 256,
                                       "float32")
    bank[:, 1] = torch.nn.functional.normalize(
        bank[:, 1] + 3 * feats.sum(0), dim=-1)
    bank[:, 3] = bank[:, 1]
    assert (mk._sims(feats, bank).argmax(-1) == 1).all()
    _, _, res, _ = _mq_check(mk, feats, bank, labels, 0.05)
    assert (res[1] == 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 64, 70])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_max_query_kernels_take_the_widest_dim_on_card(cuda_device, b, kind):
    """D=512, the widest D (the forward's split feats take 128 KB of
    shared memory, the backward's float32 stages 64 KB each), at any B:
    both kernels against the plain versions."""
    mk, feats, bank, labels = _mq_case(cuda_device, b, 700, 4, 512, kind)
    _mq_check(mk, feats, bank, labels, 0.05)
    mk, feats, bank, labels = _mq_case(cuda_device, b, 300, 32, 512, kind)
    _mq_check(mk, feats, bank, labels, 0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_max_query_infonce_autograd_on_card(cuda_device, kind, monkeypatch):
    """The autograd Function: dfeats and dtau (a learnable 0-d temperature)
    against autograd through the plain loss, one backward launch; the
    forward asks for the residuals only when feats needs a gradient."""
    mk, feats, bank, labels = _mq_case(cuda_device, 32, 3001, 32, 256, kind,
                                       seed=1)
    asked = []
    fwd = mk.max_query_infonce_fwd

    def spy(*args, routing=False):
        asked.append(routing)
        out = fwd(*args, routing=routing)
        assert (out[3] is not None) == routing
        return out
    # the wrapper counts its launches on whatever the module's name holds
    spy.launches = fwd.launches
    monkeypatch.setattr(mk, "max_query_infonce_fwd", spy)
    leaf = feats.clone().requires_grad_()
    tau = torch.tensor(0.05, device=cuda_device, requires_grad=True)
    before = mk.max_query_infonce_bwd.launches
    mk.max_query_infonce(leaf, bank, labels, tau).backward()
    assert mk.max_query_infonce_bwd.launches == before + 1
    assert asked == [True]
    ref = feats.clone().requires_grad_()
    ref_tau = torch.tensor(0.05, device=cuda_device, requires_grad=True)
    mk.max_query_infonce_reference(ref, bank, labels, ref_tau).backward()
    torch.testing.assert_close(leaf.grad, ref.grad, atol=1e-6, rtol=1e-4)
    torch.testing.assert_close(tau.grad, ref_tau.grad, atol=1e-3, rtol=1e-4)
    # no gradient wanted: the forward writes no residuals
    with torch.no_grad():
        loss = mk.max_query_infonce(feats, bank, labels, tau)
    torch.testing.assert_close(
        loss, mk.max_query_infonce_reference(feats, bank, labels, 0.05),
        atol=1e-4, rtol=1e-4)
    mk.max_query_infonce(feats, bank, labels, tau).backward()  # dtau only
    assert asked == [True, False, False]
    assert mk.max_query_infonce_bwd.launches == before + 1
    # a bf16 feats tensor is widened for the kernels; its gradient comes
    # back in bf16
    half = feats.to(torch.bfloat16).requires_grad_()
    mk.max_query_infonce(half, bank, labels, 0.05).backward()
    assert half.grad.dtype == torch.bfloat16


@pytest.mark.cuda
def test_max_query_kernels_refuse_what_they_cannot_take(cuda_device):
    mk, feats, bank, labels = _mq_case(cuda_device, 4, 10, 2, 256, "float32")
    with pytest.raises(ValueError, match="D % 32"):
        mk.max_query_infonce_fwd(feats[:, :48].contiguous(),
                                 bank[..., :48].contiguous(), labels, 0.05)
    with pytest.raises(ValueError, match="D <= 512"):
        mk.max_query_infonce_fwd(
            torch.zeros(4, 544, device=cuda_device),
            torch.zeros(3, 2, 544, device=cuda_device), labels, 0.05)
    with pytest.raises(ValueError, match="float32 feats"):
        mk.max_query_infonce_fwd(feats.half(), bank, labels, 0.05)
    with pytest.raises(ValueError, match="contiguous"):
        mk.max_query_infonce_fwd(feats, bank.transpose(0, 1), labels[:4],
                                 0.05)
    with pytest.raises(ValueError, match="one device"):
        mk.max_query_infonce_fwd(feats, bank, labels.cpu(), 0.05)
    _, stats, _, res = mk.max_query_infonce_fwd(feats, bank, labels, 0.05,
                                                routing=True)
    with pytest.raises(ValueError, match="residuals must be"):
        mk.max_query_infonce_bwd(bank, labels, 0.05, stats[0], stats[1],
                                 torch.tensor(1.0, device=cuda_device),
                                 (res[0][:, :5], res[1]))


# --------------------------------------------------------------------------
# #11 decode attention and #12 int8 weight matmul (the LLaMA decoders).
# Tolerances: float32 1e-5 (sums in another order); bf16 2e-2 (the plain
# version rounds the softmax weights to bf16 before the V product, the
# kernel rounds once at the output); int8 cache 1e-4 relative (float32
# arithmetic on exact int8 values, the scales applied in another order).
# #12: float32 x 1e-5 relative (sums over D in another order), bf16 x 2e-2
# (one rounding of the output to bf16).
# --------------------------------------------------------------------------

def _decode_case(device, b, h, kvh, hd, length, layers, kind, seed=0):
    from spn4cir_tpu_torch.models.llama import _quant_rows

    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, h, hd, generator=g, device=device)
    k = torch.randn(layers, b, length, kvh * hd, generator=g, device=device)
    v = torch.randn(layers, b, length, kvh * hd, generator=g, device=device)
    bias = torch.zeros(b, length, device=device)
    bias[:, length - length // 7:] = -1e9            # the causal tail
    bias[0, :min(3, length - 1)] = -1e9              # a left pad
    if kind == "int8":
        (k, ks), (v, vs) = _quant_rows(k), _quant_rows(v)
        return q, k, v, bias, ks, vs
    dtype = getattr(torch, kind)
    return q.to(dtype), k.to(dtype), v.to(dtype), bias, None, None


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kvh,hd,length", [
    (16, 32, 32, 128, 1842), (1, 32, 32, 128, 1842), (3, 4, 4, 8, 37),
    (2, 8, 2, 64, 300), (5, 6, 3, 40, 129), (2, 4, 4, 128, 1),
    (16, 32, 32, 128, 547)])
@pytest.mark.parametrize("kind,atol,rtol", [
    ("float32", 1e-5, 1e-5), ("bfloat16", 2e-2, 2e-2), ("int8", 1e-4, 1e-4)])
def test_decode_attention_matches_plain_version_on_card(
        cuda_device, b, h, kvh, hd, length, kind, atol, rtol):
    """#11 against its plain version: the 7B's decode shape at B=16 and B=1,
    hd=8 (the tiny LM), GQA, an off-power-of-two head_dim, L=1 and LLaVA's
    547-row cache at B=16; the last of 3 layers; a second launch gives the
    same bits."""
    from spn4cir_tpu_torch.ops.decode_attn import (decode_attention,
                                                   decode_attention_reference)

    q, k, v, bias, ks, vs = _decode_case(cuda_device, b, h, kvh, hd, length,
                                         3, kind)
    before = decode_attention.launches
    got = decode_attention(q, k, v, 2, bias, ks, vs)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert got.dtype == (torch.float32 if kind == "int8" else k.dtype)
    want = decode_attention_reference(q, k, v, 2, bias, ks, vs)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, decode_attention(q, k, v, 2, bias, ks, vs))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,atol,rtol", [
    ("float32", 1e-5, 1e-5), ("bfloat16", 2e-2, 2e-2), ("int8", 1e-4, 1e-4)])
def test_decode_attention_masks_across_split_boundaries_on_card(
        cuda_device, kind, atol, rtol):
    """#11 where L is cut into 8 splits of 75 rows: batch row 0 masks the
    whole first split and a run across the boundary at row 150, row 1 a run
    across the boundary at row 75; the splits merge in their cluster."""
    from spn4cir_tpu_torch.ops.decode_attn import (
        decode_attention, decode_attention_reference, split_plan)

    assert split_plan(600, 2 * 4, 132) == (75, 8)
    q, k, v, bias, ks, vs = _decode_case(cuda_device, 2, 4, 4, 64, 600, 2,
                                         kind, seed=3)
    bias[0, :75] = -1e9
    bias[0, 140:160] = -1e9
    bias[1, 70:80] = -1e9
    got = decode_attention(q, k, v, 1, bias, ks, vs)
    torch.cuda.synchronize()
    want = decode_attention_reference(q, k, v, 1, bias, ks, vs)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, decode_attention(q, k, v, 1, bias, ks, vs))


@pytest.mark.cuda
def test_decode_attention_refuses_what_it_cannot_take(cuda_device):
    from spn4cir_tpu_torch.ops.decode_attn import decode_attention

    q, k, v, bias, _, _ = _decode_case(cuda_device, 2, 4, 4, 8, 20, 2,
                                       "float32")
    with pytest.raises(ValueError, match="head_dim % 8"):
        decode_attention(q[..., :4].contiguous(), k[..., :16].contiguous(),
                         v[..., :16].contiguous(), 0, bias)
    with pytest.raises(ValueError, match="k_scale"):
        decode_attention(q, k, v, 0, bias, bias, bias)
    with pytest.raises(ValueError, match="one device"):
        decode_attention(q, k, v, 0, bias.cpu())
    with pytest.raises(ValueError, match="layer 2"):
        decode_attention(q, k, v, 2, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,f", [
    (1, 4096, 4096), (16, 4096, 11008), (8, 11008, 4096), (16, 4096, 32000),
    (5, 40, 77), (33, 300, 130), (3, 64, 8), (16, 11008, 4096),
    (17, 4096, 11008), (9, 300, 130)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_quant_matmul_matches_plain_version_on_card(cuda_device, rows, d, f,
                                                    dtype, tol):
    """#12 against its plain version at the 7B's decode shapes, ragged ones
    (F=77 and F=130 take the byte loads, bf16 x at D=300 the value loads;
    33 rows take three row tiles of 16, 17 rows two, 9 rows one of 16) and
    a 3-D x; a second launch gives the same bits."""
    from spn4cir_tpu_torch.ops.quant_matmul import (quant_matmul,
                                                    quant_matmul_reference)

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(rows, d, generator=g, device=cuda_device).to(dtype)
    values = torch.randint(-127, 128, (d, f), generator=g,
                           device=cuda_device).to(torch.int8)
    scales = torch.rand(f, generator=g, device=cuda_device) * 1e-3 + 1e-4
    before = quant_matmul.launches
    got = quant_matmul(x, values, scales)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1 and got.dtype == dtype
    want = quant_matmul_reference(x, values, scales)
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * scale)
    assert torch.equal(got, quant_matmul(x, values, scales))
    # leading dims flatten: the same bits as the 2-D call on those rows
    three = quant_matmul(x[None].expand(2, rows, d), values, scales)
    assert three.shape == (2, rows, f)
    assert torch.equal(three.reshape(2 * rows, f),
                       quant_matmul(torch.cat([x, x]), values, scales))


@pytest.mark.cuda
def test_quant_matmul_takes_float32_x_over_nine_decades_on_card(cuda_device):
    """float32 x whose first row spans |x| = 1e-6 to 1e3: its three bf16
    terms carry every value exactly, so the tensor-core product holds the
    float32 tolerance at D = 11,008."""
    from spn4cir_tpu_torch.ops.quant_matmul import (quant_matmul,
                                                    quant_matmul_reference)

    g = torch.Generator(device=cuda_device).manual_seed(4)
    d, f = 11008, 4096
    x = torch.randn(16, d, generator=g, device=cuda_device)
    mag = 10.0 ** (torch.rand(d, generator=g, device=cuda_device) * 9 - 6)
    x[0] = torch.sign(x[0]) * mag
    values = torch.randint(-127, 128, (d, f), generator=g,
                           device=cuda_device).to(torch.int8)
    scales = torch.rand(f, generator=g, device=cuda_device) * 1e-3 + 1e-4
    got = quant_matmul(x, values, scales)
    want = quant_matmul_reference(x, values, scales)
    for row in (got[:1], got):
        ref = want[:row.shape[0]]
        scale = ref.abs().max().item()
        torch.testing.assert_close(row, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
def test_llama_generate_through_the_kernels_on_card(cuda_device):
    """A GQA LLaMA (hd=64) generates the same greedy tokens through #11 and
    #12 as through the plain routes, over an int8 cache and int8 weights,
    and the counters show both kernels ran in every decode step."""
    from spn4cir_tpu_torch.models.llama import (
        LlamaConfig, LlamaForCausalLM, embed_tokens, llama_generate,
        quantize_llama_weights)
    from spn4cir_tpu_torch.ops.decode_attn import decode_attention
    from spn4cir_tpu_torch.ops.quant_matmul import quant_matmul

    cfg = LlamaConfig(vocab_size=300, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, intermediate_size=512)
    model = LlamaForCausalLM(cfg, device=cuda_device)
    model.init_weights(torch.Generator(device=cuda_device).manual_seed(0))
    params = quantize_llama_weights(model)
    ids = torch.randint(0, 300, (3, 40), device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(1))
    mask = torch.ones_like(ids)
    mask[0, :7] = 0
    kw = dict(eos_id=299, pad_id=0, max_new_tokens=8, attention_mask=mask,
              cache_dtype=torch.int8, prefill_chunk=16)
    emb = embed_tokens(params, ids)
    plain = llama_generate(params, cfg, emb, attn_kernel=False,
                           quant_kernel=False, **kw)
    before = decode_attention.launches, quant_matmul.launches
    fused = llama_generate(params, cfg, emb, attn_kernel=True,
                           quant_kernel=True, **kw)
    assert torch.equal(plain, fused)
    assert decode_attention.launches - before[0] == 2 * 7
    assert quant_matmul.launches - before[1] == 7 * (7 * 2 + 1)


# --------------------------------------------------------------------------
# the captioners at full width, two layers deep, float32: the kernels (#3 in
# the towers, #11 in LLaVA's decode) against the plain versions, token
# streams compared under the margin rule: where two streams part, the plain
# route's top-2 margin at that step must be under 1e-5 of its top logit (at
# least 1), float32 noise
# --------------------------------------------------------------------------

MARGIN_TOL = 1e-5


def _parted_within_noise(kern, plain, step_logits):
    """The rows where `kern` and `plain` (B, T) part, each with the plain
    route's top-2 margin there; asserts each under the float32 noise.
    `step_logits(t)` -> (B, vocab) plain-route logits at step t."""
    parted = []
    for r in range(kern.shape[0]):
        where = (kern[r] != plain[r]).nonzero()
        if len(where):
            t = int(where[0])
            top = step_logits(t)[r].topk(2).values
            margin = (top[0] - top[1]).item()
            parted.append((r, t, margin))
            assert margin < MARGIN_TOL * max(1.0, abs(top[0].item())), parted
    return parted


@pytest.mark.cuda
def test_llava_captioner_through_the_kernels_on_card(cuda_device):
    from spn4cir_tpu_torch.models import llama as tl
    from spn4cir_tpu_torch.models import llava as tv
    from spn4cir_tpu_torch.models.layers import set_attention_impl
    from spn4cir_tpu_torch.ops.decode_attn import decode_attention
    from spn4cir_tpu_torch.tokenizer.bytelevel import ByteTokenizer

    cfg = tv.LlavaConfig(
        llama=tl.LlamaConfig(num_layers=2),
        vision=tv.LlavaVisionConfig(num_layers=3))     # 2 blocks run
    cap = tv.LlavaCaptioner(cfg, ByteTokenizer(), device=cuda_device)
    cap.init_params(torch.Generator(device=cuda_device).manual_seed(0))
    images = torch.randn(4, 224, 224, 3, device=cuda_device,
                         generator=torch.Generator(device=cuda_device
                                                   ).manual_seed(1))
    ids = cap.prompt_ids("please briefly describe the image in 10 words")
    new = 24

    def embeds(plain):
        set_attention_impl(cap.model, "plain" if plain else "auto")
        try:
            feats = cap.model.encode_images(images)
        finally:
            set_attention_impl(cap.model, "auto")
        return tv.splice_image_embeds(cap.model.model.embed_tokens.weight,
                                      ids, feats)

    with torch.inference_mode():
        before = long_attention.launches, decode_attention.launches
        ek = embeds(False)
        assert long_attention.launches - before[0] == 2
        ep = embeds(True)
        torch.testing.assert_close(ek, ep, atol=1e-4, rtol=1e-4)
        kw = dict(eos_id=257, pad_id=257, max_new_tokens=new,
                  cache_dtype=torch.float32)
        kern = tl.llama_generate(cap.model, cfg.llama, ek, attn_kernel=True,
                                 **kw)
        assert decode_attention.launches - before[1] == 2 * (new - 1)
        plain = tl.llama_generate(cap.model, cfg.llama, ep,
                                  attn_kernel=False, **kw)

        def step_logits(t):
            state = tl.init_llama_state(cfg.llama, 4, ep.shape[1] + new,
                                        device=cuda_device)
            logits, state = tl.llama_prefill(cap.model, cfg.llama, state, ep)
            for i in range(1, t + 1):
                logits, state = tl.llama_decode_step(
                    cap.model, cfg.llama, state,
                    tl.embed_tokens(cap.model, plain[:, i - 1]),
                    ep.shape[1] + i - 1)
            return logits

        _parted_within_noise(kern, plain, step_logits)
        caps = cap.caption(images.cpu().numpy(), "describe it",
                           max_new_tokens=8)
    assert len(caps) == 4 and all(isinstance(c, str) for c in caps)


@pytest.mark.cuda
def test_blip_captioner_through_the_kernel_on_card(cuda_device, tmp_path):
    from spn4cir_tpu_torch.models import generation as tg
    from spn4cir_tpu_torch.models.blip_caption import BlipCaptioner
    from spn4cir_tpu_torch.models.blip_vit import BlipViTConfig
    from spn4cir_tpu_torch.models.layers import set_attention_impl
    from spn4cir_tpu_torch.models.med import MedConfig
    from torch_fixtures import write_bert_vocab

    vocab = write_bert_vocab(str(tmp_path / "vocab.txt"))
    cap = BlipCaptioner("base", bert_vocab_path=vocab,
                        vit_cfg=BlipViTConfig(layers=2),
                        med_cfg=MedConfig(num_layers=2), device=cuda_device)
    cap.init_params(torch.Generator().manual_seed(0))
    images = torch.randn(4, 384, 384, 3, device=cuda_device,
                         generator=torch.Generator(device=cuda_device
                                                   ).manual_seed(2))
    prompt = torch.from_numpy(cap.prompt_ids(4)).to(cuda_device)
    before = long_attention.launches
    kern_embeds = cap.encode(images)
    assert long_attention.launches - before == 2
    set_attention_impl(cap.model, "plain")
    try:
        plain_embeds = cap.encode(images)
    finally:
        set_attention_impl(cap.model, "auto")
    torch.testing.assert_close(kern_embeds, plain_embeds, atol=1e-4,
                               rtol=1e-4)
    kw = dict(num_beams=1, max_length=30, min_length=10)
    kern = cap.generate_ids(kern_embeds, prompt, **kw)
    plain = cap.generate_ids(plain_embeds, prompt, **kw)
    dec = cap.model.text_decoder

    def step_logits(t):  # the logits that chose token t (t > prompt)
        state = tg.init_decode_state(dec, cap.med_cfg, plain_embeds, 30)
        for i in range(t):
            logits, state = tg.decode_step(dec, cap.med_cfg, state,
                                           plain[:, i], i)
        return tg.suppress_eos(logits, cap.tokenizer.sep_id, t, 10)

    _parted_within_noise(kern, plain, step_logits)
    caps = cap.caption(images)           # beam 3, the default
    assert len(caps) == 4 and all(isinstance(c, str) for c in caps)


@pytest.mark.cuda
def test_unicom_float32_attention_through_kernel_3_on_card(cuda_device):
    """Unicom ViT-L/14's attention slice at an encode batch of 32: (32 x 16
    heads, 256 tokens, 64) in float32 through #3 against its plain
    version."""
    q, k, v = _long_inputs(512, 256, 64, torch.float32, cuda_device, seed=4)
    before = long_attention.launches
    with torch.inference_mode():
        got = long_attention(q, k, v)
    assert long_attention.launches == before + 1
    torch.testing.assert_close(got, long_attention_reference(q, k, v),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_bf16_unicom_takes_the_float32_route_on_card(cuda_device,
                                                     monkeypatch):
    """Built in bf16 (at ViT-L/14's 256 tokens, two narrow blocks), the
    tower hands #3 float32 q, k and v, once a block; its embeddings agree
    with the plain attention route."""
    from spn4cir_tpu_torch.models.unicom import UnicomConfig, UnicomViT

    cfg = UnicomConfig(dim=128, embedding_size=32, depth=2, num_heads=2)
    with torch.device(cuda_device):
        model = UnicomViT(cfg, dtype=torch.bfloat16)
    model.init_weights(torch.Generator(device=cuda_device).manual_seed(0))
    seen = []
    kernel = layers.long_attention

    def spy(q, k, v):
        seen.append((q.dtype, tuple(q.shape)))
        return kernel(q, k, v)

    monkeypatch.setattr(layers, "long_attention", spy)
    images = torch.rand(3, 224, 224, 3, device=cuda_device,
                        generator=torch.Generator(device=cuda_device)
                        .manual_seed(1))
    before = long_attention.launches
    with torch.inference_mode():
        got = model.eval()(images)
        layers.set_attention_impl(model, "plain")
        want = model(images)
    assert long_attention.launches == before + cfg.depth
    assert seen == [(torch.float32, (3 * 2, 256, 64))] * cfg.depth
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_srm_scores_on_card_equal_the_cpu_port(cuda_device):
    """`srm_scores` on device similarities against the same function on
    their host copy: the same six arrays, exactly (random features hold no
    equal values)."""
    from spn4cir_tpu_torch.datagen.srm import compute_sims, srm_scores

    g = torch.Generator(device=cuda_device).manual_seed(5)

    def unit(n):
        x = torch.randn(n, 64, generator=g, device=cuda_device)
        return x / x.norm(dim=1, keepdim=True)

    n_img, n_txt = 700, 900
    sims = compute_sims(unit(n_img), unit(n_txt), unit(n_img), unit(n_txt))
    refer = torch.randint(0, n_img, (n_txt,), generator=g,
                          device=cuda_device)
    target = torch.randint(0, n_img, (n_txt,), generator=g,
                           device=cuda_device)
    got = srm_scores(sims, refer, target, 100, chunk=256)
    host = {key: v.cpu() for key, v in sims.items()}
    want = srm_scores(host, refer.cpu(), target.cpu(), 100)
    for key in want:
        assert got[key].device.type == "cuda"
        assert torch.equal(got[key].cpu(), want[key]), key
