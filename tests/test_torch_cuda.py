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
order), with an absolute floor of 1e-6 for dQ.
"""

import pytest
import torch

from spn4cir_tpu_torch.models import clip as tclip
from spn4cir_tpu_torch.models import layers
from spn4cir_tpu_torch.ops import bank_kernels as bk
from spn4cir_tpu_torch.ops.attention_kernels import (
    short_attention, short_attention_bwd, short_attention_bwd_reference,
    short_attention_reference)


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


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,causal", [
    (2048, 77, 64, True), (3072, 50, 64, False), (3, 29, 16, True),
    (5, 17, 40, False), (2, 117, 64, True), (2, 128, 64, True),
    (3, 128, 128, False), (3, 128, 128, True), (2, 96, 128, True)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_backward_kernel_matches_plain_version_on_card(cuda_device, bh, s, d,
                                                       causal, dtype, tol):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(bh, s, d, generator=g, device=cuda_device,
                               dtype=dtype) for _ in range(4))
    q = q * d ** -0.5
    before = short_attention_bwd.launches
    got = short_attention_bwd(q, k, v, do, causal)
    torch.cuda.synchronize()
    assert short_attention_bwd.launches == before + 1
    want = short_attention_bwd_reference(q, k, v, do, causal)
    for a, b in zip(got, want):
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
                                   (70, 4001, 768), (3, 300, 1040)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bank_infonce_kernels_match_plain_versions_on_card(cuda_device, b, m,
                                                           d, dtype):
    q, bank, labels = _bank_case(cuda_device, b, m, d, dtype)
    tau = 0.02
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
                                   (64, 128, 64), (3, 300, 1040)])
def test_int8_bank_kernels_match_plain_versions_on_card(cuda_device, b, m, d):
    """Kernels 7 and 8 against their plain versions (scales after the
    product), the tail of the scale buffer poisoned behind a view: rows past
    M must contribute nothing."""
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
