"""Tests of the port that need an NVIDIA GPU: the CUDA kernel has no CPU
mode. They are marked `cuda` and skip elsewhere. This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: float32 atol = rtol = 1e-5 (summation order only); bf16
atol = rtol = 2e-2 (P is rounded to bf16 before P·V in both versions).
"""

import pytest
import torch

from spn4cir_tpu_torch.models import clip as tclip
from spn4cir_tpu_torch.models import layers
from spn4cir_tpu_torch.ops.attention_kernels import (short_attention,
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
def test_kernel_is_forward_only(cuda_device):
    q = torch.randn(2, 50, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        short_attention(q, q, q)


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
