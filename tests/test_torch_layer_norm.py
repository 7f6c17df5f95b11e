"""The LayerNorm wrapper (`ops/layer_norm.py`) on the CPU: its plain
forward is the towers' float32 chain to the bit, its plain backward formula
matches autograd through that chain, `layers.LayerNorm` keeps its parameter
names, a CPU call launches nothing, and `ln_plan` gives every width the
kernel takes one of its instantiations. The kernel itself is held against
these plain versions on the card (`tests/test_torch_cuda.py`)."""

import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from spn4cir_tpu_torch.models import layers
from spn4cir_tpu_torch.ops import layer_norm as lnk

# (dtype, vec, nv) of every instantiation `csrc/layer_norm.cu` dispatches to
INSTANTIATED = {(torch.bfloat16, 8, 1), (torch.bfloat16, 8, 2),
                (torch.bfloat16, 8, 3), (torch.bfloat16, 1, 16),
                (torch.float32, 4, 1), (torch.float32, 4, 2),
                (torch.float32, 4, 3), (torch.float32, 4, 4),
                (torch.float32, 1, 16)}


def test_instantiations_are_the_kernels_dispatch():
    src = (Path(lnk.__file__).resolve().parents[1] / "csrc" / "layer_norm.cu"
           ).read_text()
    cases = re.findall(r"if \(dtype == (\d) && vec == (\d+) && nv == (\d+)\)",
                       src)
    codes = {0: torch.float32, 1: torch.bfloat16}
    assert {(codes[int(d)], int(v), int(n)) for d, v, n in cases} == \
        INSTANTIATED


def _inputs(rows, width, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, width, generator=g) * 3 + 0.5).to(dtype)
    w = torch.randn(width, generator=g) * 0.5 + 1
    b = torch.randn(width, generator=g) * 0.1
    return x, w, b


def _chain(x, w, b, eps):
    """The towers' LayerNorm before the kernel: a float32 copy, aten's
    float32 LayerNorm, a cast back."""
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [13, 64, 640])
def test_plain_forward_is_the_chain_to_the_bit(dtype, width):
    x, w, b = _inputs(7, width, dtype)
    got = lnk.layer_norm_f32(x, (width,), w, b, 1e-5)
    assert got.dtype == dtype
    assert torch.equal(got, _chain(x, w, b, 1e-5))
    ln = layers.LayerNorm(width)
    with torch.no_grad():
        ln.weight.copy_(w)
        ln.bias.copy_(b)
    assert torch.equal(ln(x), nn.LayerNorm.forward(ln, x.float()).to(dtype))


@pytest.mark.parametrize("width,eps", [(8, 1e-5), (13, 1e-12), (40, 1e-6),
                                       (64, 1e-12)])
def test_plain_backward_matches_autograd_through_the_chain(width, eps):
    x, w, b = _inputs(11, width, torch.float32, seed=width)
    dy = torch.randn(11, width, generator=torch.Generator().manual_seed(1))
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    _chain(xr, wr, br, eps).backward(dy)
    mean, rstd = lnk.layer_norm_stats_reference(x, eps)
    dx, dw, db = lnk.layer_norm_bwd_reference(dy, x, mean, rstd, w)
    # float32 sums of up to 64 terms in another order
    torch.testing.assert_close(dx, xr.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dw, wr.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(db, br.grad, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("width", [13, 64])
def test_plain_backward_in_bf16_rounds_the_chains_dx_once(width):
    x, w, b = _inputs(9, width, torch.bfloat16, seed=3)
    dy = torch.randn(9, width, generator=torch.Generator().manual_seed(2)
                     ).to(torch.bfloat16)
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    _chain(xr, wr, br, 1e-5).backward(dy)
    mean, rstd = lnk.layer_norm_stats_reference(x, 1e-5)
    dx, dw, db = lnk.layer_norm_bwd_reference(dy, x, mean, rstd, w)
    assert dx.dtype == torch.bfloat16 and xr.grad.dtype == torch.bfloat16
    # both round a float32 dx once to bf16: at most one step of 2^-8
    torch.testing.assert_close(dx.float(), xr.grad.float(), atol=1e-2,
                               rtol=2 ** -7)
    torch.testing.assert_close(dw, wr.grad, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(db, br.grad, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_stats_reference_matches_atens_statistics(eps):
    x, _, _ = _inputs(5, 24, torch.float32)
    mean, rstd = lnk.layer_norm_stats_reference(x, eps)
    _, amean, arstd = torch.native_layer_norm(x, (24,), None, None, eps)
    torch.testing.assert_close(mean, amean.reshape(-1), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(rstd, arstd.reshape(-1), atol=1e-6, rtol=1e-6)


def test_layer_norm_loads_a_state_dict_by_its_names():
    src = nn.LayerNorm(16, eps=1e-6)
    with torch.no_grad():
        src.weight.normal_()
        src.bias.normal_()
    ln = layers.LayerNorm(16, eps=1e-6)
    ln.load_state_dict(src.state_dict())
    assert set(ln.state_dict()) == {"weight", "bias"}
    assert torch.equal(ln.weight, src.weight) and torch.equal(ln.bias, src.bias)
    x = torch.randn(3, 16)
    assert torch.equal(ln(x), src(x))


def test_cpu_calls_launch_nothing():
    before = (lnk.layer_norm_f32.launches, lnk.layer_norm_f32_bwd.launches)
    ln = layers.LayerNorm(24)
    x = torch.randn(4, 5, 24, requires_grad=True)
    ln(x.to(torch.bfloat16)).float().sum().backward()
    assert x.grad is not None and ln.weight.grad is not None
    assert (lnk.layer_norm_f32.launches,
            lnk.layer_norm_f32_bwd.launches) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("aligned", [True, False])
def test_every_width_gets_an_instantiation(dtype, aligned):
    for width in range(1, lnk.MAX_WIDTH + 1):
        vec, nv, rw = lnk.ln_plan(width, dtype, aligned)
        assert (dtype, vec, nv) in INSTANTIATED, (width, vec, nv)
        assert rw in lnk.ROW_WARPS and width % vec == 0
        assert 32 * rw * nv * vec >= width, width
        if vec == 1:
            assert not aligned or width % lnk.VEC[dtype]


@pytest.mark.parametrize("width,dtype,plan", [
    (640, torch.bfloat16, (8, 3, 1)),     # clip4cir RN50x4's text tower
    (768, torch.bfloat16, (8, 3, 1)),
    (1408, torch.bfloat16, (8, 3, 2)),    # EVA-g
    (1024, torch.float32, (4, 2, 4)),     # Unicom's float32 encode
    (4096, torch.bfloat16, (8, 2, 8)),
    (77, torch.bfloat16, (1, 16, 1)),
    (4096, torch.float32, (4, 4, 8)),
    (2304, torch.float32, (4, 3, 8)),
])
def test_plan_at_the_towers_widths(width, dtype, plan):
    assert lnk.ln_plan(width, dtype, True) == plan


@pytest.mark.parametrize("width,dtype", [(0, torch.float32),
                                         (4097, torch.bfloat16),
                                         (64, torch.float16),
                                         (64, torch.float64)])
def test_plan_refuses_what_the_kernel_cannot_take(width, dtype):
    with pytest.raises(ValueError):
        lnk.ln_plan(width, dtype, True)
