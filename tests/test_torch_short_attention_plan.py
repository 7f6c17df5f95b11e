"""Which kernel the short-sequence attention, forward and backward, launches
on the card.

`short_route` is the one place that decides it, for both directions, from
the dtype, the head dim and the tensors' alignment: bfloat16 with head_dim
% 8 == 0 runs on the tensor cores (`short_attention_fwd_tc_kernel` and
`short_attention_bwd_tc_kernel` in csrc/short_attention.cu, which copy rows
with 16-byte `cp.async` and so refuse a tensor off a 16-byte boundary: q,
k, v, and the backward's dout too); float32 (TF32 would not hold the
float32 tolerances of 1e-5 forward and 1e-4 backward) and bfloat16 at any
other head_dim run on the CUDA cores. The kernels themselves run only on
the card (tests/test_torch_cuda.py, chip_smoke.py); on the CPU the wrapper
takes the plain version whatever the route would be.
"""

import pytest
import torch

from spn4cir_tpu_torch.ops import attention_kernels as ak


@pytest.mark.parametrize("d", [8, 16, 40, 64, 72, 88, 128])
def test_bf16_at_a_multiple_of_8_runs_on_the_tensor_cores(d):
    assert ak.short_route(torch.bfloat16, d, True) == "tensor_cores"


@pytest.mark.parametrize("d", [1, 12, 20, 63, 100, 127])
def test_bf16_at_other_head_dims_runs_on_the_cuda_cores(d):
    assert ak.short_route(torch.bfloat16, d, True) == "cuda_cores"
    # the CUDA-core kernel loads scalars where a row is off 16 bytes
    assert ak.short_route(torch.bfloat16, d, False) == "cuda_cores"


@pytest.mark.parametrize("d", [8, 64, 72, 128, 12])
@pytest.mark.parametrize("aligned", [True, False])
def test_float32_always_runs_on_the_cuda_cores(d, aligned):
    assert ak.short_route(torch.float32, d, aligned) == "cuda_cores"


@pytest.mark.parametrize("d", [8, 64, 128])
def test_misaligned_bf16_for_the_tensor_cores_is_refused(d):
    with pytest.raises(ValueError, match="16-byte boundary"):
        ak.short_route(torch.bfloat16, d, False)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_other_dtypes_have_no_route(dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ak.short_route(dtype, 64, True)


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_tensors_off_16_bytes_take_the_plain_version(causal, rng):
    """The alignment rule is the tensor-core kernel's: a bf16 CPU tensor
    whose data starts off a 16-byte boundary still runs the plain version,
    and counts no launch."""
    base = torch.from_numpy(rng.randn(3 * 17 * 64 + 1).astype("float32")).to(
        torch.bfloat16)
    q, k, v = (base[1:].reshape(3, 17, 64) for _ in range(3))
    assert q.data_ptr() % 16
    before = ak.short_attention.launches
    got = ak.short_attention(q, k, v, causal)
    assert ak.short_attention.launches == before
    torch.testing.assert_close(got, ak.short_attention_reference(q, k, v,
                                                                 causal))


def _slices(dtype, d, misaligned=()):
    """q, k, v, dout (3, 17, d) of `dtype`; those named in `misaligned`
    start one element past a 16-byte boundary."""
    out, n = [], 3 * 17 * d
    for name in ("q", "k", "v", "dout"):
        flat = torch.zeros(n + 1, dtype=dtype)
        t = flat[int(name in misaligned):][:n].view(3, 17, d)
        assert bool(t.data_ptr() % 16) == (name in misaligned)
        out.append(t)
    return out


@pytest.mark.parametrize("d", [8, 64, 72, 128])
def test_bf16_backward_at_a_multiple_of_8_runs_on_the_tensor_cores(d):
    assert ak._tensor_route(*_slices(torch.bfloat16, d)) == "tensor_cores"


@pytest.mark.parametrize("d", [8, 64, 12])
def test_float32_backward_runs_on_the_cuda_cores(d):
    assert ak._tensor_route(*_slices(torch.float32, d)) == "cuda_cores"
    assert ak._tensor_route(*_slices(torch.float32, d, ("dout",))) == (
        "cuda_cores")


@pytest.mark.parametrize("d", [12, 20, 100])
def test_bf16_backward_at_other_head_dims_runs_on_the_cuda_cores(d):
    assert ak._tensor_route(*_slices(torch.bfloat16, d)) == "cuda_cores"
    assert ak._tensor_route(*_slices(torch.bfloat16, d, ("dout",))) == (
        "cuda_cores")


@pytest.mark.parametrize("d", [8, 64, 128])
def test_backward_refuses_a_misaligned_dout_for_the_tensor_cores(d):
    """dout is read by 16-byte `cp.async` as q, k and v are: off a 16-byte
    boundary it is refused, before the wrapper looks at the device."""
    q, k, v, dout = _slices(torch.bfloat16, d, ("dout",))
    with pytest.raises(ValueError, match="16-byte boundary"):
        ak.short_attention_bwd(q, k, v, dout)
    # aligned, the same CPU call gets as far as the device
    with pytest.raises(ValueError, match="CUDA kernel"):
        ak.short_attention_bwd(*_slices(torch.bfloat16, d))
