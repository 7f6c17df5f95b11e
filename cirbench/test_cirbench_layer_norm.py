"""`layer_norm_roofline` on synthetic traces: None without a LayerNorm
kernel, 100% when the kernels' time equals the bound, and the forward and
dx launches counted by name."""

from __future__ import annotations

import types

import pytest

from cirbench import harness
from cirbench.trace import Trace

SHAPES = {"batch": 256, "config": {"context_length": 77,
                                    "transformer_width": 640,
                                    "dtype": "bfloat16"}}
ELEMS = 256 * 77 * 640
FWD_S = 2 * ELEMS * 2 / 3.35e12   # bf16 x read, y written
BWD_S = 3 * ELEMS * 2 / 3.35e12   # dy and x read, dx written

FWD = "void (anonymous namespace)::ln_f32_fwd_kernel<__nv_bfloat16, 8, 3>(...)"
BWD = "void (anonymous namespace)::ln_f32_bwd_kernel<__nv_bfloat16, 8, 3>(...)"
DPARAMS = "(anonymous namespace)::ln_f32_dparams_kernel(float const*, int, ...)"
OTHER = "void at::native::vectorized_layer_norm_kernel<float, float>(...)"


def _read(device):
    tr = Trace(device=device, host=[], window_s=1.0)
    r = types.SimpleNamespace(trace=tr, shapes=SHAPES)
    return harness.metric_reader("layer_norm_roofline")(r)


def _kernel(name, dur_s, start=0.0):
    return (name, "kernel", start, dur_s * 1e6)


def test_none_without_a_layer_norm_kernel():
    assert _read([]) is None
    assert _read([_kernel(OTHER, 1e-3), ("copy", "gpu_memcpy", 0.0, 5.0)]) \
        is None


def test_full_share_when_the_kernels_take_the_bound():
    dev = [_kernel(FWD, FWD_S), _kernel(BWD, BWD_S)]
    assert _read(dev) == pytest.approx(100.0)


def test_the_partial_sums_kernel_counts_in_the_time_not_the_bound():
    dev = [_kernel(FWD, FWD_S), _kernel(BWD, BWD_S / 2),
           _kernel(DPARAMS, BWD_S / 2)]
    assert _read(dev) == pytest.approx(100.0)
    dev.append(_kernel(DPARAMS, FWD_S + BWD_S))
    assert _read(dev) == pytest.approx(50.0)


@pytest.mark.parametrize("steps", [1, 4])
def test_launches_counted_by_name_per_step(steps):
    # 25 LayerNorms a step forward and backward, each at half its bound
    dev = []
    for _ in range(steps * 25):
        dev += [_kernel(FWD, 2 * FWD_S), _kernel(BWD, 2 * BWD_S),
                _kernel(OTHER, 1.0)]
    assert _read(dev) == pytest.approx(50.0)
