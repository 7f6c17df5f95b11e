"""The port's long-sequence attention against the JAX package, on the CPU.

`long_attention_reference` / `long_attention_bwd_reference` (the plain
versions that the Hopper kernels of `csrc/long_attention.cu` are held
against on the card, and that the wrapper runs on CPU tensors) against
`fused_attention_pallas` in interpret mode and its `jax.grad`, on the same
numpy inputs from a seed; then the layer and a ViT-L/14-shaped stack
(S=257) against the JAX modules with `fused="pallas"`; then the routing
rule of `models/layers.py`.

Tolerances. Forward: float32 1e-5 (summation order only); bfloat16 2e-2 (P
is rounded to bfloat16 before P·V on both sides, outputs are bfloat16).
Backward: float32 1e-4 (sums of up to 577 products in another order);
bfloat16 5e-2 (P and dS rounded before their products on both sides; one
rounding that falls the other way moves an output by 2^-8 of its value).
Modules in float32: 2e-5 absolute, as the other tower tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spn4cir_tpu.models import layers as jlayers
from spn4cir_tpu.ops.attention_kernels import fused_attention_pallas
from spn4cir_tpu_torch.models import layers as tlayers
from spn4cir_tpu_torch.models.convert import transformer_state_dict
from spn4cir_tpu_torch.ops import attention_kernels as ak

torch.set_num_threads(1)

SHAPES = [(4, 257, 64), (2, 577, 64), (3, 197, 88)]
DTYPES = [(torch.float32, jnp.float32, 1e-5, 1e-4),
          (torch.bfloat16, jnp.bfloat16, 2e-2, 5e-2)]


def _inputs(rng, shape, n):
    d = shape[-1]
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    arrs[0] *= d ** -0.5
    return arrs


def _np(x):
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tdt,jdt,tol,_", DTYPES)
def test_plain_forward_matches_interpreted_pallas_kernel(shape, tdt, jdt, tol,
                                                         _, rng):
    q, k, v = _inputs(rng, shape, 3)
    want = _np(fused_attention_pallas(*(jnp.asarray(t, jdt)
                                        for t in (q, k, v))))
    args = [torch.from_numpy(t).to(tdt) for t in (q, k, v)]
    got = ak.long_attention_reference(*args)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    # the wrapper on CPU tensors is the plain version, bit for bit, and
    # counts no launch
    before = ak.long_attention.launches
    assert torch.equal(ak.long_attention(*args), got)
    assert ak.long_attention.launches == before


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tdt,jdt,_,tol", DTYPES)
def test_plain_backward_matches_grad_of_pallas_kernel(shape, tdt, jdt, _, tol,
                                                      rng):
    q, k, v, do = _inputs(rng, shape, 4)
    jq, jk, jv, jdo = (jnp.asarray(t, jdt) for t in (q, k, v, do))
    _, vjp = jax.vjp(fused_attention_pallas, jq, jk, jv)
    want = [_np(g) for g in vjp(jdo)]
    args = [torch.from_numpy(t).to(tdt) for t in (q, k, v, do)]
    got = ak.long_attention_bwd_reference(*args)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == tdt
        np.testing.assert_allclose(a.float().numpy(), b, atol=tol, rtol=tol,
                                   err_msg=f"d{name}")
    # autograd through the wrapper on CPU tensors runs the same function
    leaves = [t.clone().requires_grad_() for t in args[:3]]
    before = ak.long_attention_bwd.launches
    auto = torch.autograd.grad(ak.long_attention(*leaves), leaves, args[3])
    assert ak.long_attention_bwd.launches == before
    for a, b in zip(auto, got):
        assert torch.equal(a, b)


def test_plain_backward_matches_float32_autograd_of_plain_forward(rng):
    """The roundings of the hand-written backward are those of the forward:
    in float32 it is the forward's derivative (1e-5)."""
    q, k, v, do = (torch.from_numpy(t)
                   for t in _inputs(rng, (2, 130, 40), 4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ak.long_attention_reference(*leaves), leaves,
                               do)
    for a, b in zip(ak.long_attention_bwd_reference(q, k, v, do), want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multi_head_attention_at_257_matches_jax_pallas_route(dtype, rng):
    """One attention layer at S=257, width 128, 2 heads of 64: the JAX module
    forced through its Pallas kernel (interpret mode), the port through
    `long_attention`."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = rng.standard_normal((2, 257, 128)).astype(np.float32)
    jmod = jlayers.MultiHeadAttention(2, dtype=jdt, fused="pallas")
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0),
                                      jnp.asarray(x, jdt)))
    want = _np(jmod.apply(params, jnp.asarray(x, jdt)))
    p = params["params"]
    tmod = tlayers.MultiHeadAttention(128, 2)
    tmod.load_state_dict({
        "in_proj_weight": torch.from_numpy(np.array(p["qkv"]["kernel"]).T),
        "in_proj_bias": torch.from_numpy(np.array(p["qkv"]["bias"])),
        "out_proj.weight": torch.from_numpy(np.array(p["out"]["kernel"]).T),
        "out_proj.bias": torch.from_numpy(np.array(p["out"]["bias"]))})
    calls = []
    orig = tlayers.long_attention
    tlayers.long_attention = lambda *a: calls.append(a[0].shape) or orig(*a)
    try:
        with torch.inference_mode():
            got = tmod(torch.from_numpy(x).to(dtype))
    finally:
        tlayers.long_attention = orig
    assert calls == [(4, 257, 64)]
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_vit_l14_shaped_stack_matches_jax_pallas_route(rng):
    """A ViT-L/14-shaped tiny tower body (S=257 tokens, heads of 64, two
    pre-LN blocks) against the JAX stack with `fused="pallas"`, outputs and
    the gradient of the input."""
    x = rng.standard_normal((2, 257, 128)).astype(np.float32)
    jmod = jlayers.Transformer(2, 2, fused="pallas")
    params = jax.device_get(jax.jit(jmod.init)(jax.random.PRNGKey(1),
                                                jnp.asarray(x)))
    want, vjp = jax.vjp(lambda t: jmod.apply(params, t), jnp.asarray(x))
    want_dx, = vjp(jnp.ones_like(want))
    tmod = tlayers.Transformer(128, 2, 2)
    tmod.load_state_dict(transformer_state_dict(params["params"]))
    leaf = torch.from_numpy(x).requires_grad_()
    got = tmod(leaf)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want_dx),
                               atol=1e-4, rtol=1e-4)


def test_remat_gives_the_same_output_and_gradients(rng):
    x = torch.from_numpy(rng.standard_normal((2, 130, 64)).astype(np.float32))
    plain = tlayers.Transformer(64, 2, 2)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in plain.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    remat = tlayers.Transformer(64, 2, 2, remat=True)
    remat.load_state_dict(plain.state_dict())
    grads = []
    for mod in (plain, remat):
        leaf = x.clone().requires_grad_()
        out = mod(leaf)
        out.square().sum().backward()
        grads.append((out.detach(), leaf.grad,
                      mod.resblocks[0].attn.in_proj_weight.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with torch.no_grad():       # no gradient wanted: nothing is checkpointed
        assert torch.equal(remat(x), grads[0][0])


# ---- the routing rule ----

@pytest.mark.parametrize("s,d,causal,masked,fused,want", [
    (50, 64, False, False, "auto", "short"),
    (128, 128, False, False, "auto", "short"),
    (77, 64, True, False, "auto", "short"),
    (129, 64, False, False, "auto", "long"),
    (197, 64, False, False, "auto", "long"),
    (257, 64, False, False, "auto", "long"),
    (577, 64, False, False, "auto", "long"),
    (257, 88, False, False, "auto", "long"),
    (5000, 64, False, False, "auto", "long"),     # no upper S
    (64, 136, False, False, "auto", "long"),      # the wrapper then raises
    (35, 64, False, True, "auto", "plain"),       # padding masks: MED
    (577, 64, False, True, "auto", "plain"),
    (577, 64, False, False, "plain", "plain"),
    (77, 64, True, False, "plain", "plain"),
])
def test_attention_route(s, d, causal, masked, fused, want):
    assert ak.attention_route(s, d, causal, masked, fused) == want


def test_no_maskless_attention_can_reach_the_plain_path_on_a_cuda_tensor():
    """The rule looks at no device, so what holds for every shape holds on
    the card: with fused="auto" a maskless or causal self-attention is
    routed to a kernel wrapper or raises; a wrapper launches or raises on a
    CUDA tensor (its own tests); so the plain path is out of reach."""
    import inspect

    assert "device" not in inspect.signature(ak.attention_route).parameters
    for s in (1, 2, 50, 128, 129, 256, 577, 1408, 1409, 4097):
        for d in (8, 40, 64, 88, 128, 136):
            assert ak.attention_route(s, d, False, False) in ("short", "long")
            if ak.kernel_takes(s, d):
                assert ak.attention_route(s, d, True, False) == "short"
            else:
                with pytest.raises(ValueError, match="causal"):
                    ak.attention_route(s, d, True, False)
    with pytest.raises(ValueError, match="fused"):
        ak.attention_route(50, 64, False, False, "pallas")
    # the layer asks the rule and nothing else
    src = inspect.getsource(tlayers.SelfAttention.attend)
    assert "attention_route(" in src and ".device.type" not in src
    assert "is_cuda" not in src


@pytest.mark.parametrize("shape,dtype,match", [
    ((2, 200, 36), torch.float32, "multiple of 8"),
    ((2, 200, 136), torch.float32, "multiple of 8"),
    ((2, 200, 64), torch.float16, "float32 or bfloat16"),
    ((200, 64), torch.float32, "shape"),
])
def test_long_attention_refuses_what_the_kernel_cannot_take(shape, dtype,
                                                            match):
    t = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        ak.long_attention(t, t, t)


def test_long_attention_bwd_never_runs_on_the_cpu():
    t = torch.zeros(2, 130, 64)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ak.long_attention_fwd(t, t, t)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ak.long_attention_bwd(t, t, t, t, t, torch.zeros(2, 130))


def test_bf16_kernels_refuse_a_misaligned_tensor():
    """The bf16 kernels copy their operands 16 bytes at a time; the
    wrappers' rule, checked before any launch, refuses a bf16 tensor whose
    data starts off a 16-byte boundary and lets float32 through (its
    kernels have a scalar path)."""
    ok = torch.zeros(2, 130, 64, dtype=torch.bfloat16)
    odd = torch.zeros(2 * 130 * 64 + 1, dtype=torch.bfloat16)[1:].view(
        2, 130, 64)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    for args in ((odd, ok, ok), (ok, ok, odd), (ok, ok, ok, odd)):
        with pytest.raises(ValueError, match="16-byte"):
            ak._check_aligned(*args)
    ak._check_aligned(ok, ok, ok, ok)
    odd32 = torch.zeros(2 * 130 * 64 + 1)[1:].view(2, 130, 64)
    ak._check_aligned(odd32, odd32, odd32)
