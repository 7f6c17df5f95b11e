"""Kimi-Linear-48B-A3B's decoder (`models/deepseek_v3.py` with KDA layers,
unrotated MLA and a share of the experts), kernel #15's plain version
(`ops/kda.py`) and the captioner's route to it, on the CPU at a tiny size
with seeded weights, against the plain float32 reference
`cirbench/reference/kimi_linear.py`. Logits are compared, not tokens.

Tolerances: both sides compute in float32 on the CPU and differ only in the
order of their sums (the recurrence's einsums against the reference's, the
program's convolution as four multiply-adds against `conv1d`), so logits
agree within 1e-4 relative L2 a position, and the recurrence within 1e-5
of a float64 one; a state zeroed or a convolution tail dropped at the
prefill -> decode boundary moves the next logits by > 1e-2. The tail's rows
themselves differ between a prefill and decode steps only in the GEMM's
blocking, within the states' 1e-5.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from cirbench.reference import kimi_linear as ref
from cirbench.reference.common import Precision
from spn4cir_tpu_torch.datagen import captioner as tcap
from spn4cir_tpu_torch.models import deepseek_v3 as dv
from spn4cir_tpu_torch.models import llava as tv
from spn4cir_tpu_torch.ops import kda as kk
from spn4cir_tpu_torch.ops import moe_grouped as mg
from spn4cir_tpu_torch.tokenizer.bytelevel import ByteTokenizer

TOL = 1e-4
REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "cirbench" / "configs" / "llava-kimi-linear-48b-a3b.json"


def _model(seed=0, **kw):
    cfg = dv.DeepseekV3Config.tiny_kimi(vocab_size=97, **kw)
    model = dv.DeepseekV3ForCausalLM(cfg)
    g = torch.Generator().manual_seed(seed)
    model.init_weights(g)
    with torch.no_grad():  # norms and a selection bias away from 1 and 0
        for name, p in model.named_parameters():
            if p.dim() == 1 and name.endswith(("norm.weight",
                                               "correction_bias")):
                p.normal_(1.0 if name.endswith("weight") else 0.0, 0.1,
                          generator=g)
    return cfg, model


def _get(model):
    return dict(model.named_parameters()).__getitem__


def _gap(a, b):
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


def _ids(seed, b=2, s=12):
    return torch.randint(0, 97, (b, s),
                         generator=torch.Generator().manual_seed(seed))


def test_prefill_logits_match_the_reference():
    cfg, model = _model(0)
    ids = _ids(1)
    with torch.no_grad():
        got = model(input_ids=ids)
        emb = model.model.embed_tokens.weight[ids]
        want, stats = ref.decoder(_get(model), emb, cfg.to_hf(), range(12),
                                  Precision())
    assert _gap(got, want) < TOL
    assert stats["flips"] == 0 and stats["routes"] == 2 * 12 * 5
    assert [cfg.is_kda(i) for i in range(6)] == [True, True, True, False,
                                                True, False]


def _prefill_decode(model, cfg, emb, cut, plant=None):
    """Logits of positions cut - 1 .. S - 2 through the prefill of [0, cut)
    and decode steps after it; `plant` edits the state at the boundary."""
    b, s, _ = emb.shape
    with torch.no_grad():
        state = dv.init_deepseek_state(model, cfg, b, s)
        logits = [dv.deepseek_v3_prefill(model, cfg, state, emb[:, :cut])[0]]
        if plant is not None:
            plant(state)
        for pos in range(cut, s - 1):
            logits.append(dv.deepseek_v3_decode_step(model, cfg, state,
                                                     emb[:, pos], pos)[0])
    return torch.stack(logits, 1), state


def test_prefill_then_decode_matches_the_full_forward_at_every_position():
    """Prefill of 5 positions, then decode steps through the latent cache
    (2 MLA layers) and the KDA states and tails (4 layers): the logits of
    every position after the prompt equal the reference's full forward."""
    cfg, model = _model(2)
    ids = _ids(5, b=3, s=13)
    emb = model.model.embed_tokens.weight[ids].detach()
    got, state = _prefill_decode(model, cfg, emb, 5)
    with torch.no_grad():
        want, _ = ref.decoder(_get(model), emb, cfg.to_hf(), range(4, 12),
                              Precision())
    assert _gap(got, want) < TOL
    assert state.latent.shape[0] == 2 and state.kda.shape[:2] == (4, 3)
    assert state.kda.dtype == torch.float32
    assert state.conv.shape == (4, 3, 3, 3 * cfg.kda_dim)


@pytest.mark.parametrize("fault", ["state", "tail"])
def test_a_state_lost_at_the_boundary_is_caught(fault):
    """A KDA state zeroed, or a convolution tail dropped, between the
    prefill and the first decode step: the comparison fails by far."""
    cfg, model = _model(2)
    ids = _ids(5, b=3, s=13)
    emb = model.model.embed_tokens.weight[ids].detach()

    def plant(state):
        (state.kda if fault == "state" else state.conv).zero_()

    got, _ = _prefill_decode(model, cfg, emb, 5, plant)
    with torch.no_grad():
        want, _ = ref.decoder(_get(model), emb, cfg.to_hf(), range(4, 12),
                              Precision())
    assert _gap(got, want) > 1e-2


def test_state_and_tail_carry_across_the_boundary():
    """The KDA states and tails after a prefill of 4 and 5 decode steps are
    those of a prefill of all 9 positions."""
    cfg, model = _model(3)
    emb = model.model.embed_tokens.weight[_ids(6, s=10)].detach()
    _, stepped = _prefill_decode(model, cfg, emb, 4)
    with torch.no_grad():
        whole = dv.init_deepseek_state(model, cfg, 2, 10)
        dv.deepseek_v3_prefill(model, cfg, whole, emb[:, :9])
    torch.testing.assert_close(stepped.kda, whole.kda, atol=1e-5, rtol=1e-5)
    # the rows themselves: a projection of one position against nine
    # differs in the GEMM's blocking alone
    torch.testing.assert_close(stepped.conv, whole.conv, atol=1e-5, rtol=1e-5)
    assert float(whole.conv.abs().min()) > 0


def _recurrence64(q, k, v, g, beta):
    """The gated delta rule in its matrix form, float64:
    S_t = (I − β k kᵀ) Diag(α) S_{t−1} + β k vᵀ, o_t = S_tᵀ q."""
    q, k, v, g, beta = (x.double() for x in (q, k, v, g, beta))
    b, t, h, d = q.shape
    s = torch.zeros(b, h, d, d, dtype=torch.float64)
    eye = torch.eye(d, dtype=torch.float64)
    out = []
    for i in range(t):
        kt = k[:, i] / torch.sqrt((k[:, i] ** 2).sum(-1, keepdim=True) + 1e-6)
        qt = q[:, i] / torch.sqrt((q[:, i] ** 2).sum(-1, keepdim=True) + 1e-6)
        bt = beta[:, i, :, None, None]
        s = ((eye - bt * kt[..., None] * kt[..., None, :])
             @ (torch.exp(g[:, i])[..., None] * s)
             + bt * kt[..., None] * v[:, i, :, None, :])
        out.append(torch.einsum("bhij,bhi->bhj", s, qt * d ** -0.5))
    return torch.stack(out, 1), s


@pytest.mark.parametrize("d", [16, 128])
def test_kernel_15_plain_version_is_the_token_recurrence(d):
    """`kda_prefill` over 7 tokens, then `kda_decode` over 3 more from its
    state, against the matrix form in float64 over all 10."""
    g_ = torch.Generator().manual_seed(d)
    b, t, h = 2, 10, 3
    q, k, v = (torch.randn(b, t, h, d, generator=g_) for _ in range(3))
    g = -torch.rand(b, t, h, d, generator=g_) * 0.5
    beta = torch.rand(b, t, h, generator=g_)
    want, s_want = _recurrence64(q, k, v, g, beta)
    state = torch.full((b, h, d, d), 7.0)          # a prefill ignores it
    o = [kk.kda_prefill(q[:, :7], k[:, :7], v[:, :7], g[:, :7], beta[:, :7],
                        state)]
    for i in range(7, t):
        sl = slice(i, i + 1)
        o.append(kk.kda_decode(q[:, sl], k[:, sl], v[:, sl], g[:, sl],
                               beta[:, sl], state))
    torch.testing.assert_close(torch.cat(o, 1).double(), want, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(state.double(), s_want, atol=1e-5, rtol=1e-5)
    assert kk.kda_prefill.launches == kk.kda_decode.launches == 0


def test_expert_shares_add_up_to_the_uncut_layer():
    """Two devices' shares of an 8-expert layer, {0-3} and {4-7}: their
    routed parts, with the shared expert counted once, equal the uncut
    reference layer; each share routes over all 8 and runs only the rows
    that land on its own experts."""
    cfg, model = _model(4)
    moe_ = model.model.layers[2].mlp
    x = torch.randn(9, cfg.hidden_size, generator=torch.Generator().manual_seed(9))
    outs = []
    for first in (0, 4):
        share = dataclasses.replace(cfg, experts_held=4, first_expert=first)
        part = dv.DeepseekV3MoE(share)
        with torch.no_grad():
            part.gate.load_state_dict(moe_.gate.state_dict())
            part.shared_experts.load_state_dict(moe_.shared_experts.state_dict())
            for i in range(4):
                part.experts[i].load_state_dict(moe_.experts[first + i].state_dict())
            assert len(part.experts) == 4 and part.gate.weight.shape[0] == 8
            outs.append(dv._moe(share, part, x, 2, None))
            src, offsets, _, held = dv._held_routes(
                share, dv.route(share, part.gate, x)[0])
            assert int(offsets[-1]) == int(held.sum()) < 9 * 2
    with torch.no_grad():
        shared = dv._swiglu(moe_.shared_experts, x)
        hf = cfg.to_hf()
        want, _ = ref.moe(_get(model), "model.layers.2.mlp.", x, hf,
                          Precision(), None, uncut=True)
        half, _ = ref.moe(_get(model), "model.layers.2.mlp.", x,
                          dict(hf, num_experts=4, published={"num_experts": 8}),
                          Precision(), None)
    torch.testing.assert_close(outs[0] + outs[1] - shared, want, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(outs[0], half, atol=1e-5, rtol=1e-5)
    assert mg.moe_grouped.launches == 0


def test_the_catalog_row_round_trips_and_the_file_holds_a_share():
    """`from_hf` of the configuration file (Kimi's key names, 64 of 256
    experts held) and `to_hf` back give the file's values; the file less
    the share is the published row."""
    file = json.loads(CONFIG.read_text())
    cfg = dv.DeepseekV3Config.from_hf(file)
    assert cfg == dv.DeepseekV3Config.kimi_linear_48b_a3b(experts_held=64)
    assert cfg.n_routed_experts == 256 and cfg.held_experts == 64
    assert cfg.mla_layers == (3, 7, 11, 15, 19, 23, 26)
    assert all(file[k] == v for k, v in cfg.to_hf().items())
    row = {k: v for k, v in file.items() if k not in (
        "published", "first_expert_held")}
    row["num_experts"] = file["published"]["num_experts"]
    whole = dv.DeepseekV3Config.from_hf(row)
    assert whole == dv.DeepseekV3Config.kimi_linear_48b_a3b()
    assert dv.DeepseekV3Config.from_hf(whole.to_hf()) == whole
    assert all(row[k] == v for k, v in whole.to_hf().items())
    assert "head_dim" not in whole.to_hf()          # read by neither rule
    with pytest.raises(ValueError, match="moe_router_activation_func"):
        dv.DeepseekV3Config.from_hf(dict(row, moe_router_activation_func="softmax"))
    with pytest.raises(ValueError, match="routed experts"):
        dataclasses.replace(whole, experts_held=64, first_expert=200)


def test_mla_rotates_nothing_with_nope():
    """`mla_use_nope`: no tables, the rope dimensions pass as they are, and
    the decompressed attention equals the reference's unrotated MLA."""
    cfg, model = _model(5)
    assert dv.rope_tables(cfg, torch.arange(4)) == (None, None)
    attn = model.model.layers[3].self_attn
    h = torch.randn(2, 7, cfg.hidden_size, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        q_nope, q_pe, latent = dv._mla_inputs(cfg, attn, h, None, None)
        q = torch.nn.functional.linear(h, attn.q_proj.weight).view(
            2, 7, cfg.num_heads, cfg.qk_head_dim)
        assert torch.equal(q_pe, q[..., cfg.qk_nope_head_dim:])
        got = dv._mla_decompressed(cfg, attn, q_nope, q_pe, latent,
                                   dv._causal(7, "cpu"))
        want = ref.mla_nope(_get(model), "model.layers.3.self_attn.", h,
                            cfg.to_hf(), Precision())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_moonlight_keeps_its_arithmetic_to_the_bit():
    """Moonlight's tiny config runs no KDA layer and holds every expert:
    its MoE layer is the whole-layer arithmetic of before (route, the
    permutation over all experts, #14's plain version, the fixed-order
    combine), its decode state the old shapes, and generation through the
    state gives the full forward's tokens."""
    cfg = dv.DeepseekV3Config.tiny(vocab_size=97)
    assert cfg.kda_layers == () and cfg.held_experts == cfg.n_routed_experts
    model = dv.DeepseekV3ForCausalLM(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    moe_ = model.model.layers[1].mlp
    x = torch.randn(5, cfg.hidden_size, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        idx, w = dv.route(cfg, moe_.gate, x)
        src, offsets, inv = mg.route_permutation(idx, cfg.n_routed_experts)
        y = mg.moe_grouped(x, src, offsets, moe_.w_gate, moe_.w_up, moe_.w_down)
        old = (mg.moe_combine(y, inv, w).to(x.dtype)
               + dv._swiglu(moe_.shared_experts, x))
        assert torch.equal(dv._moe(cfg, moe_, x, 1, None), old)
        state = dv.init_deepseek_state(model, cfg, 2, 6)
    assert state.latent.shape == (3, 2, 6, cfg.latent_dim)
    assert state.kda is None and state.conv is None
    assert [cfg.slot(i) for i in range(3)] == [0, 1, 2]


def test_the_captioner_runs_kimi_linear_through_its_deepseek_route():
    """`make_llava_captioner(llava_lm="kimi-linear-48b-a3b")` builds the
    LLaVA captioner over `models/deepseek_v3.py` (no branch of its own),
    and the whole caption path matches the reference's teacher-forced
    forward over the prompt and the tokens it fed."""
    cap, _, _ = tcap.make_llava_captioner(
        None, llava_size="tiny", llava_lm="kimi-linear-48b-a3b",
        max_new_tokens=2, device="cpu")
    assert isinstance(cap.model, tv.LlavaDeepseekV3ForCausalLM)
    assert cap.cfg.deepseek and cap.lm_cfg.kda_layers
    assert tv.LlavaConfig.kimi_linear().llama == \
        dv.DeepseekV3Config.kimi_linear_48b_a3b(experts_held=64)

    tok = ByteTokenizer()
    cap = tv.LlavaCaptioner(tv.LlavaConfig.tiny(vocab_size=258, lm="kimi"),
                            tok, device="cpu")
    cap.init_params(torch.Generator().manual_seed(2))
    imgs = torch.randn(2, 28, 28, 3, generator=torch.Generator().manual_seed(1))
    seen = {"logits": [], "token": [], "route": {}}

    def tap(kind, index, t):
        if kind == "route":
            seen["route"].setdefault(index, []).append(t.clone())
        else:
            seen[kind].append(t.clone())

    cap.caption(imgs, "describe", max_new_tokens=3, tap=tap)
    ids = cap.prompt_ids("describe")
    cut = ids.index(tv.IMAGE_TOKEN_INDEX)
    tokens = torch.stack(seen["token"], 1)
    chosen = [torch.cat(seen["route"][k], 1) for k in sorted(seen["route"])]
    hf = dict(cap.lm_cfg.to_hf(), vision=dict(
        image_size=28, patch_size=14, width=32, layers=3, heads=4,
        select_layer=-2))
    with torch.no_grad():
        want, stats = ref.caption_logits(
            _get(cap.model), imgs, torch.tensor(ids[:cut]),
            torch.tensor(ids[cut + 1:]), tokens[:, :-1], hf, Precision(),
            chosen)
    assert _gap(torch.stack(seen["logits"], 1), want) < TOL
    assert stats["flips"] == 0


def test_kda_draws_its_decay_as_published():
    """`A_log` from A ~ U(1, 16) and `dt_bias` from dt log-uniform in
    [1e-3, 0.1] through the inverse softplus, both float32 in a bf16
    model; the norms start at 1."""
    cfg = dv.DeepseekV3Config.tiny_kimi(vocab_size=97)
    model = dv.DeepseekV3ForCausalLM(cfg, dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(0))
    attn = model.model.layers[0].self_attn
    assert attn.A_log.dtype == attn.dt_bias.dtype == torch.float32
    a = attn.A_log.detach().exp()
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    dt = torch.nn.functional.softplus(attn.dt_bias.detach())
    assert float(dt.min()) >= 0.99e-3 and float(dt.max()) <= 0.101
    assert torch.equal(attn.o_norm.weight, torch.ones_like(attn.o_norm.weight))
    assert attn.q_conv1d.weight.shape == (cfg.kda_dim, 1, 4)
