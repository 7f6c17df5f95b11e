"""The DeepSeek-V3 decoder (Moonlight-16B-A3B's architecture) and its place
in the LLaVA captioner, on the CPU at the tiny preset with seeded weights,
against the plain float32 reference `cirbench/reference/moonlight.py`.
Logits are compared, not tokens.

Tolerances: both sides compute in float32 on the CPU and differ only in the
order of their sums (and the absorbed form's order of products), so logits
agree within 1e-4 relative L2 a position (a dropped term is > 1e-1) and an
attention output within 1e-5 absolute. The grouped experts' plain version
rounds h and y to the input's type once, as the kernel does: in float32
that is no rounding, so it meets a per-token float64 loop within 1e-5.
"""

from __future__ import annotations

import os

import pytest
import torch

from cirbench.reference.common import Precision
from cirbench.reference.moonlight import caption_logits, decoder, moe
from spn4cir_tpu_torch.datagen import captioner as tcap
from spn4cir_tpu_torch.models import deepseek_v3 as dv
from spn4cir_tpu_torch.models import llava as tv
from spn4cir_tpu_torch.ops import moe_grouped as mg
from spn4cir_tpu_torch.tokenizer.bytelevel import ByteTokenizer

TOL = 1e-4


def _model(seed=0, **kw):
    cfg = dv.DeepseekV3Config.tiny(vocab_size=97, **kw)
    model = dv.DeepseekV3ForCausalLM(cfg)
    g = torch.Generator().manual_seed(seed)
    model.init_weights(g)
    with torch.no_grad():  # norms and a selection bias away from 1 and 0
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.normal_(1.0 if name.endswith("weight") else 0.0, 0.1,
                          generator=g)
    return cfg, model


def _get(model):
    return dict(model.named_parameters()).__getitem__


def _gap(a, b):
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_full_forward_matches_the_reference(seed):
    cfg, model = _model(seed)
    ids = torch.randint(0, 97, (2, 11), generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        got = model(input_ids=ids)
        emb = model.model.embed_tokens.weight[ids]
        ref, stats = decoder(_get(model), emb, cfg.to_hf(), range(11),
                             Precision())
    assert _gap(got, ref) < TOL
    assert stats["flips"] == 0 and stats["routes"] == 2 * 2 * 11


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
def test_prefill_then_decode_matches_the_reference(cache):
    """Prefill of 7 positions, then 5 decode steps through the latent cache,
    against the reference's full forward over all 12 (a bf16 cache rounds
    the latent: 2e-2)."""
    cfg, model = _model(2)
    ids = torch.randint(0, 97, (3, 12), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        emb = model.model.embed_tokens.weight[ids]
        state = dv.init_deepseek_state(model, cfg, 3, 12, dtype=cache)
        logits = [dv.deepseek_v3_prefill(model, cfg, state, emb[:, :7])[0]]
        for pos in range(7, 12):
            logits.append(dv.deepseek_v3_decode_step(model, cfg, state,
                                                     emb[:, pos], pos)[0])
        got = torch.stack(logits[:-1], 1)
        ref, _ = decoder(_get(model), emb, cfg.to_hf(), range(6, 11),
                         Precision())
    assert state.latent.dtype == cache
    assert _gap(got, ref) < (TOL if cache is torch.float32 else 2e-2)


def test_absorbed_decode_equals_decompressed_attention():
    """One query against 9 cached latent rows: q_nope through W_k into the
    latent and the values back through W_v give the per-head form's
    output."""
    cfg, model = _model(3)
    attn = model.model.layers[1].self_attn
    g = torch.Generator().manual_seed(7)
    h = torch.randn(2, 9, cfg.hidden_size, generator=g)
    cos, sin = dv.rope_tables(cfg, torch.arange(9))
    with torch.no_grad():
        q_nope, q_pe, latent = dv._mla_inputs(cfg, attn, h, cos, sin)
        mask = torch.zeros(1, 9)                     # the last row sees all
        want = dv._mla_decompressed(cfg, attn, q_nope[:, -1:], q_pe[:, -1:],
                                    latent, mask)
        w_k, w_v = dv.absorbed_weights(cfg, attn)
        got = dv._mla_absorbed(cfg, attn, q_nope[:, -1:], q_pe[:, -1:],
                               latent, w_k, w_v)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _slice_step(model, cfg, state, x, pos):
    """The decode step with its position on the host: row `pos` written by
    slice assignment, the attention over cache rows [0, pos] alone."""
    x = x.to(model.lm_head.weight.dtype)[:, None]
    cos, sin = dv.rope_tables(cfg, torch.full((1,), pos))
    for li, layer in enumerate(model.model.layers):
        def attend(attn, h, li=li):
            q_nope, q_pe, latent = dv._mla_inputs(cfg, attn, h, cos, sin)
            state.latent[li, :, pos:pos + 1] = latent
            return dv._mla_absorbed(cfg, attn, q_nope, q_pe,
                                    state.latent[li, :, :pos + 1],
                                    state.w_k[li], state.w_v[li])
        x = dv._layer(cfg, layer, li, x, attend, None)
    return dv._head(model, x[:, 0])


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
def test_masked_decode_step_equals_the_slice_form(cache):
    """The step with its position in a tensor, attending to every row of a
    12-row cache under the mask, against the slice form at every position
    after a 4-token prefill. The rows above the position hold noise, as a
    cache reused from an earlier call does: their weights are exactly 0, so
    the logits and rows [0, pos] agree within 1e-6 (the sums over 12 rows
    and over pos + 1 run in another order), the first layer's rows, which
    no attention precedes, to the bit."""
    cfg, model = _model(4)
    g = torch.Generator().manual_seed(6)
    ids = torch.randint(0, 97, (3, 12), generator=g)
    with torch.no_grad():
        emb = model.model.embed_tokens.weight[ids]
        masked = dv.init_deepseek_state(model, cfg, 3, 12, dtype=cache)
        dv.deepseek_v3_prefill(model, cfg, masked, emb[:, :4])
        sliced = dv.DeepseekV3DecodeState(masked.latent.clone(), masked.w_k,
                                          masked.w_v)
        masked.latent[:, :, 4:] = 10 * torch.randn(
            masked.latent[:, :, 4:].shape, generator=g)
        for pos in range(4, 12):
            got = dv.deepseek_v3_decode_step(model, cfg, masked, emb[:, pos],
                                             torch.tensor(pos))[0]
            want = _slice_step(model, cfg, sliced, emb[:, pos], pos)
            assert _gap(got, want) < 1e-6, pos
            seen = slice(0, pos + 1)
            assert _gap(masked.latent[:, :, seen].float(),
                        sliced.latent[:, :, seen].float()) < 1e-6, pos
            assert torch.equal(masked.latent[0, :, seen],
                               sliced.latent[0, :, seen]), pos


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
def test_generate_on_the_cpu_taps_as_before_and_runs_no_graph(cache):
    """`deepseek_v3_generate` on the CPU: the prefill's routes, then each
    step's routes, logits and token, in that order and at those shapes; the
    tokens of the slice form's loop; every step eager, no graph."""
    from spn4cir_tpu_torch.models.generation import decode_loop

    cfg, model = _model(5)
    ids = torch.randint(0, 97, (2, 6), generator=torch.Generator().manual_seed(8))
    emb = model.model.embed_tokens.weight[ids].detach()
    seen = []

    def tap(kind, index, t):
        seen.append((kind, index, tuple(t.shape)))

    step = dv.deepseek_v3_decode_step
    before = (step.eager_steps, step.captures, step.replays)
    got = dv.deepseek_v3_generate(model, cfg, emb, eos_id=3, pad_id=0,
                                  max_new_tokens=5, cache_dtype=cache,
                                  tap=tap)
    moe = [li for li in range(cfg.num_layers) if cfg.is_moe(li)]
    k = cfg.num_experts_per_tok
    want = [("route", li, (2, 6, k)) for li in moe]
    want += [("logits", 0, (2, 97)), ("token", 0, (2,))]
    for i in range(1, 5):
        want += [("route", li, (2, 1, k)) for li in moe]
        want += [("logits", i, (2, 97)), ("token", i, (2,))]
    assert seen == want
    assert (step.eager_steps, step.captures, step.replays) == (
        before[0] + 4, before[1], before[2])
    assert model._decode_graph is None

    with torch.no_grad():
        state = dv.init_deepseek_state(model, cfg, 2, 11, dtype=cache)
        slice_ids = decode_loop(
            lambda: dv.deepseek_v3_prefill(model, cfg, state, emb)[0],
            lambda x, i: _slice_step(model, cfg, state, x, 5 + i),
            lambda tok: model.model.embed_tokens.weight[tok],
            max_new_tokens=5, eos_id=3, pad_id=0,
            sample=lambda logits: logits.argmax(-1))
    assert torch.equal(got, slice_ids)


def test_rope_deinterleaves_pairs_then_rotates_half():
    x = torch.arange(8, dtype=torch.float32).view(1, 8)
    cos, sin = torch.zeros(1, 8), torch.ones(1, 8)
    # [x0 x2 x4 x6 | x1 x3 x5 x7], rotated: [-x1 -x3 -x5 -x7 | x0 x2 x4 x6]
    got = dv.apply_rope_interleave(x, cos, sin)
    assert got.tolist() == [[-1.0, -3.0, -5.0, -7.0, 0.0, 2.0, 4.0, 6.0]]


def test_router_chooses_by_biased_scores_and_weights_by_unbiased():
    cfg = dv.DeepseekV3Config.tiny(n_routed_experts=4, num_experts_per_tok=2)
    gate = dv.DeepseekV3TopkRouter(cfg)
    with torch.no_grad():
        gate.weight.copy_(torch.tensor([[2.0], [1.0], [0.0], [-1.0]])
                          * torch.eye(1, cfg.hidden_size))
        gate.e_score_correction_bias.copy_(torch.tensor([0.0, 0.0, 3.0, 0.0]))
        h = torch.zeros(1, cfg.hidden_size)
        h[0, 0] = 1.0
        idx, w = dv.route(cfg, gate, h)
    scores = torch.sigmoid(torch.tensor([2.0, 1.0, 0.0, -1.0]))
    assert sorted(idx[0].tolist()) == [0, 2]    # the bias brings 2 in over 1
    chosen = scores[idx[0]]
    torch.testing.assert_close(w[0], chosen / (chosen.sum() + 1e-20) * 2.446)
    assert float(w.sum()) == pytest.approx(2.446)
    # and the reference makes the same choice with the same weights
    get = {"m.gate.weight": gate.weight,
           "m.gate.e_score_correction_bias": gate.e_score_correction_bias}
    cfg_hf = dict(cfg.to_hf(), num_experts_per_tok=2)
    seen = []

    def getter(name):
        if name in get:
            return get[name]
        seen.append(name)
        width = 4 if "shared" in name else 2
        shape = ((cfg.hidden_size, width) if "down" in name
                 else (width, cfg.hidden_size))
        return torch.zeros(shape)

    _, st = moe(getter, "m.", h, cfg_hf, Precision(), None)
    assert sorted(st["own"][0].tolist()) == [0, 2]
    assert {n.split(".")[2] for n in seen if "experts." in n
            and "shared" not in n} == {"0", "2"}


@pytest.mark.parametrize("tokens,k,experts,empty", [
    (7, 3, 8, (1, 5)),            # uneven, two empty experts
    (40, 6, 16, ()),
    (3, 2, 8, (0, 2, 3, 4, 6)),   # most experts empty
])
def test_grouped_experts_plain_version_matches_a_per_token_loop(
        tokens, k, experts, empty):
    g = torch.Generator().manual_seed(tokens)
    d, i = 24, 16
    x = torch.randn(tokens, d, generator=g)
    wg, wu = torch.randn(2, experts, i, d, generator=g) * d ** -0.5
    wd = torch.randn(experts, d, i, generator=g) * i ** -0.5
    logits = torch.randn(tokens, experts, generator=g)
    logits[:, list(empty)] = float("-inf")
    idx = torch.topk(logits, k, dim=-1).indices
    w = torch.rand(tokens, k, generator=g)
    src, offsets, inv = mg.route_permutation(idx, experts)
    counts = offsets.diff().tolist()
    assert all(counts[e] == 0 for e in empty) and sum(counts) == tokens * k
    y = mg.moe_grouped(x, src, offsets, wg, wu, wd)
    got = mg.moe_combine(y, inv, w)
    want = torch.zeros(tokens, d, dtype=torch.float64)
    for t in range(tokens):
        for j in range(k):
            e = int(idx[t, j])
            xt = x[t].double()
            h = torch.nn.functional.silu(wg[e].double() @ xt) * (wu[e].double() @ xt)
            want[t] += w[t, j].double() * (wd[e].double() @ h)
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=1e-5)
    assert mg.moe_grouped.launches == 0          # the CPU route counts nothing


def test_route_permutation_sorts_by_expert_stably():
    idx = torch.tensor([[2, 0], [0, 1], [2, 1]])
    src, offsets, inv = mg.route_permutation(idx, 4)
    assert offsets.tolist() == [0, 2, 4, 6, 6]
    assert src.tolist() == [0, 1, 1, 2, 0, 2]     # expert 0, 1, 2 in turn
    flat = idx.reshape(-1)
    assert (flat[torch.argsort(inv)] == flat.sort(stable=True).values).all()
    assert mg.moe_plan(768, 64) == 0 and mg.moe_plan(242688, 64) == 1


def test_state_dict_names_are_hf_deepseek_v3s():
    cfg = dv.DeepseekV3Config.tiny(n_routed_experts=3, num_layers=2)
    names = set(dv.DeepseekV3ForCausalLM(cfg, device="meta").state_dict())
    want = {"model.embed_tokens.weight", "model.norm.weight", "lm_head.weight"}
    for i in range(2):
        p = f"model.layers.{i}."
        want |= {p + "input_layernorm.weight",
                 p + "post_attention_layernorm.weight"}
        want |= {f"{p}self_attn.{n}.weight" for n in (
            "q_proj", "kv_a_proj_with_mqa", "kv_a_layernorm", "kv_b_proj",
            "o_proj")}
        mlps = ([p + "mlp."] if i == 0 else
                [f"{p}mlp.experts.{e}." for e in range(3)]
                + [p + "mlp.shared_experts."])
        want |= {f"{m}{n}_proj.weight" for m in mlps
                 for n in ("gate", "up", "down")}
        if i:
            want |= {p + "mlp.gate.weight", p + "mlp.gate.e_score_correction_bias"}
    assert names == want


def test_experts_are_views_of_the_stacked_weights_after_a_move():
    cfg, model = _model(4)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    fresh = dv.DeepseekV3ForCausalLM(cfg, device="meta")
    fresh.to_empty(device="cpu")
    fresh.load_state_dict(sd)
    moe_ = fresh.model.layers[2].mlp
    for e in (0, 7):
        assert moe_.experts[e].down_proj.weight.data_ptr() == \
            moe_.w_down[e].data_ptr()
        assert torch.equal(moe_.w_gate[e], sd[f"model.layers.2.mlp.experts.{e}."
                                              "gate_proj.weight"])
    ids = torch.randint(0, 97, (1, 5))
    with torch.no_grad():
        assert torch.equal(fresh(input_ids=ids), model(input_ids=ids))



@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_experts_are_stacked_again_after_an_assigning_load(device):
    """`load_state_dict(..., assign=True)` puts new tensors in place of the
    experts' views: the stacks #14 reads are built again from them."""
    cfg, model = _model(4)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    fresh = dv.DeepseekV3ForCausalLM(cfg, device=device)
    fresh.load_state_dict(sd, assign=True)
    moe_ = fresh.model.layers[2].mlp
    for e in (0, 7):
        assert moe_.experts[e].gate_proj.weight.data_ptr() == \
            moe_.w_gate[e].data_ptr()
        assert torch.equal(moe_.w_down[e], sd[f"model.layers.2.mlp.experts.{e}."
                                              "down_proj.weight"])
    ids = torch.randint(0, 97, (1, 5))
    with torch.no_grad():
        assert torch.equal(fresh(input_ids=ids), model(input_ids=ids))


def _replace(model, how):
    layer = model.model.layers[2]
    with torch.no_grad():
        if how == "copy_":
            layer.self_attn.kv_b_proj.weight.mul_(2.0)
        elif how == "assign":
            model.load_state_dict({k: v.clone() for k, v in
                                   model.state_dict().items()}, assign=True)
        elif how == "data":
            w = layer.self_attn.kv_b_proj.weight
            w.data = 2.0 * w.data
        else:
            model.lm_head.weight = torch.nn.Parameter(
                model.lm_head.weight.detach().clone())


@pytest.mark.parametrize("how,moved", [("copy_", False), ("assign", True),
                                       ("data", True), ("parameter", True)])
def test_decode_graph_is_dropped_when_a_tensor_it_reads_moves(how, moved):
    """A captured step reads the weights where they lay at capture: a
    call's check keeps the graph over an in-place update and drops it when
    a parameter, a buffer or an expert stack has moved, so the step
    captures again. Either way `begin` takes the absorbed halves of the new
    weights."""
    cfg, model = _model(3)
    with torch.no_grad():                  # as `deepseek_v3_generate` runs
        graph = dv.DecodeGraph((2, 8, torch.float32, torch.device("cpu")),
                               model, cfg)
        captured = object()             # what `_capture` leaves, on the CPU
        graph.graph, graph.addresses = captured, dv._addresses(model)
        graph.begin(model, cfg)
        graph.drop_if_moved(model)
        assert graph.graph is captured and graph.fresh
        _replace(model, how)
        state = graph.begin(model, cfg)
        graph.drop_if_moved(model)
    assert (graph.graph is None) == moved
    w_k, w_v = dv.absorbed_weights(cfg, model.model.layers[2].self_attn)
    assert torch.equal(state.w_k[2], w_k) and torch.equal(state.w_v[2], w_v)

class _FakeGraph:
    """`torch.cuda.CUDAGraph`'s stand-in: a replay runs no Python."""

    def replay(self):
        pass


def test_decode_graph_counts_each_replays_launches(monkeypatch):
    """`ops/cuda_build`'s rule under the decode graph: the eager step's
    launches count, the capture's none, and each replay the step's."""
    import contextlib

    from spn4cir_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "COUNTED", [])

    def kernel():
        kernel.launches += 1
    cuda_build.counted(kernel)

    def step(model, cfg, state, x, pos, tap=None):
        for _ in range(3):
            kernel()
        return (x.sum(-1),)
    step.eager_steps = step.captures = step.replays = 0
    monkeypatch.setattr(dv, "deepseek_v3_decode_step", step)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph: contextlib.nullcontext())
    cfg, model = _model(3)
    with torch.no_grad():
        graph = dv.DecodeGraph((2, 8, torch.float32, torch.device("cpu")),
                               model, cfg)
        x = torch.ones(2, cfg.hidden_size)
        graph.step(model, cfg, x, 0, None)           # eager
        assert kernel.launches == 3
        for replays in (1, 2, 3):
            graph.step(model, cfg, x, replays, None)
            assert kernel.launches == 3 + 3 * replays
    assert (step.eager_steps, step.captures, step.replays) == (1, 1, 3)


def test_config_round_trips_hf_keys_and_refuses_other_geometries():
    cfg = dv.DeepseekV3Config.moonlight_16b_a3b()
    assert dv.DeepseekV3Config.from_hf(cfg.to_hf()) == cfg
    assert cfg.to_hf()["num_hidden_layers"] == 27
    with pytest.raises(ValueError, match="q compression"):
        dv.DeepseekV3Config(q_lora_rank=1536)
    with pytest.raises(ValueError, match="topk_group"):
        dv.DeepseekV3Config(n_group=8, topk_group=4)
    with pytest.raises(ValueError, match="scoring_func"):
        dv.DeepseekV3Config.from_hf(dict(cfg.to_hf(), scoring_func="softmax"))


# ---------------------------------------------------------------------------
# the captioner
# ---------------------------------------------------------------------------

def _captioner(seed=0):
    tok = ByteTokenizer()
    cap = tv.LlavaCaptioner(tv.LlavaConfig.tiny(vocab_size=258, lm="deepseek"),
                            tok, device="cpu")
    cap.init_params(torch.Generator().manual_seed(seed))
    return tok, cap


def test_captioner_with_moonlight_matches_the_reference():
    """The whole caption path (tower, projector, splice, prefill, decode)
    against the reference's teacher-forced forward over the prompt and the
    tokens the program fed, its experts followed where a route flips."""
    tok, cap = _captioner()
    imgs = torch.randn(2, 28, 28, 3, generator=torch.Generator().manual_seed(1))
    seen = {"logits": [], "token": [], "route": {}}

    def tap(kind, index, t):
        if kind == "route":
            seen["route"].setdefault(index, []).append(t.clone())
        else:
            seen[kind].append(t.clone())

    captions = cap.caption(imgs, "describe", max_new_tokens=5, tap=tap)
    assert len(captions) == 2 and all(isinstance(c, str) for c in captions)
    ids = cap.prompt_ids("describe")
    cut = ids.index(tv.IMAGE_TOKEN_INDEX)
    pre, post = torch.tensor(ids[:cut]), torch.tensor(ids[cut + 1:])
    tokens = torch.stack(seen["token"], 1)
    chosen = [torch.cat(seen["route"][k], 1) for k in sorted(seen["route"])]
    hf = dict(cap.lm_cfg.to_hf(), vision=dict(
        image_size=28, patch_size=14, width=32, layers=3, heads=4,
        select_layer=-2))
    with torch.no_grad():
        ref, stats = caption_logits(_get(cap.model), imgs, pre, post,
                                    tokens[:, :-1], hf, Precision(), chosen)
    assert _gap(torch.stack(seen["logits"], 1), ref) < TOL
    assert stats["flips"] == 0


def test_make_llava_captioner_takes_either_lm(tmp_path):
    _, _, llama_fn = tcap.make_llava_captioner(
        None, llava_size="tiny", batch_size=2, max_new_tokens=3, device="cpu")
    cap, _, moon_fn = tcap.make_llava_captioner(
        None, llava_size="tiny", llava_lm="moonlight-16b-a3b", batch_size=2,
        max_new_tokens=3, device="cpu")
    assert isinstance(cap.model, tv.LlavaDeepseekV3ForCausalLM)
    imgs = [torch.rand(28, 28, 3).numpy() for _ in range(3)]
    assert len(moon_fn(imgs)) == len(llama_fn(imgs)) == 3
    with pytest.raises(ValueError, match="llava_lm"):
        tcap.make_llava_captioner(None, llava_size="tiny", llava_lm="gpt",
                                  device="cpu")
    assert tv.LlavaConfig.moonlight().llama == \
        dv.DeepseekV3Config.moonlight_16b_a3b()


def test_llama_captioner_keeps_its_model():
    cap = tv.LlavaCaptioner(tv.LlavaConfig.tiny(vocab_size=258),
                            ByteTokenizer(), device="cpu")
    assert type(cap.model) is tv.LlavaLlamaForCausalLM
    names = set(cap.model.state_dict())
    assert "model.layers.0.self_attn.k_proj.weight" in names
    assert "model.mm_projector.weight" in names


def test_moonlight_refuses_quantize_and_mesh():
    from spn4cir_tpu_torch.parallel.mesh import Mesh

    _, cap = _captioner()
    with pytest.raises(ValueError, match="int8 weights are not ported"):
        cap.quantize()
    mesh = Mesh.__new__(Mesh)
    with pytest.raises(ValueError, match="tensor parallelism"):
        tv.LlavaCaptioner(tv.LlavaConfig.tiny(258, lm="deepseek"),
                          ByteTokenizer(), device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="bfloat16"):
        dv.init_deepseek_state(cap.model, cap.lm_cfg, 1, 4, dtype=torch.int8)


def test_captioner_cli_runs_moonlight(tmp_path, monkeypatch):
    import json

    from spn4cir_tpu_torch.cli import captioner as cli_captioner
    from tests.fixtures import make_cirr

    root = make_cirr(str(tmp_path / "cirr"), n_images=5, extended=False)
    monkeypatch.chdir(tmp_path)
    out = cli_captioner.main([
        "--mllm", "llava", "--llava_size", "tiny", "--llava_lm",
        "moonlight-16b-a3b", "--cir_data", "cirr", "--data_path", root,
        "--max_new_tokens", "3", "--batch_size", "2", "--device", "cpu"])
    assert out.endswith(os.path.join("cirr", "cirr_it_llava_10.json"))
    with open(out) as f:
        assert len(json.load(f)) == 5
