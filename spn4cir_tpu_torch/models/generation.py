"""Autoregressive generation: the sampling filters and the MED decoder of the
BLIP captioner.

Counterpart of `spn4cir_tpu/models/generation.py`. The LLaMA rewriter and
the LLaVA captioner use `NEG_INF`, `top_k_filter` and `top_p_filter`, and
both decoder LMs (LLaMA, DeepSeek-V3) generate through `decode_loop` and
`sample_logits`; the
BLIP captioner decodes with the rest, HF `generate` semantics as LAVIS
drives it (`blip_caption.py:136-205`, `med.py:1324-1376`): greedy or nucleus
sampling (`generate`), beam search with `BeamSearchScorer` semantics
(`beam_generate`), the min-length and repetition-penalty processors.

The decoder keeps a per-layer float32 self-attention cache and computes the
cross-attention keys and values over the image tokens once (`DecodeState`,
`init_decode_state`); `decode_step` runs one position in float32 over the
float32 weights of a `models.med.BertLMHeadModel`, as the JAX package's pure
function does over its params tree. Its attention is plain tensor code (an
einsum over the cache), as in the JAX package: no kernel is involved. The
JAX loops are one `lax.scan` over max_length - 1 steps; here they are
Python loops over the same steps that stop once every row is finished (the
remaining steps would write only padding). The prompt is teacher-forced
inside the same loop.

Tie order: `jax.lax.top_k` returns the lower index first among equal
scores, `torch.topk` promises nothing, so the beam candidates come from
`eval.metrics.topk_lowest_index_first`; every `argsort` is stable, as
`jnp.argsort` is; `torch.argmax`, like `jnp.argmax`, takes the first
maximum.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from spn4cir_tpu_torch.eval.metrics import topk_lowest_index_first
from spn4cir_tpu_torch.models.med import LN_EPS
from spn4cir_tpu_torch.utils.logging import span

NEG_INF = -1e9


def top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """HF TopKLogitsWarper: keep only the top_k highest logits, NEG_INF the
    rest. The threshold is the k-th highest VALUE, so ties at the boundary
    all survive (HF's `logits < topk(...).values[..., -1:]`)."""
    if top_k <= 0 or top_k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering (HF TopPLogitsWarper, min_tokens_to_keep=1): keep
    the smallest set of tokens whose cumulative probability exceeds top_p.

    Positional, like HF: the logits are sorted ascending with ties in index
    order (a stable sort) and cut by sorted position, so the top token
    always stays; a value threshold would cut tied copies at the boundary."""
    idx = torch.argsort(logits, dim=-1, stable=True)
    sorted_logits = logits.gather(-1, idx)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove_sorted = cum <= (1.0 - top_p)
    remove_sorted[..., -1] = False
    remove = torch.zeros_like(remove_sorted).scatter(-1, idx, remove_sorted)
    return logits.masked_fill(remove, NEG_INF)


def sample_logits(logits: torch.Tensor, *, do_sample: bool,
                  temperature: float, top_k: int, top_p: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """One token a row: HF `generate`'s warper order (temperature -> top-k
    -> top-p), then one draw with `torch.multinomial` from `generator`; the
    argmax when not sampling."""
    if do_sample:
        filt = logits / max(temperature, 1e-6)
        if top_k:
            filt = top_k_filter(filt, top_k)
        if top_p < 1.0:
            filt = top_p_filter(filt, top_p)
        return torch.multinomial(torch.softmax(filt, dim=-1), 1,
                                 generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


@torch.no_grad()
def decode_loop(prefill, step, embed, *, max_new_tokens: int, eos_id: int,
                pad_id: int, sample, tap=None) -> torch.Tensor:
    """The decoder LMs' generation loop (`models.llama.llama_generate`,
    `models.deepseek_v3.deepseek_v3_generate`): `prefill()` gives the
    prompt's last logits (B, vocab), `step(x, i)` the logits of new token i
    from the embedding x (B, D) of token i - 1, `embed(tok)` that
    embedding, `sample(logits)` a token a row. max_new_tokens - 1 steps run
    whatever EOS does (no host sync); a row's tokens after its EOS are
    `pad_id`. Returns (B, max_new_tokens) int64.

    Spans: `llm.prefill` (the prefill and its sampling) and one `llm.decode`
    a step. `tap(kind, i, tensor)` receives ("logits", i, (B, vocab)) and
    ("token", i, (B,)), the token fed to step i + 1."""
    with span("llm.prefill"):
        logits = prefill()
        if tap is not None:
            tap("logits", 0, logits)
        tok = sample(logits)
        out = torch.full((tok.shape[0], max_new_tokens), pad_id,
                         dtype=torch.int64, device=tok.device)
        out[:, 0] = tok
        finished = tok == eos_id
    if tap is not None:
        tap("token", 0, tok)
    for i in range(1, max_new_tokens):
        with span("llm.decode"):
            logits = step(embed(tok), i)
            if tap is not None:
                tap("logits", i, logits)
            nxt = torch.where(finished, pad_id, sample(logits))
            out[:, i] = nxt
            finished = finished | (nxt == eos_id)
            tok = nxt
        if tap is not None:
            tap("token", i, tok)
    return out


# ---------------------------------------------------------------------------
# the cached MED decoder, over a BertLMHeadModel's weights
# ---------------------------------------------------------------------------

def _dense(x: torch.Tensor, layer) -> torch.Tensor:
    """`layer` (an nn.Linear) in float32, as `x @ kernel + bias` over the
    JAX package's float32 params."""
    bias = None if layer.bias is None else layer.bias.float()
    return F.linear(x, layer.weight.float(), bias)


def _ln_f32(x: torch.Tensor, ln) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), ln.weight.float(),
                        ln.bias.float(), LN_EPS)


@dataclasses.dataclass
class DecodeState:
    """KV cache for incremental decoding. self_k / self_v: (n_layers, B, L,
    H) float32; cross_k / cross_v: (n_layers, B, S, H) float32, computed once
    per image; cross_mask: (B, S) {0, 1} or None."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_mask: Optional[torch.Tensor]


@torch.no_grad()
def init_decode_state(model, cfg, enc_states: torch.Tensor, max_length: int,
                      enc_mask: Optional[torch.Tensor] = None) -> DecodeState:
    """A zero self-attention cache and the cross-attention K/V of every
    layer over the image tokens (done once; the decode loop never touches
    `enc_states` again). `model` is a `BertLMHeadModel`."""
    enc = enc_states.float()
    layers = model.bert.encoder.layer
    cross_k = torch.stack([_dense(enc, lp.crossattention.self.key)
                           for lp in layers])
    cross_v = torch.stack([_dense(enc, lp.crossattention.self.value)
                           for lp in layers])
    shape = (len(layers), enc.shape[0], max_length, cfg.hidden_size)
    return DecodeState(torch.zeros(shape, device=enc.device),
                       torch.zeros(shape, device=enc.device),
                       cross_k, cross_v, enc_mask)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            num_heads: int, mask_1d: torch.Tensor) -> torch.Tensor:
    """q: (B, H); k, v: (B, L, H); mask_1d: (B or 1, L) additive -> (B, H)."""
    batch, hid = q.shape
    hd = hid // num_heads
    qh = q.reshape(batch, num_heads, hd)
    kh = k.reshape(batch, -1, num_heads, hd)
    vh = v.reshape(batch, -1, num_heads, hd)
    logits = torch.einsum("bhd,bkhd->bhk", qh, kh) * (hd ** -0.5)
    w = torch.softmax(logits + mask_1d[:, None, :], dim=-1)
    return torch.einsum("bhk,bkhd->bhd", w, vh).reshape(batch, hid)


@torch.no_grad()
def decode_step(model, cfg, state: DecodeState, token: torch.Tensor,
                pos: int) -> Tuple[torch.Tensor, DecodeState]:
    """One incremental step: token (B,) at position `pos` -> (logits (B,
    vocab) float32, the state with self-attention row `pos` written in
    place)."""
    bert = model.bert
    emb = bert.embeddings
    x = (emb.word_embeddings.weight[token].float()
         + emb.position_embeddings.weight[pos].float())
    x = _ln_f32(x, emb.LayerNorm)

    max_len = state.self_k.shape[2]
    dev = x.device
    # valid self positions: 0..pos, the token just written included
    self_mask = torch.where(torch.arange(max_len, device=dev) <= pos, 0.0,
                            NEG_INF)[None, :]
    cross_mask = (torch.zeros(x.shape[0], state.cross_k.shape[2], device=dev)
                  if state.cross_mask is None
                  else (1.0 - state.cross_mask.float()) * NEG_INF)
    for li, lp in enumerate(bert.encoder.layer):
        sa, ca = lp.attention, lp.crossattention
        q = _dense(x, sa.self.query)
        state.self_k[li, :, pos] = _dense(x, sa.self.key)
        state.self_v[li, :, pos] = _dense(x, sa.self.value)
        ctx = _attend(q, state.self_k[li], state.self_v[li], cfg.num_heads,
                      self_mask)
        x = _ln_f32(x + _dense(ctx, sa.output.dense), sa.output.LayerNorm)
        q = _dense(x, ca.self.query)
        ctx = _attend(q, state.cross_k[li], state.cross_v[li], cfg.num_heads,
                      cross_mask)
        x = _ln_f32(x + _dense(ctx, ca.output.dense), ca.output.LayerNorm)
        inter = F.gelu(_dense(x, lp.intermediate.dense))
        x = _ln_f32(x + _dense(inter, lp.output.dense), lp.output.LayerNorm)

    head = model.cls.predictions
    h = F.gelu(_dense(x, head.transform.dense))
    h = _ln_f32(h, head.transform.LayerNorm)
    logits = F.linear(h, head.decoder.weight.float(), head.bias.float())
    return logits, state


# ---------------------------------------------------------------------------
# logits processors (HF semantics)
# ---------------------------------------------------------------------------

def apply_repetition_penalty(logits: torch.Tensor, tokens: torch.Tensor,
                             valid: torch.Tensor, penalty: float
                             ) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor: for every token already in the
    sequence, divide a positive logit by `penalty`, multiply a negative one.
    tokens: (B, L) buffer; valid: (B or 1, L) bool, the filled positions."""
    if penalty == 1.0:
        return logits
    valid = torch.broadcast_to(valid, tokens.shape)
    counts = torch.zeros_like(logits, dtype=torch.float32).scatter_add_(
        1, tokens.long(), valid.float())
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(counts > 0, penalized, logits)


def suppress_eos(logits: torch.Tensor, eos_id: int, cur_len: int,
                 min_length: int) -> torch.Tensor:
    """HF MinLengthLogitsProcessor: EOS is unreachable while the sequence
    (prompt included) is shorter than min_length."""
    if cur_len >= min_length:
        return logits
    out = logits.clone()
    out[:, eos_id] = NEG_INF
    return out


# ---------------------------------------------------------------------------
# generation loops
# ---------------------------------------------------------------------------

@torch.no_grad()
def generate(model, cfg, enc_states: torch.Tensor, prompt_ids: torch.Tensor,
             *, eos_id: int, pad_id: int, max_length: int = 30,
             min_length: int = 10, repetition_penalty: float = 1.0,
             do_sample: bool = False, top_p: float = 0.9,
             generator: Optional[torch.Generator] = None,
             enc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy or nucleus-sampled generation (HF `generate` with
    num_beams=1). prompt_ids: (B, P), BOS already swapped in. Returns (B,
    max_length) int64 ids, `pad_id` after EOS. Sampling draws with
    `torch.multinomial` from `generator` (a generator of the device; seed 0
    when none is given)."""
    batch, prompt_len = prompt_ids.shape
    assert prompt_len < max_length
    dev = enc_states.device
    state = init_decode_state(model, cfg, enc_states, max_length, enc_mask)
    tokens = torch.full((batch, max_length), pad_id, dtype=torch.long,
                        device=dev)
    tokens[:, :prompt_len] = prompt_ids.to(dev)
    if do_sample and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    finished = torch.zeros(batch, dtype=torch.bool, device=dev)
    positions = torch.arange(max_length, device=dev)
    for t in range(max_length - 1):
        logits, state = decode_step(model, cfg, state, tokens[:, t], t)
        if t + 1 < prompt_len:  # teacher-forced prompt position
            continue
        logits = apply_repetition_penalty(logits, tokens,
                                          (positions <= t)[None],
                                          repetition_penalty)
        logits = suppress_eos(logits, eos_id, t + 1, min_length)
        if do_sample:
            nxt = torch.multinomial(
                torch.softmax(top_p_filter(logits, top_p), dim=-1), 1,
                generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(finished, pad_id, nxt)
        tokens[:, t + 1] = nxt
        finished = finished | (nxt == eos_id)
        if bool(finished.all()):
            break
    return tokens


@torch.no_grad()
def beam_generate(model, cfg, enc_states: torch.Tensor,
                  prompt_ids: torch.Tensor, *, eos_id: int, pad_id: int,
                  num_beams: int = 3, max_length: int = 30,
                  min_length: int = 10, repetition_penalty: float = 1.0,
                  length_penalty: float = 1.0,
                  enc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Beam search with HF BeamSearchScorer semantics (the captioner's
    default: num_beams=3):

      * each step log-softmaxes the logits, THEN runs the processors (HF's
        beam search; greedy and sampling process the raw logits), and
        expands to the top 2*num_beams candidates; EOS candidates ranked <
        num_beams are banked into a per-row pool of the num_beams best
        finished hypotheses, normalized by the GENERATED length (the prompt
        excluded, the EOS included); non-EOS candidates fill the beams;
      * a row is done once its pool is full and its worst pooled score is
        at least the best candidate normalized at the current length
        (is_done with early_stopping=False);
      * at max length, the live beams of the rows not done join the pool,
        normalized by max_length - prompt_len (finalize).

    Returns the best sequence per row, (B, max_length) int64, `pad_id`
    after EOS."""
    batch, prompt_len = prompt_ids.shape
    assert prompt_len < max_length
    nb = num_beams
    dev = enc_states.device
    # image tokens repeat_interleave over beams (ref med.py:1341)
    enc_rep = enc_states.repeat_interleave(nb, dim=0)
    mask_rep = None if enc_mask is None else enc_mask.repeat_interleave(nb, 0)
    state = init_decode_state(model, cfg, enc_rep, max_length, mask_rep)
    tokens = torch.full((batch * nb, max_length), pad_id, dtype=torch.long,
                        device=dev)
    tokens[:, :prompt_len] = prompt_ids.to(dev).repeat_interleave(nb, dim=0)
    # beam 0 live, the others at NEG_INF so that the first expansion
    # diversifies
    beam_scores = torch.tensor([0.0] + [NEG_INF] * (nb - 1),
                               device=dev).repeat(batch)
    pool_tokens = torch.zeros(batch, nb, max_length, dtype=torch.long,
                              device=dev)
    pool_scores = torch.full((batch, nb), float("-inf"), device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    positions = torch.arange(max_length, device=dev)
    ident = torch.arange(nb, device=dev).expand(batch, nb)
    row_base = (torch.arange(batch, device=dev) * nb)[:, None]
    for t in range(max_length - 1):
        logits, state = decode_step(model, cfg, state, tokens[:, t], t)
        if t + 1 < prompt_len:
            # every row is frozen inside the prompt: identity lineage, the
            # prompt token forced, scores and pool unchanged
            tokens[:, t + 1] = prompt_ids[:, t + 1].to(dev).repeat_interleave(
                nb, dim=0)
            continue
        logp = torch.log_softmax(logits.float(), dim=-1)
        logp = apply_repetition_penalty(logp, tokens, (positions <= t)[None],
                                        repetition_penalty)
        logp = suppress_eos(logp, eos_id, t + 1, min_length)
        vocab = logp.shape[-1]

        cand = (beam_scores[:, None] + logp).reshape(batch, nb * vocab)
        top_scores, top_idx = topk_lowest_index_first(cand, 2 * nb)
        src_beam = top_idx // vocab
        tok = top_idx % vocab
        is_eos = tok == eos_id

        # bank EOS candidates ranked < num_beams into the pool
        norm = float(t + 2 - prompt_len) ** length_penalty
        bankable = is_eos[:, :nb] & ~done[:, None]
        cand_scores = torch.where(bankable, top_scores[:, :nb] / norm,
                                  float("-inf"))
        cand_rows = tokens.view(batch, nb, max_length).gather(
            1, src_beam[:, :nb, None].expand(-1, -1, max_length)).clone()
        cand_rows[:, :, t + 1] = eos_id
        merged_scores = torch.cat([pool_scores, cand_scores], dim=1)
        merged_tokens = torch.cat([pool_tokens, cand_rows], dim=1)
        keep = torch.argsort(-merged_scores, dim=1, stable=True)[:, :nb]
        pool_scores = merged_scores.gather(1, keep)
        pool_tokens = merged_tokens.gather(
            1, keep[..., None].expand(-1, -1, max_length))

        # continuation: the top num_beams non-EOS candidates
        cont_scores = torch.where(is_eos, NEG_INF, top_scores)
        order = torch.argsort(-cont_scores, dim=-1, stable=True)[:, :nb]
        new_scores = cont_scores.gather(1, order)
        new_beam = src_beam.gather(1, order)
        new_tok = tok.gather(1, order)
        # done rows keep identity lineage, pad tokens and their scores
        frozen = done[:, None]
        new_beam = torch.where(frozen, ident, new_beam)
        new_tok = torch.where(frozen, pad_id, new_tok)
        new_scores = torch.where(frozen, beam_scores.view(batch, nb),
                                 new_scores)

        # is_done: HF passes the best candidate, EOS included, normalized
        # by the same generated length
        best_possible = top_scores[:, 0] / norm
        worst = pool_scores[:, nb - 1]
        done = done | (torch.isfinite(worst) & (worst >= best_possible))

        # reorder the token buffers and the self-attention caches
        flat_idx = (new_beam + row_base).reshape(-1)
        tokens = tokens[flat_idx]
        state.self_k = state.self_k[:, flat_idx]
        state.self_v = state.self_v[:, flat_idx]
        tokens[:, t + 1] = new_tok.reshape(-1)
        beam_scores = new_scores.reshape(-1)
        if bool(done.all()):
            break

    # finalize: the live beams of rows not done join the pool
    live = torch.where(done[:, None], float("-inf"),
                       beam_scores.view(batch, nb)
                       / float(max_length - prompt_len) ** length_penalty)
    merged_scores = torch.cat([pool_scores, live], dim=1)
    merged_tokens = torch.cat(
        [pool_tokens, tokens.view(batch, nb, max_length)], dim=1)
    best = torch.argmax(merged_scores, dim=1)
    out = merged_tokens[torch.arange(batch, device=dev), best]
    # blank everything after the first EOS past the prompt
    eos_hits = (out == eos_id) & (positions >= prompt_len)[None]
    eos_pos = torch.argmax(eos_hits.int(), dim=-1)
    cut = torch.where(eos_hits.any(dim=-1), eos_pos, max_length - 1)
    return torch.where(positions[None] <= cut[:, None], out, pad_id)
