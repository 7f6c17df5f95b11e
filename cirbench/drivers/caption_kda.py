"""The `caption_kda` driver: the LLaVA captioner with Kimi-Linear-48B-A3B as
its language model (`models/llava.py:LlavaCaptioner` over
`models/deepseek_v3.py`: KDA layers through kernel #15, unrotated MLA, and
the expert share the configuration holds), what `datagen/captioner.py:
make_llava_captioner(llava_lm="kimi-linear-48b-a3b")` builds, captioning
seeded pixel batches already on the device, batch after batch for the whole
window.

It runs as the `caption` driver does, and takes from it `build_program`,
the tap, the pixels, the prompt and the comparison; what differs:
  - weights: KDA's `A_log` and `dt_bias` are drawn, in float32, as the
    published initialisation draws them (A ~ U(1, 16); dt log-uniform in
    [1e-3, 0.1] through the inverse softplus), so that each state keeps a
    memory of tens to hundreds of tokens; every other parameter as
    `caption.make_leaf` draws it;
  - the reference is `cirbench/reference/kimi_linear.py` (KDA as the token
    recurrence, MLA unrotated, the MoE over the experts held);
  - the counters: #15's launches by entry (`kda_prefill`, `kda_decode`)
    beside #14's and #3's, graph replays included;
  - two more compared numbers, from the set-up batch, for the checked rows
    of the program's first KDA layer:
    `recurrence_gap`: the driver keeps what the layer handed #15's prefill
    (q, k, v, the log decay, β) and what it gave back (o and the final
    state), and likewise for the first decode step (which runs eagerly,
    before the decode graph is captured), with the state before it; the
    reference's float32 token recurrence (`kimi_linear.recurrence`) runs
    the same inputs from the same state. The number is the worst relative
    L2 error of o (a row and token, over the heads) and of the state after
    each entry (a row). It holds both entries of the recurrence to float32,
    which the logits cannot: the program's bf16 projections move them more
    than a bf16 state would;
    `kda_inputs_gap`: the prefill's q, k, v, log decay and β against the
    reference's own (`kimi_linear.kda_inputs` of its first KDA layer, in
    the check's forward over the same images and prompt), the worst
    relative L2 error of a row and token over the heads. It holds the
    projections, the short convolution and the gates of the prefill to
    the configuration's precision; the gated norm and the decode step's
    convolution over its tail are held by the logits alone;
  - the controls (`calibrate`): the plain reference in float8 in the
    program's place (`control`), the program with each KDA state rounded
    to bfloat16 after every token in #15's place (`control_state_bf16`:
    the fault 'state_bf16'), and the same in the decode entry alone
    (`control_state_bf16_decode`: the fault 'state_bf16_decode').
"""

from __future__ import annotations

import gc
import time
import zlib
from typing import Any, Dict, List, Tuple

from cirbench import gen
from cirbench.drivers import caption
from cirbench.drivers.caption import (Capture, build_program, compare,
                                      make_pixels, reference_inputs)
from cirbench.harness import Cell, sub_seed
from cirbench.wordtok import WordTokenizer

#: KDA's decay parameters, float32 whatever the LM's type
DECAY = ("A_log", "dt_bias")


def leaf_dtype(name: str, cfg: Dict[str, Any]):
    import torch

    if name.endswith(DECAY):
        return torch.float32
    return caption.leaf_dtype(name, cfg)


def make_leaf(name: str, shape, dtype, seed: int, device):
    """The parameter `name` of the run drawn by `seed`, the same numbers
    whenever it is drawn again: KDA's decay as published, the rest as the
    `caption` driver draws it."""
    import math

    import torch

    if not name.endswith(DECAY):
        return caption.make_leaf(name, shape, dtype, seed, device)
    g = torch.Generator(device=device).manual_seed(
        sub_seed(seed, gen.WEIGHTS, zlib.crc32(name.encode())))
    u = torch.rand(tuple(shape), generator=g, device=device)
    if name.endswith("A_log"):
        return (1.0 + 15.0 * u).log_().to(dtype)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(u * (hi - lo) + lo).clamp_(min=1e-4)
    return (dt + torch.log(-torch.expm1(-dt))).to(dtype)


def _patch(dv, **fns):
    """Put `fns` in place of the model module's #15 entries; returns the
    undo."""
    real = {name: getattr(dv, name) for name in fns}
    for name, fn in fns.items():
        setattr(dv, name, fn)
    return lambda: [setattr(dv, n, f) for n, f in real.items()]


def _plant(dv, faults):
    """The faults (the CPU tests' and the bf16-state controls'): 'state'
    zeroes every KDA state before each decode step (a lost prefill state);
    'state_bf16' runs the reference's recurrence with S rounded to bfloat16
    after every token in #15's place, and 'state_bf16_decode' in its decode
    entry alone; 'conv' runs the short convolution with its taps in
    reverse order."""
    from cirbench.reference.kimi_linear import recurrence

    def rounded(q, k, v, g, beta, state, fresh=False):
        o, s = recurrence(q, k, v, g, beta, None if fresh else state, "bf16")
        state.copy_(s)
        return o

    if "state" in faults:
        real = dv.kda_decode

        def decode(q, k, v, g, beta, state):
            state.zero_()
            return real(q, k, v, g, beta, state)
        return _patch(dv, kda_decode=decode)
    if "state_bf16" in faults:
        return _patch(dv, kda_decode=rounded,
                      kda_prefill=lambda *a: rounded(*a, fresh=True))
    if "state_bf16_decode" in faults:
        return _patch(dv, kda_decode=rounded)
    if "conv" in faults:
        real = dv._short_conv
        return _patch(dv, _short_conv=lambda window, weight: real(
            window, weight.flip(-1)))
    return lambda: None


class RecurrenceTap:
    """Around the set-up batch: keeps, for the first `rows` rows, the first
    call of #15's prefill (the first KDA layer) and of its decode (the same
    layer at the first decode step, run eagerly), their inputs and outputs,
    and the state the decode started from, as copies on the device."""

    def __init__(self, dv, rows: int):
        self.dv, self.rows = dv, rows
        self.kept: Dict[str, Dict[str, Any]] = {}

    def _wrap(self, entry: str, real):
        r = self.rows

        def call(q, k, v, g, beta, state):
            if entry in self.kept:
                return real(q, k, v, g, beta, state)
            before = state[:r].clone()
            o = real(q, k, v, g, beta, state)
            self.kept[entry] = {
                "inputs": [x[:r].clone() for x in (q, k, v, g, beta)],
                "before": None if entry == "prefill" else before,
                "o": o[:r].clone(), "state": state[:r].clone()}
            return o
        return call

    def __enter__(self):
        self.undo = _patch(
            self.dv, kda_prefill=self._wrap("prefill", self.dv.kda_prefill),
            kda_decode=self._wrap("decode", self.dv.kda_decode))
        return self

    def __exit__(self, *exc):
        self.undo()


def _gap(got, want) -> float:
    """The worst relative L2 error of got against want, each vector over
    every dimension after the first two."""
    got, want = got.flatten(2).float(), want.flatten(2).float()
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(1e-12)).max())


def recurrence_gap(kept) -> float:
    """The worst relative L2 error of the program's o (a row and token,
    over the heads) and state after the call (a row), in its prefill and
    its first decode step, against the float32 reference recurrence of the
    same inputs from the same state."""
    import torch

    from cirbench.reference.common import strict_float32
    from cirbench.reference.kimi_linear import recurrence

    gaps = []
    for entry in ("prefill", "decode"):
        got = kept[entry]
        with torch.no_grad(), strict_float32():
            o, s = recurrence(*got["inputs"], got["before"])
        gaps += [_gap(got["o"], o), _gap(got["state"][:, None], s[:, None])]
    return max(gaps)


def inputs_gap(got, want) -> float:
    """The worst relative L2 error of the program's q, k, v, log decay and
    β (a row and token, over the heads) against the reference's over the
    same rows and positions (the first of each)."""
    return max(_gap(a, b[:a.shape[0], :a.shape[1]].to(a.device))
               for a, b in zip(got, want))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, scratch: str, faults=()) -> Dict[str, Any]:
    """One run. `faults` (the CPU tests' and the controls'): 'shared' and
    'answer' as in the `caption` driver; 'state', 'state_bf16',
    'state_bf16_decode' and 'conv' on KDA (`_plant`)."""
    import torch

    from spn4cir_tpu_torch.datagen.captioner import caption_prompt
    from spn4cir_tpu_torch.models import deepseek_v3 as dv
    from spn4cir_tpu_torch.ops.attention_kernels import long_attention
    from spn4cir_tpu_torch.ops.kda import kda_decode, kda_prefill
    from spn4cir_tpu_torch.ops.moe_grouped import moe_grouped, moe_stats

    from cirbench.trace import profile_window

    cfg, t = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cap = build_program(cfg, WordTokenizer(cfg["vocab_size"]), device)
    wseed = sub_seed(seed, gen.WEIGHTS)
    specs = {}
    with torch.no_grad():
        for name, p in cap.model.named_parameters():
            dtype = leaf_dtype(name, cfg)
            if p.dtype != dtype:
                raise SystemExit(f"the program holds {name} in {p.dtype}, "
                                 f"the configuration says {dtype}")
            p.copy_(make_leaf(name, p.shape, dtype, wseed, device))
            specs[name] = (tuple(p.shape), dtype)
            if "shared" in faults and name.endswith(
                    "shared_experts.down_proj.weight"):
                p.zero_()
    pixels = make_pixels(cell, seed, device)
    prompt = caption_prompt(t["category"], t["num_words"])
    cache = getattr(torch, t["cache_dtype"])
    sampler = torch.Generator(device=device).manual_seed(
        sub_seed(seed, gen.SAMPLE))
    taps = [Capture(t["check_rows"]) for _ in range(t["pixel_batches"])]
    if "answer" in faults:
        taps = [caption._planted(tap) for tap in taps]
    restore = _plant(dv, faults)

    def step(k, tap):
        if tap is not None:
            tap.reset()
        return cap.caption(pixels[k], prompt,
                           max_new_tokens=t["max_new_tokens"],
                           generator=sampler, cache_dtype=cache, tap=tap)

    wrappers = {"kda_prefill": kda_prefill, "kda_decode": kda_decode,
                "moe_grouped": moe_grouped, "long_attention": long_attention}

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    try:
        n_pix = t["pixel_batches"]
        with RecurrenceTap(dv, t["check_rows"]) as kept:
            step(0, None)           # every pixel batch has the same shapes
        sync()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start

        before = counts()
        sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        batches = 0
        while batches < n_pix or time.perf_counter() < deadline:
            step(batches % n_pix, taps[batches % n_pix])
            batches += 1
        sync()
        window_s = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in counts().items()}
        images = batches * t["batch"]
        prompt_len = (len(cap.prompt_ids(prompt)) - 1
                      + cap.cfg.vision.num_patches)
        out: Dict[str, Any] = {
            "notes": [f"caption_kda: {batches} batches of {t['batch']} in "
                      f"{window_s:.3f} s; a batch: prompt {prompt_len} "
                      f"tokens, 1 prefill + {t['max_new_tokens'] - 1} decode "
                      f"steps ({t['max_new_tokens']} tokens a row, EOS does "
                      f"not stop the loop); launches in the window "
                      f"{launched}"],
            "setup_s": setup_s, "attempted": images, "failed": 0,
            "end_to_end": {"extract_images_per_s": images / window_s},
            "batch_s": window_s / max(batches, 1),
        }
        if trace:
            def profiled():
                for i in range(t["profile_batches"]):
                    step(i % n_pix, None)

            profile_window(profiled, scratch)
            if cuda:
                moe_stats(reset=True)
            before = counts()
            out["trace"] = profile_window(profiled, scratch)
            out["counters"] = {k: v - before[k] for k, v in counts().items()}
            out["counters"]["moe_stats"] = moe_stats() if cuda else {}
    finally:
        restore()
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if cuda else 0)
    out["shapes"] = {"family": cfg["family"], "batch": t["batch"],
                     "prompt_len": prompt_len,
                     "new_tokens": t["max_new_tokens"], "config": cfg}
    prog = [tap.host() for tap in taps]
    del cap, taps, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    values, detail = check(cfg, t, specs, wseed, pixels, prog, device,
                           kept.kept["prefill"]["inputs"])
    values["recurrence_gap"] = recurrence_gap(kept.kept)
    out["values"] = values
    out["detail"] = detail
    return out


def _reference(get, pixels, cfg, t, device, tokens, precision, chosen=None,
               record=None, inputs=None):
    """The reference's teacher-forced logits and routing readings."""
    import torch

    from cirbench.reference.common import Precision, strict_float32
    from cirbench.reference.kimi_linear import caption_logits

    pre, post = reference_inputs(cfg, t, device)
    with torch.no_grad(), strict_float32():
        return caption_logits(get, pixels, pre, post, tokens, cfg,
                              Precision(precision), chosen, record, inputs)


def check(cfg, t, specs, wseed, pixels, prog, device, kda_inputs
          ) -> Tuple[Dict[str, float], Dict]:
    """The reference's logits over each checked row's prompt and fed tokens
    against the program's, every pixel batch's rows in one forward, and
    `kda_inputs` (q, k, v, g, β of the first KDA layer's prefill, for the
    first pixel batch's checked rows) against the reference's
    (`kda_inputs_gap`)."""
    import torch

    rows = t["check_rows"]

    def get(name):
        shape, dtype = specs[name]
        return make_leaf(name, shape, dtype, wseed, device)

    px = torch.cat([pixels[k, :rows] for k in range(len(prog))])
    tokens = torch.cat([p["tokens"] for p in prog]).to(device)
    chosen = [torch.cat([p["routes"][li] for p in prog]).to(device)
              for li in range(len(prog[0]["routes"]))]
    own: List = []
    ref, stats = _reference(get, px, cfg, t, device, tokens[:, :-1],
                            "float32", chosen, inputs=own)
    prog_logits = torch.cat([p["logits"] for p in prog])
    values = compare(prog_logits, ref.cpu(), stats)
    values["kda_inputs_gap"] = inputs_gap(kda_inputs, own[0])
    pre, post = reference_inputs(cfg, t, device)
    detail = {"prompt_ids": [int(pre.numel()), int(post.numel())],
              "routes": stats["routes"], "flips": stats["flips"]}
    return values, detail


def calibrate(cell: Cell, seed: int, device, what) -> Dict[str, Dict]:
    """The controls against the float32 reference: `control`, the plain
    reference in float8 in the program's place, with its own logits,
    routes and first KDA layer's inputs over a seeded continuation;
    `control_state_bf16`, a run of the program (1-s window) with each KDA
    state rounded to bfloat16 after every token in #15's place (the fault
    'state_bf16'); `control_state_bf16_decode`, the same in #15's decode
    entry alone (the fault 'state_bf16_decode')."""
    import tempfile

    import torch

    cfg, t = cell.config, cell.traffic
    out: Dict[str, Dict] = {}
    for fault in ("state_bf16", "state_bf16_decode"):
        if "control" in what or f"control_{fault}" in what:
            with tempfile.TemporaryDirectory() as scratch:
                out[f"control_{fault}"] = run(
                    cell, seed, 1.0, False, device, time.perf_counter(),
                    scratch, (fault,))["values"]
    if "control" not in what:
        return out
    meta = build_program(cfg, WordTokenizer(cfg["vocab_size"]), "meta")
    specs = {n: (tuple(p.shape), leaf_dtype(n, cfg))
             for n, p in meta.model.named_parameters()}
    del meta
    wseed = sub_seed(seed, gen.WEIGHTS)
    rows = t["check_rows"]
    pixels = make_pixels(cell, seed, device)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, gen.SAMPLE))
    tokens = torch.randint(3, cfg["vocab_size"], (len(pixels) * rows,
                                                  t["max_new_tokens"]),
                           generator=g, device=device)

    def get(name):
        shape, dtype = specs[name]
        return make_leaf(name, shape, dtype, wseed, device)

    px = torch.cat([pixels[k, :rows] for k in range(len(pixels))])
    own: List = []
    inputs: List = []
    ctl, _ = _reference(get, px, cfg, t, device, tokens[:, :-1], "fp8",
                        record=own, inputs=inputs)
    prog = [{"logits": ctl[k * rows:(k + 1) * rows].cpu(),
             "tokens": tokens[k * rows:(k + 1) * rows].cpu(),
             "routes": [r[k * rows:(k + 1) * rows].cpu() for r in own]}
            for k in range(len(pixels))]
    # the prompt's positions, as the program's prefill holds them
    prompt = inputs[0][0].shape[1] - tokens.shape[1] + 1
    out["control"] = check(cfg, t, specs, wseed, pixels, prog, device,
                           [x[:rows, :prompt] for x in inputs[0]])[0]
    return out
