"""The `caption` driver: the LLaVA captioner with a DeepSeek-V3 language
model (`models/llava.py:LlavaCaptioner` over `models/deepseek_v3.py`), what
`datagen/captioner.py:make_llava_captioner` builds, captioning seeded pixel
batches already on the device, batch after batch for the whole window.

Each `caption` call runs the tower and the projector, the prefill of the
llava_v1 prompt around the image tokens, and `max_new_tokens - 1` decode
steps over the latent cache (a fixed count: EOS ends a row's caption, not
the loop), then decodes the captions to text; an image counts once its
caption is finished. Set-up warms one batch (both pixel batches have its
shapes); the window runs at least one batch of each pixel batch. The timed
path itself keeps, for the first
`check_rows` rows of each pixel batch, its logits at every position, the
tokens it fed and each MoE layer's experts, as slice copies on the device
(the captioner's `tap`). Once the window has closed and the program is
freed, the plain reference (`cirbench/reference/moonlight.py`) runs the
same pixels and prompt and those tokens teacher-forced, with the same
weights drawn again from the seed, and the compared numbers are the worst
position's relative L2 error of the logits and the routing flips.

Weights: one seeded normal draw a parameter, named by the parameter (so the
reference can draw any one again), scaled as `leaf_scale` says, stored in
the configuration's types: the LM in `dtype`, the tower, the projector and
the selection bias in float32.
"""

from __future__ import annotations

import gc
import time
import zlib
from typing import Any, Dict, List, Tuple

from cirbench import gen
from cirbench.harness import Cell, sub_seed
from cirbench.wordtok import WordTokenizer

VISION_PREFIXES = ("model.vision_tower.", "model.mm_projector.")
#: e_score_correction_bias: random (published: learned), at a scale that
#: reorders the sigmoid scores' top choices often, as a trained bias does
BIAS_SCALE = 0.1


def leaf_scale(name: str, shape) -> Tuple[float, float]:
    """(multiplier, offset) of a parameter's standard normal draw: 0.02 for
    the token, class and position tables; BIAS_SCALE for the selection
    bias; 1 + 0.1 N for 1-d weights (the norms' scales), 0.02 N for other
    1-d leaves (biases); fan-in normal for the matrices and the patch
    convolution."""
    if name.endswith(("embed_tokens.weight", "class_embedding",
                      "position_embedding.weight")):
        return 0.02, 0.0
    if name.endswith("e_score_correction_bias"):
        return BIAS_SCALE, 0.0
    if len(shape) == 1:
        return (0.1, 1.0) if name.endswith("weight") else (0.02, 0.0)
    fan_in = 1
    for s in shape[1:]:
        fan_in *= s
    return fan_in ** -0.5, 0.0


def leaf_dtype(name: str, cfg: Dict[str, Any]):
    """The configuration's type of a parameter: `vision_dtype` for the
    tower, the projector and the selection bias, `dtype` for the LM."""
    import torch

    if name.startswith(VISION_PREFIXES) or name.endswith(
            "e_score_correction_bias"):
        return getattr(torch, cfg["vision_dtype"])
    return getattr(torch, cfg["dtype"])


def make_leaf(name: str, shape, dtype, seed: int, device):
    """The parameter `name` of the run drawn by `seed`: the same numbers
    whenever it is drawn again."""
    import torch

    g = torch.Generator(device=device).manual_seed(
        sub_seed(seed, gen.WEIGHTS, zlib.crc32(name.encode())))
    mul, add = leaf_scale(name, shape)
    return (torch.randn(tuple(shape), generator=g, device=device)
            .mul_(mul).add_(add).to(dtype))


def build_program(cfg: Dict[str, Any], tok, device):
    """The port's captioner for `cfg`, parameters allocated and empty; the
    program's record of its LM's configuration is checked against the
    file for every key the model reads."""
    import torch

    from spn4cir_tpu_torch.models.deepseek_v3 import DeepseekV3Config
    from spn4cir_tpu_torch.models.llava import (LlavaCaptioner, LlavaConfig,
                                                LlavaVisionConfig)

    lm = DeepseekV3Config.from_hf(cfg)
    bad = {k: (v, cfg.get(k)) for k, v in lm.to_hf().items()
           if cfg.get(k) != v}
    if bad:
        raise SystemExit(f"the program runs (program, file): {bad}")
    v = cfg["vision"]
    vision = LlavaVisionConfig(image_size=v["image_size"],
                               patch_size=v["patch_size"], width=v["width"],
                               num_layers=v["layers"], num_heads=v["heads"],
                               select_layer=v["select_layer"])
    return LlavaCaptioner(LlavaConfig(llama=lm, vision=vision), tok,
                          dtype=getattr(torch, cfg["dtype"]), device=device)


class Capture:
    """The captioner's tap for one pixel batch: the first `rows` rows'
    logits (float32), fed tokens and per-MoE-layer experts of the last
    caption call, as slice copies on the device."""

    def __init__(self, rows: int):
        self.rows = rows
        self.reset()

    def reset(self) -> None:
        self.prefill: List = []
        self.decode: List[List] = []
        self.logits: List = []
        self.tokens: List = []

    def __call__(self, kind: str, index: int, t) -> None:
        if kind == "route":
            if not self.logits:
                self.prefill.append(t[:self.rows].clone())
            else:
                self.decode[-1].append(t[:self.rows, 0].clone())
        elif kind == "logits":
            self.logits.append(t[:self.rows].clone())
            self.decode.append([])
        elif kind == "token":
            self.tokens.append(t[:self.rows].clone())

    def host(self) -> Dict[str, Any]:
        """logits (rows, T, V), tokens (rows, T) and the routes (per MoE
        layer (rows, prompt + T - 1, k)), on the host."""
        import torch

        steps = [d for d in self.decode if d]
        routes = [torch.cat([pre] + [s[li][:, None] for s in steps], dim=1)
                  for li, pre in enumerate(self.prefill)]
        return {"logits": torch.stack(self.logits, 1).float().cpu(),
                "tokens": torch.stack(self.tokens, 1).cpu(),
                "routes": [r.cpu() for r in routes]}


def make_pixels(cell: Cell, seed: int, device):
    import torch

    t, side = cell.traffic, cell.config["vision"]["image_size"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, gen.PIXELS))
    return torch.randn((t["pixel_batches"], t["batch"], side, side, 3),
                       generator=g, device=device)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, scratch: str, faults=()) -> Dict[str, Any]:
    """One run. `faults` (the CPU tests'): 'shared' drops every shared
    expert (its down projection zeroed); 'answer' alters one row's logits
    where they are produced, before they are sampled."""
    import torch

    from spn4cir_tpu_torch.datagen.captioner import caption_prompt
    from spn4cir_tpu_torch.ops.attention_kernels import long_attention
    from spn4cir_tpu_torch.ops.moe_grouped import moe_grouped, moe_stats

    from cirbench.trace import profile_window

    cfg, t = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tok = WordTokenizer(cfg["vocab_size"])
    cap = build_program(cfg, tok, device)
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
        taps = [_planted(tap) for tap in taps]

    def step(k, tap):
        if tap is not None:
            tap.reset()
        return cap.caption(pixels[k], prompt,
                           max_new_tokens=t["max_new_tokens"],
                           generator=sampler, cache_dtype=cache, tap=tap)

    n_pix = t["pixel_batches"]
    step(0, None)               # every pixel batch has the same shapes
    sync()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    launches0 = moe_grouped.launches
    sync()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    batches = 0
    while batches < n_pix or time.perf_counter() < deadline:
        step(batches % n_pix, taps[batches % n_pix])
        batches += 1
    sync()
    window_s = time.perf_counter() - t0
    images = batches * t["batch"]
    prompt_len = len(cap.prompt_ids(prompt)) - 1 + cap.cfg.vision.num_patches
    out: Dict[str, Any] = {
        "notes": [f"caption: {batches} batches of {t['batch']} in "
                  f"{window_s:.3f} s; a batch: prompt {prompt_len} tokens, "
                  f"1 prefill + {t['max_new_tokens'] - 1} decode steps "
                  f"({t['max_new_tokens']} tokens a row, EOS does not stop "
                  f"the loop); moe_grouped launches "
                  f"{moe_grouped.launches - launches0}"],
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
        before = moe_grouped.launches, long_attention.launches
        out["trace"] = profile_window(profiled, scratch)
        out["counters"] = {"moe_grouped": moe_grouped.launches - before[0],
                           "long_attention": (long_attention.launches
                                              - before[1]),
                           "moe_stats": moe_stats() if cuda else {}}
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
    values, detail = check(cfg, t, specs, wseed, pixels, prog, device)
    out["values"] = values
    out["detail"] = detail
    return out


def _planted(tap):
    def planted(kind, index, x):
        if kind == "logits":
            x[0] = x[1]
        tap(kind, index, x)
    planted.reset = tap.reset
    planted.host = tap.host
    return planted


def reference_inputs(cfg: Dict[str, Any], t: Dict[str, Any], device):
    """The prompt's ids before and after the image, from the reference's
    own template and the benchmark's tokenizer."""
    import torch

    from cirbench.reference.moonlight import prompt_halves

    tok = WordTokenizer(cfg["vocab_size"])
    pre, post = prompt_halves(t["category"], t["num_words"])
    return (torch.tensor(tok.encode(pre), device=device),
            torch.tensor(tok.encode(post)[1:], device=device))


def compare(prog_logits, ref_logits, stats) -> Dict[str, float]:
    """logits_gap: the worst (row, position) relative L2 error of the
    logits; route_gap: at the worst flipped route, the reference's own
    k-th biased score less its lowest biased score among the program's
    experts (0 without flips); route_flip_share: flipped routes over
    all."""
    err = ((prog_logits - ref_logits).norm(dim=-1)
           / ref_logits.norm(dim=-1).clamp_min(1e-12))
    return {"logits_gap": float(err.max()),
            "route_gap": float(stats["flip_gap"]),
            "route_flip_share": stats["flips"] / max(stats["routes"], 1)}


def check(cfg, t, specs, wseed, pixels, prog, device,
          precision: str = "float32") -> Tuple[Dict[str, float], Dict]:
    """The reference's logits over each checked row's prompt and fed tokens
    against the program's, every pixel batch's rows in one forward."""
    import torch

    from cirbench.reference.common import Precision, strict_float32
    from cirbench.reference.moonlight import caption_logits

    rows = t["check_rows"]

    def get(name):
        shape, dtype = specs[name]
        return make_leaf(name, shape, dtype, wseed, device)

    pre, post = reference_inputs(cfg, t, device)
    px = torch.cat([pixels[k, :rows] for k in range(len(prog))])
    tokens = torch.cat([p["tokens"] for p in prog]).to(device)
    chosen = [torch.cat([p["routes"][li] for p in prog]).to(device)
              for li in range(len(prog[0]["routes"]))]
    with torch.no_grad(), strict_float32():
        ref, stats = caption_logits(get, px, pre, post, tokens[:, :-1], cfg,
                                    Precision(precision), chosen)
    prog_logits = torch.cat([p["logits"] for p in prog])
    values = compare(prog_logits, ref.cpu(), stats)
    detail = {"prompt_ids": [int(pre.numel()), int(post.numel())],
              "routes": stats["routes"], "flips": stats["flips"]}
    return values, detail


def calibrate(cell: Cell, seed: int, device, what) -> Dict[str, Dict]:
    """The control: the plain reference in float8 put in the program's
    place (its logits and its own routes over a seeded continuation),
    against the float32 reference."""
    import torch

    from cirbench.reference.common import Precision, strict_float32
    from cirbench.reference.moonlight import caption_logits

    cfg, t = cell.config, cell.traffic
    out = {}
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
    pre, post = reference_inputs(cfg, t, device)

    def get(name):
        shape, dtype = specs[name]
        return make_leaf(name, shape, dtype, wseed, device)

    px = torch.cat([pixels[k, :rows] for k in range(len(pixels))])
    own: List = []
    with torch.no_grad(), strict_float32():
        ctl, _ = caption_logits(get, px, pre, post, tokens[:, :-1], cfg,
                                Precision("fp8"), record=own)
    n = len(pixels)
    prog = [{"logits": ctl[k * rows:(k + 1) * rows].cpu(),
             "tokens": tokens[k * rows:(k + 1) * rows].cpu(),
             "routes": [r[k * rows:(k + 1) * rows].cpu() for r in own]}
            for k in range(n)]
    out["control"] = check(cfg, t, specs, wseed, pixels, prog, device)[0]
    return out
