"""The `extract` driver: the backbone's caption-aware bank encode
(`fusion_bank_features`, what `bank/bank.py`'s `extract_fusion_banks` calls
for each batch) over seeded pixel batches already on the device, in a loop
for the whole window.

Each pass tokenizes its batch's captions on the host, as the extractor
does; the extractor's copy of the rows to host memory is left out. The
last outputs of each pixel batch in the window are kept; once the window
has closed and the program is freed, the plain reference encodes the same
pixels and captions, and the worst row decides `correct`.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict

from cirbench import gen
from cirbench.families import build_program, reference
from cirbench.harness import Cell, sub_seed
from cirbench.weights import (load_weights, make_weights, param_shapes,
                              reference_names)


def make_inputs(cell: Cell, seed: int, device):
    import torch

    cfg, t = cell.config, cell.traffic
    side = cfg["vision"]["image_size"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, gen.PIXELS))
    pixels = torch.randn((t["pixel_batches"], t["batch"], side, side, 3),
                         generator=g, device=device)
    r = gen.rng(seed, gen.BATCHES)
    caps = [gen.captions(r, t["batch"], t["caption_words"])
            for _ in range(t["pixel_batches"])]
    return pixels, caps


def row_gap(prog, ref) -> float:
    """The worst row's relative L2 error, rows along the last axis."""
    prog = prog.float().reshape(-1, prog.shape[-1])
    ref = ref.float().reshape(-1, ref.shape[-1])
    err = (prog - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-12)
    return float(err.max())


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, scratch: str, faults=()) -> Dict[str, Any]:
    """One run. `faults` (the CPU tests'): 'answer' alters one image's
    output where it is produced; 'half_batch' leaves out the second half
    of each batch, whose rows repeat the first half's."""
    import torch

    from cirbench.harness import read_counters
    from cirbench.trace import profile_window

    cfg, t = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    backbone = build_program(cfg, device)
    shapes = param_shapes(backbone)
    wseed = sub_seed(seed, gen.WEIGHTS)
    weights = make_weights(shapes, wseed, device, cfg.get("scalars", {}))
    load_weights(backbone, weights)
    del weights
    backbone.eval()
    pixels, caps = make_inputs(cell, seed, device)
    encode = backbone.fusion_bank_features
    if "answer" in faults or "half_batch" in faults:
        encode = _planted(encode, faults)

    @torch.no_grad()
    def step(k):
        ids = torch.from_numpy(backbone.tokenize(caps[k])).to(device)
        return encode(pixels[k], ids)

    outs = [step(k) for k in range(len(caps))]          # warms every shape
    sync()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    def loop(duration: float) -> int:
        deadline = time.perf_counter() + duration
        i = 0
        while time.perf_counter() < deadline:
            outs[i % len(caps)] = step(i % len(caps))
            i += 1
        return i

    read_counters(reset=True)
    sync()
    t0 = time.perf_counter()
    passes = loop(seconds)
    sync()
    window_s = time.perf_counter() - t0
    images = passes * t["batch"]
    out: Dict[str, Any] = {
        "notes": ["window launches " + str(read_counters())],
        "setup_s": setup_s, "attempted": images, "failed": 0,
        "end_to_end": {"extract_images_per_s": images / window_s},
    }
    if trace:
        n = t["profile_batches"]

        def profiled(k):
            def fn():
                for i in range(k):
                    step(i % len(caps))
            return fn

        profile_window(profiled(1), scratch)
        read_counters(reset=True)
        out["trace"] = profile_window(profiled(n), scratch)
        out["counters"] = read_counters()
        out["batch_s"] = window_s / passes
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if cuda else 0)
    out["shapes"] = {"family": cfg["family"], "batch": t["batch"],
                     "config": cfg}

    prog = [(f.float().cpu(), g.float().cpu()) for f, g in outs]
    del backbone, outs, encode
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["values"] = check(cfg, shapes, wseed, pixels, caps, prog, device)
    return out


def check(cfg, shapes, wseed, pixels, caps, prog, device,
          precision: str = "float32") -> Dict[str, float]:
    """The plain reference's bank forms of the same inputs against
    `prog`: the worst row of the fused states and of the query features."""
    import torch

    from cirbench.reference.common import Precision, strict_float32

    ref = reference(cfg)
    weights = reference_names(make_weights(
        shapes, wseed, device, cfg.get("scalars", {})))
    tok = ref.tokenizer(cfg)
    fused_gap = feat_gap = 0.0
    with torch.no_grad(), strict_float32():
        for k, (p_fused, p_feat) in enumerate(prog):
            ids, mask = ref.text_inputs(tok, caps[k], cfg, device)
            r_fused, r_feat = ref.bank_features(weights, pixels[k], ids, mask,
                                                cfg, Precision(precision))
            fused_gap = max(fused_gap, row_gap(p_fused, r_fused.cpu()))
            feat_gap = max(feat_gap, row_gap(p_feat, r_feat.cpu()))
    return {"fused_gap": fused_gap, "feat_gap": feat_gap}


def calibrate(cell: Cell, seed: int, device, what) -> Dict[str, Dict]:
    """The control: the plain reference in float8 put in the program's
    place, against the float32 reference."""
    cfg = cell.config
    shapes = param_shapes(build_program(cfg, "meta"))
    wseed = sub_seed(seed, gen.WEIGHTS)
    pixels, caps = make_inputs(cell, seed, device)
    out = {}
    if "control" in what:
        from cirbench.reference.common import Precision, strict_float32
        import torch

        ref = reference(cfg)
        weights = reference_names(make_weights(
            shapes, wseed, device, cfg.get("scalars", {})))
        tok = ref.tokenizer(cfg)
        ctl = []
        with torch.no_grad(), strict_float32():
            for k in range(len(caps)):
                ids, mask = ref.text_inputs(tok, caps[k], cfg, device)
                f, g = ref.bank_features(weights, pixels[k], ids, mask, cfg,
                                         Precision("fp8"))
                ctl.append((f.cpu(), g.cpu()))
        del weights
        out["control"] = check(cfg, shapes, wseed, pixels, caps, ctl, device)
    return out


def _planted(encode, faults):
    def planted(images, ids):
        fused, feats = encode(images, ids)
        if "answer" in faults:
            feats = feats.clone()
            feats[0] = feats[1]
        if "half_batch" in faults:
            h = feats.shape[0] // 2
            fused = fused.clone()
            feats = feats.clone()
            fused[h:2 * h] = fused[:h]
            feats[h:2 * h] = feats[:h]
        return fused, feats
    return planted
