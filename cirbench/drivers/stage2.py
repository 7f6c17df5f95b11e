"""The `stage2` driver: `train/stage2.py`'s `train_epoch` over a device bank,
a host refer pool and seeded caption batches, for any family.

Set-up builds one backbone and one AdamW state, loads the benchmark's
weights, and drives them through the first `check_steps` steps with the
window's own call (`train_epoch`) on batches whose rows all differ. From
them it keeps each step's loss, the first gradient as AdamW's state holds
it after one step (exp_avg / (1 - beta1)), and the change of the trainable
leaves after the last. The window then runs `train_epoch` on the same
object until `--seconds` have passed. Once it has closed and the program's
state is freed, the plain reference follows the same first steps from the
same weights and inputs, and the gaps decide `correct`.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict

import numpy as np

from cirbench import gen
from cirbench.families import build_program, reference
from cirbench.harness import Cell, sub_seed
from cirbench.weights import (load_weights, make_weights, param_shapes,
                              reference_names)


def make_inputs(cell: Cell, seed: int, backbone, device):
    """The target bank (on the device), the refer pool (on the host) and the
    batch pool, from the seed."""
    import torch

    t = cell.traffic
    spec = backbone.bank_spec()
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, gen.BANK))
    target = torch.randn((t["bank_rows"], *spec.target_shape), generator=g,
                         device=device)
    target = torch.nn.functional.normalize(target, dim=-1).to(
        getattr(torch, t["bank_dtype"]))
    refer_rows = t.get("refer_rows", t["bank_rows"])
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, gen.REFER))
    refer = torch.randn((refer_rows, *spec.refer_shape), generator=g,
                        device=device).mul_(t.get("refer_scale", 1.0))
    refer = refer.cpu().numpy()
    pool = gen.stage2_batches(seed, t["batch_pool"], t["batch"],
                              t["bank_rows"], refer_rows, t["caption_words"])
    return target, refer, pool


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, scratch: str, faults=()) -> Dict[str, Any]:
    """One run. `faults` plants faults in the program for the CPU tests:
    'unchanged' (the step leaves its state as it was), 'half_batch' (the
    loss over half of each batch), 'token' (a caption token altered in the
    tokenizer's output)."""
    import torch

    from spn4cir_tpu_torch.bank.bank import Bank
    from spn4cir_tpu_torch.train.stage2 import create_train_state, train_epoch

    from cirbench.trace import profile_window

    cfg, t = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    marks = {"imports": time.perf_counter() - t_start}
    backbone = build_program(cfg, device)
    shapes = param_shapes(backbone)
    wseed = sub_seed(seed, gen.WEIGHTS)
    weights = make_weights(shapes, wseed, device, cfg.get("scalars", {}))
    load_weights(backbone, weights)
    marks["weights"] = time.perf_counter() - t_start
    target, refer, pool = make_inputs(cell, seed, backbone, device)
    marks["inputs"] = time.perf_counter() - t_start
    bank = Bank(refer=refer, target=target, refer_key=t["refer_key"])
    state = create_train_state(backbone, t["lr"])
    _plant(backbone, state, faults)
    backbone.train()
    live = [(n, p) for n, p in backbone.named_parameters() if p.requires_grad]

    # the first steps, through the window's own call, kept for the check
    losses, grads = [], None
    for i in range(t["check_steps"]):
        _, loss = train_epoch(backbone, state, bank, iter([pool[i]]),
                              log_every=0)
        losses.append(loss)
        if grads is None:
            opt = state.optimizer
            b1 = opt.param_groups[0]["betas"][0]
            grads = reference_names({
                n: (opt.state[p]["exp_avg"] / (1 - b1)).cpu()
                if p in opt.state else None for n, p in live})
    marks["first_steps"] = time.perf_counter() - t_start
    delta = reference_names({n: (p.detach() - weights[n]).cpu()
                             for n, p in live})
    del weights
    gc.collect()
    sync()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    def window(duration: float, first: int):
        """train_epoch on the pool from batch `first` until `duration`
        seconds have passed; (steps, seconds, mean loss)."""
        count = [0]
        deadline = time.perf_counter() + duration

        def feed():
            i = first
            while time.perf_counter() < deadline:
                count[0] += 1
                yield pool[i % len(pool)]
                i += 1

        sync()
        t0 = time.perf_counter()
        _, mean = train_epoch(backbone, state, bank, feed(), log_every=0)
        sync()
        return count[0], time.perf_counter() - t0, mean

    from cirbench.harness import read_counters

    read_counters(reset=True)
    steps, window_s, mean_loss = window(seconds, t["check_steps"])
    out: Dict[str, Any] = {
        "notes": ["window launches " + str(read_counters())],
        "setup_s": setup_s, "attempted": steps,
        "failed": 0 if math.isfinite(mean_loss) else steps,
        "end_to_end": {"stage2_step_ms": 1e3 * window_s / steps},
    }
    if trace:
        n = t["profile_steps"]

        def profiled(k):
            return lambda: train_epoch(backbone, state, bank, iter(pool[:k]),
                                       log_every=0)

        profile_window(profiled(1), scratch)   # the profiler's start-up
        read_counters(reset=True)
        out["trace"] = profile_window(profiled(n), scratch)
        out["counters"] = read_counters()
        out["step_s"] = window_s / steps
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if cuda else 0)
    out["shapes"] = _shapes(cfg, t, backbone)

    # the program's state is freed before the reference runs
    del backbone, state, bank, live
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference(cfg)
    weights = reference_names(make_weights(
        shapes, wseed, device, cfg.get("scalars", {})))
    ref_losses, ref_grads, ref_delta = reference_run(
        ref, weights, pool, target, refer, cfg, t)
    from cirbench.compare import train_detail, train_gaps

    out["values"] = train_gaps(losses, grads, delta, ref_losses, ref_grads,
                               ref_delta)
    out["detail"] = {"losses": losses, "ref_losses": ref_losses,
                     "setup_marks": marks,
                     **train_detail(losses, grads, delta, ref_losses,
                                    ref_grads, ref_delta)}
    return out


def reference_run(ref, weights, pool, target, refer, cfg, t,
                  precision: str = "float32", fault=None):
    from cirbench.reference.common import Precision
    from cirbench.reference.train import reference_steps

    return reference_steps(ref, weights, pool[:t["check_steps"]], target,
                           refer, cfg, t["lr"], Precision(precision), fault)


def _shapes(cfg, t, backbone) -> Dict[str, Any]:
    spec = backbone.bank_spec()
    return {"family": cfg["family"], "batch": t["batch"],
            "bank_rows": t["bank_rows"], "bank_dtype": t["bank_dtype"],
            "target_shape": list(spec.target_shape),
            "refer_shape": list(spec.refer_shape), "config": cfg}


def _plant(backbone, state, faults) -> None:
    """The CPU tests' faults, planted in the program."""
    if "unchanged" in faults:
        state.optimizer.step = lambda *a, **k: None
    if "half_batch" in faults:
        loss_fn = backbone.stage2_loss

        def half(refer_feats, text_ids, target_bank, labels, **kw):
            h = labels.shape[0] // 2
            return loss_fn(refer_feats[:h], text_ids[:h], target_bank,
                           labels[:h], **kw)
        backbone.stage2_loss = half
    if "token" in faults:
        tokenize = backbone.tokenize

        def altered(texts):
            ids = np.array(tokenize(texts))
            if ids.ndim == 2:       # CLIP ids (B, L)
                ids[:, 1] = np.where(ids[:, 1] == 300, 301, 300)
            else:                   # BERT ids and mask (B, 2, L)
                ids[:, 0, 1] = np.where(ids[:, 0, 1] == 300, 301, 300)
            return ids
        backbone.tokenize = altered


def calibrate(cell: Cell, seed: int, device, what) -> Dict[str, Dict]:
    """The readings that set the limits: for each of `what`, the gaps of
    the reference put in the program's place against the float32
    reference, on this seed's inputs. 'control' is the reference in float8;
    'half_batch' and 'token' are faults planted in the reference."""
    from cirbench.compare import train_detail, train_gaps

    cfg, t = cell.config, cell.traffic
    backbone = build_program(cfg, "meta")
    target, refer, pool = make_inputs(cell, seed, backbone, device)
    ref = reference(cfg)
    weights = reference_names(make_weights(
        param_shapes(backbone), sub_seed(seed, gen.WEIGHTS), device,
        cfg.get("scalars", {})))
    base = reference_run(ref, weights, pool, target, refer, cfg, t)
    out = {}
    for w in what:
        prec, fault = {"control": ("fp8", None),
                       "bf16": ("bf16", None)}.get(w, ("float32", w))
        other = reference_run(ref, weights, pool, target, refer, cfg, t,
                              prec, fault)
        out[w] = {**train_gaps(*other, *base),
                  "detail": train_detail(*other, *base)}
    return out
