"""The plain reference's first stage-2 steps: its own tokens, the refer rows
gathered from the benchmark's pool, the family's loss, autograd and AdamW
written out, all in float32 (or the control's precision)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from cirbench.reference.common import AdamW, Precision, strict_float32


def reference_steps(ref, weights: Dict[str, torch.Tensor], batches: List[dict],
                    bank: torch.Tensor, refer: np.ndarray, cfg: dict,
                    lr: float, prec: Precision, fault: Optional[str] = None):
    """(losses, first gradients, change after the steps) of the trainable
    leaves, the last two on the host. `fault` plants one of the faults the
    correctness check has to catch, in the reference put in the program's
    place: 'half_batch' (the mean over the first half of each batch) or
    'token' (one caption token altered where it is produced)."""
    device = bank.device
    names = [k for k in weights if ref.trainable(k)]
    params = {k: weights[k].detach().clone().requires_grad_(True)
              for k in names}
    start = {k: weights[k].detach().clone() for k in names}
    frozen = {k: v for k, v in weights.items() if k not in params}
    opt = AdamW(params, lr, **cfg["adamw"])
    tok = ref.tokenizer(cfg)
    losses, first = [], None
    with strict_float32():
        for batch in batches:
            inputs = ref.text_inputs(tok, batch["captions"], cfg, device)
            if fault == "token":
                inputs = ref.alter_token(inputs)
            rows = batch[ref.REFER_KEY]
            refer_rows = torch.from_numpy(refer[rows]).to(device)
            labels = torch.from_numpy(
                np.asarray(batch["target_image_id"])).long().to(device)
            if fault == "half_batch":
                half = len(labels) // 2
                inputs = (tuple(x[:half] for x in inputs)
                          if isinstance(inputs, tuple) else inputs[:half])
                refer_rows, labels = refer_rows[:half], labels[:half]
            loss = ref.stage2_loss({**frozen, **params}, inputs, refer_rows,
                                   bank, labels, cfg, prec)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            grads = dict(zip(names, grads))
            if first is None:
                first = {k: None if g is None else g.detach().cpu()
                         for k, g in grads.items()}
            opt.step(grads)
            losses.append(float(loss.detach()))
    delta = {k: (params[k].detach() - start[k]).cpu() for k in names}
    return losses, first, delta
