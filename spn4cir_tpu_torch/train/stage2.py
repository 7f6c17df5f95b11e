"""Stage-2 ("scaling negatives") trainer: frozen image tower, live text side,
full-bank InfoNCE.

Counterpart of `spn4cir_tpu/train/stage2.py`. Parity target: the epoch loop
+ bank step of `clip4cir/train.py:103-131` and `CIRPlus.forward /
bank_large_step` (`clip4cir/models.py:130-161`), with the reference's AdamW
hyperparameters (betas (0.9, 0.999), eps 1e-7, weight decay 1e-2).

One step: text tower forward, `normalize(refer + text)`, the bank loss,
backward through the text tower, AdamW over the trainable parameters. The
target bank stays on the device; refer rows are gathered on the host per
batch (they are the frozen cache, no gradient flows into them). Parameters
and optimizer state are float32 even when activations run in bfloat16 (eps
1e-7 is below bfloat16 resolution); there is no autocast and no GradScaler.

Frozen parameters (the image tower, by the backbone's `trainable_filter`,
and `logit_scale`, which no CIR loss reads and which weight decay would
otherwise shrink) get `requires_grad=False` and are not handed to the
optimizer, so they come out of training bit-identical.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch

from spn4cir_tpu_torch.bank.bank import Bank
from spn4cir_tpu_torch.data.prefetch import prefetch
from spn4cir_tpu_torch.models.api import CIRBackbone

LearningRate = Union[float, Callable[[int], float]]


def trainable_mask(backbone: CIRBackbone) -> Dict[str, bool]:
    """Parameter name -> trains in stage 2. Besides the backbone's freeze
    filter, CLIP's `logit_scale` is excluded: it never appears in a CIR
    loss, so its gradient is exactly zero and unmasked weight decay would
    shrink the stored checkpoint value every step."""
    return {name: ("logit_scale" not in name.split(".")
                   and bool(backbone.trainable_filter(name)))
            for name, _ in backbone.named_parameters()}


@dataclasses.dataclass
class TrainState:
    """The optimizer, the learning rate (a float, or step -> float) and the
    number of optimizer steps taken; the parameters live in the backbone."""

    optimizer: torch.optim.Optimizer
    learning_rate: LearningRate
    step: int = 0

    def lr_at(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step)) if callable(lr) else float(lr)


def make_optimizer(learning_rate: float, backbone: CIRBackbone, *,
                   weight_decay: float = 1e-2, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-7
                   ) -> torch.optim.AdamW:
    """AdamW over the trainable parameters only; sets `requires_grad` of
    every parameter from `trainable_mask`, so a frozen one can never move."""
    mask = trainable_mask(backbone)
    params = []
    for name, p in backbone.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def create_train_state(backbone: CIRBackbone, learning_rate: LearningRate,
                       **opt_kw) -> TrainState:
    """`learning_rate` may be a float or a schedule (step -> float).
    Backbone-specific AdamW hyperparameters apply unless overridden."""
    merged = {**backbone.optimizer_kwargs(), **opt_kw}
    state = TrainState(optimizer=None, learning_rate=learning_rate)
    state.optimizer = make_optimizer(state.lr_at(0), backbone, **merged)
    return state


def make_lr_schedule(kind: str, base_lr: float, steps_per_epoch: int,
                     num_epochs: int, warmup_steps: int = 0,
                     min_lr: float = 0.0) -> LearningRate:
    """Optional LR schedules (the reference trains at constant LR):
    'cosine' is a linear warmup from 0 over `warmup_steps` then a cosine
    decay to `min_lr` at the last step; 'linear' decays linearly from
    `base_lr` to `min_lr`. Step 0 is the first optimizer step."""
    total = max(steps_per_epoch * num_epochs, 1)
    if kind == "constant":
        return base_lr
    if kind == "cosine":
        decay_steps = total - warmup_steps
        if decay_steps <= 0:
            raise ValueError("cosine schedule needs warmup_steps < total steps")
        alpha = 0.0 if base_lr == 0 else min_lr / base_lr

        def cosine(step: int) -> float:
            if step < warmup_steps:
                return base_lr * step / warmup_steps
            frac = min(step - warmup_steps, decay_steps) / decay_steps
            return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac))
                              + alpha)
        return cosine
    if kind == "linear":
        def linear(step: int) -> float:
            frac = min(max(step / total, 0.0), 1.0)
            return base_lr + (min_lr - base_lr) * frac
        return linear
    raise ValueError(f"unknown lr schedule {kind!r}")


def sample_negatives(rng, pos_ids, num_images: int, neg_num: int) -> np.ndarray:
    """Uniform negative ids WITHOUT replacement, excluding each row's
    positive — the reference's draw distribution (`random.sample` over
    range(M) minus the positive, clip4cir/models.py:109-113).

    Implemented as first-k-distinct of an iid uniform stream over M-1
    values (distributionally identical to sampling without replacement),
    then shifted past the positive; vectorized per row."""
    if neg_num >= num_images:
        raise ValueError(f"neg_num={neg_num} must be < num_images={num_images}")
    pos_ids = np.asarray(pos_ids)
    out = np.empty((len(pos_ids), neg_num), np.int64)
    for i, pos in enumerate(pos_ids):
        vals = np.empty(0, np.int64)
        while vals.size < neg_num:
            draw = rng.randint(0, num_images - 1,
                               size=max(2 * (neg_num - vals.size), 16))
            cat = np.concatenate([vals, draw])
            _, first = np.unique(cat, return_index=True)
            vals = cat[np.sort(first)]  # distinct, first-appearance order
        row = vals[:neg_num]
        out[i] = row + (row >= pos)
    return out


def stage2_train_step(backbone: CIRBackbone, state: TrainState,
                      target_bank, batch: Dict[str, torch.Tensor]
                      ) -> torch.Tensor:
    """One optimizer step. batch: refer_feats (B, *refer_shape) gathered
    bank rows, text_ids (B, L), labels (B,) target-image ids into the bank,
    optionally neg_idx (B, neg_num). Returns the loss as a detached device
    scalar (no host read)."""
    optimizer = state.optimizer
    optimizer.zero_grad(set_to_none=True)
    loss = backbone.stage2_loss(batch["refer_feats"], batch["text_ids"],
                                target_bank, batch["labels"],
                                neg_idx=batch.get("neg_idx"))
    loss.backward()
    lr = state.lr_at(state.step)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    state.step += 1
    return loss.detach()


def train_epoch(
    backbone: CIRBackbone,
    state: TrainState,
    bank: Bank,
    batches: Iterator[dict],
    *,
    neg_num: Optional[int] = None,
    neg_rng: Optional[np.random.RandomState] = None,
    neg_seed: Optional[int] = None,
    log_every: int = 50,
    log_fn: Callable[[int, float], None] = lambda step, loss: None,
    start_step: int = 0,
):
    """Host epoch loop over `iter_train_bank` batches: gather refer rows,
    tokenize, run the step. Returns (state, mean_loss). Batches are
    prefetched on a background thread."""
    device = backbone.device
    # The loss stays on the device between steps (loss_sum is a device
    # scalar); the host reads it only every `log_every` steps — a per-step
    # float(loss) would wait for the device every step.
    loss_sum, count = None, 0
    for step, raw in enumerate(prefetch(batches, depth=2), start=start_step):
        dev_batch = {
            "refer_feats": torch.from_numpy(bank.gather_refer(raw)).to(device),
            "text_ids": torch.from_numpy(
                backbone.tokenize(raw["captions"])).to(device),
            "labels": torch.from_numpy(raw["target_image_id"]).to(device),
        }
        if neg_num:
            # neg_seed: STATELESS per-step draws (RandomState keyed on
            # (seed, step)) so an epoch/step resume replays the exact
            # negative sets of the uninterrupted run; neg_rng keeps the
            # sequential stream for callers that manage it
            if neg_seed is not None:
                rng = np.random.RandomState(
                    (int(neg_seed) * 100_003 + step) % (2**32))
            else:
                rng = neg_rng or np.random
            dev_batch["neg_idx"] = torch.from_numpy(sample_negatives(
                rng, raw["target_image_id"], bank.num_images, neg_num)
            ).to(device)
        loss = stage2_train_step(backbone, state, bank.target, dev_batch)
        loss_sum = loss if loss_sum is None else loss_sum + loss
        count += 1
        if log_every and step % log_every == 0:
            log_fn(step, float(loss))
    mean = float(loss_sum) / count if count else 0.0
    return state, mean
