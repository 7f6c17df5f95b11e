"""Stage-1 trainer: end-to-end in-batch InfoNCE (the `--wo_bank` path).

Counterpart of `create_stage1_state`, `stage1_train_step` and
`train_epoch_stage1` in `spn4cir_tpu/train/stage1.py`, on one device: both
image batches of a step go through the live image tower, the loss is the
backbone's `stage1_loss`, and AdamW (the reference's hyperparameters, as in
stage 2) moves every weight. Activations may run in bfloat16 over float32
parameters and optimizer state; `--grad_ckpt` (the backbone's `remat`)
trades the blocks' activations for a second forward in the backward.

`neg_type` > 0 selects the negative-type ablation's loss
(`stage1_negtype_loss`, clip and zs) in place of `stage1_loss`; it runs
without dropout, as in the JAX CLI.

Not ported: the data-sharded step over a device mesh (`sharded_step`) and
the device-side preprocess (`raw_kind`).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import torch

from spn4cir_tpu_torch.data.prefetch import prefetch
from spn4cir_tpu_torch.models.api import CIRBackbone
from spn4cir_tpu_torch.train.stage2 import (LearningRate, TrainState,
                                            apply_gradients, make_optimizer)


def create_stage1_state(backbone: CIRBackbone, learning_rate: LearningRate,
                        **opt_kw) -> TrainState:
    """All weights train in stage 1 (no freeze filter). As torch's AdamW
    skips parameters without a gradient, the optimizer never touches CLIP's
    loss-unused `logit_scale` (decaying it would corrupt the checkpoint) or
    the BatchNorm running statistics, which are buffers: BatchNorm runs on
    its stored statistics and only its affine scale and bias train."""
    merged = {**backbone.optimizer_kwargs(), **opt_kw}
    state = TrainState(optimizer=None, learning_rate=learning_rate)
    state.optimizer = make_optimizer(state.lr_at(0), backbone,
                                     trainable=lambda name: True, **merged)
    return state


def stage1_loss_fn(backbone: CIRBackbone, batch: Dict[str, torch.Tensor],
                   neg_type: int = 0,
                   dropout_generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """The stage-1 loss of one batch: the negtype ablation's when
    `neg_type` > 0 (no dropout), else the backbone's `stage1_loss`, with
    `dropout_generator` for a backbone that takes one."""
    images = (batch["refer_images"], batch["target_images"],
              batch["text_ids"])
    if neg_type:
        return backbone.stage1_negtype_loss(*images, neg_type)
    kw = ({"generator": dropout_generator}
          if dropout_generator is not None else {})
    return backbone.stage1_loss(*images, **kw)


def stage1_train_step(backbone: CIRBackbone, state: TrainState,
                      batch: Dict[str, torch.Tensor],
                      dropout_generator: Optional[torch.Generator] = None,
                      neg_type: int = 0) -> torch.Tensor:
    """One optimizer step. batch: refer_images (B, H, W, 3), target_images
    (B, H, W, 3), text_ids. `dropout_generator` goes to a backbone that
    takes one (the MED family in `train()` mode); `neg_type` picks the
    ablation's loss (`stage1_loss_fn`). Returns the loss as a detached
    device scalar."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = stage1_loss_fn(backbone, batch, neg_type, dropout_generator)
    return apply_gradients(state, loss)


def train_epoch_stage1(
    backbone: CIRBackbone,
    state: TrainState,
    batches: Iterator[dict],
    *,
    neg_type: int = 0,
    dropout_generator: Optional[torch.Generator] = None,
    log_every: int = 50,
    log_fn: Callable[[int, float], None] = lambda step, loss: None,
    start_step: int = 0,
    step_hook: Optional[Callable[[int, TrainState], None]] = None,
):
    """Host loop over `iter_train_images` batches; a batch with a padded
    tail is dropped (drop_last). The loss accumulates on the device; the
    host reads it only every `log_every` steps. The next batch's decode
    runs ahead on a prefetch thread: a step decodes 2B fresh images.
    `step_hook(step_in_epoch, state)` runs after every step; `start_step`
    numbers the steps of a mid-epoch resume. Returns (state, mean_loss)."""
    device = backbone.device
    loss_sum, count = None, 0
    for step, raw in enumerate(prefetch(batches, depth=2), start=start_step):
        if (raw["triplet_idx"] < 0).any():
            continue
        batch = {
            "refer_images": torch.from_numpy(raw["refer_images"]).to(device),
            "target_images": torch.from_numpy(raw["target_images"]).to(device),
            "text_ids": torch.from_numpy(
                backbone.tokenize(raw["captions"])).to(device),
        }
        loss = stage1_train_step(backbone, state, batch, dropout_generator,
                                 neg_type)
        loss_sum = loss if loss_sum is None else loss_sum + loss
        count += 1
        if log_every and step % log_every == 0:
            log_fn(step, float(loss))
        if step_hook is not None:
            step_hook(step + 1, state)
    return state, (float(loss_sum) / count if count else 0.0)
