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

`raw_kind` (`--device_preprocess`): the image entries arrive as `RawBatch`
uint8 canvases and the resize, crop and normalize run on the device inside
the step; they do not depend on the weights, so autograd records nothing
for them.

`sharded_step` (`parallel.train.make_sharded_stage1_step`) runs each batch
data-parallel: every rank takes its rows of the global batch and the step
sums the gradients over the mesh's data group.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import torch

from spn4cir_tpu_torch.data.prefetch import prefetch
from spn4cir_tpu_torch.models.api import CIRBackbone
from spn4cir_tpu_torch.ops.preprocess import (batch_to_device,
                                              preprocess_batch_dynamic)
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
                   dropout_generator: Optional[torch.Generator] = None,
                   raw_kind: Optional[str] = None,
                   gather: Optional[Callable] = None) -> torch.Tensor:
    """The stage-1 loss of one batch: the negtype ablation's when
    `neg_type` > 0 (no dropout), else the backbone's `stage1_loss`, with
    `dropout_generator` for a backbone that takes one. With `raw_kind` the
    image entries are RawBatch canvases, preprocessed here first. `gather`
    (a data-parallel step's, `ops.infonce.Gather`) makes the in-batch
    losses run over the global batch."""
    if raw_kind is not None:
        batch = dict(batch, **{
            side: preprocess_batch_dynamic(
                batch[side].canvas, batch[side].extents, backbone.input_dim,
                raw_kind)
            for side in ("refer_images", "target_images")})
    images = (batch["refer_images"], batch["target_images"],
              batch["text_ids"])
    kw = {"gather": gather} if gather is not None else {}
    if neg_type:
        return backbone.stage1_negtype_loss(*images, neg_type, **kw)
    if dropout_generator is not None:
        kw["generator"] = dropout_generator
    return backbone.stage1_loss(*images, **kw)


def stage1_train_step(backbone: CIRBackbone, state: TrainState,
                      batch: Dict[str, torch.Tensor],
                      dropout_generator: Optional[torch.Generator] = None,
                      neg_type: int = 0,
                      raw_kind: Optional[str] = None) -> torch.Tensor:
    """One optimizer step. batch: refer_images (B, H, W, 3), target_images
    (B, H, W, 3) (RawBatch canvases with `raw_kind`), text_ids.
    `dropout_generator` goes to a backbone that takes one (the MED family in
    `train()` mode); `neg_type` picks the ablation's loss
    (`stage1_loss_fn`). Returns the loss as a detached device scalar."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = stage1_loss_fn(backbone, batch, neg_type, dropout_generator,
                          raw_kind)
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
    raw_kind: Optional[str] = None,
    sharded_step=None,
):
    """Host loop over `iter_train_images` batches; a batch with a padded
    tail is dropped (drop_last). The loss accumulates on the device; the
    host reads it only every `log_every` steps. The next batch's decode
    runs ahead on a prefetch thread: a step decodes 2B fresh images.
    `step_hook(step_in_epoch, state)` runs after every step; `start_step`
    numbers the steps of a mid-epoch resume; `raw_kind`: the batches hold
    RawBatch canvases (`stage1_loss_fn`). `sharded_step` runs each batch
    data-parallel; `batches` then holds this rank's rows of each global
    batch with the whole batch's ids (`iter_train_images(part=mesh.part())`)
    and the step must have been built for this epoch's `neg_type`, dropout
    and `raw_kind`. Returns (state, mean_loss)."""
    device = backbone.device
    if sharded_step is not None:
        built = (sharded_step.neg_type, sharded_step.with_dropout,
                 sharded_step.raw_kind)
        asked = (neg_type, dropout_generator is not None, raw_kind)
        if built != asked:
            raise ValueError(f"the sharded step was built for (neg_type, "
                             f"dropout, raw_kind) = {built}; this epoch asks "
                             f"for {asked}")
    loss_sum, count = None, 0
    for step, raw in enumerate(prefetch(batches, depth=2), start=start_step):
        if (raw["triplet_idx"] < 0).any():
            continue
        batch = {
            "refer_images": batch_to_device(raw["refer_images"], device),
            "target_images": batch_to_device(raw["target_images"], device),
            "text_ids": torch.from_numpy(
                backbone.tokenize(raw["captions"])).to(device),
        }
        if sharded_step is not None:
            loss = sharded_step(state, batch, dropout_generator)
        else:
            loss = stage1_train_step(backbone, state, batch,
                                     dropout_generator, neg_type, raw_kind)
        loss_sum = loss if loss_sum is None else loss_sum + loss
        count += 1
        if log_every and step % log_every == 0:
            log_fn(step, float(loss))
        if step_hook is not None:
            step_hook(step + 1, state)
    return state, (float(loss_sum) / count if count else 0.0)
