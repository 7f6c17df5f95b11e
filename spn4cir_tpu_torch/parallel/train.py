"""Data-parallel stage-1 and stage-2 steps and the data-parallel encode.

Counterpart of `spn4cir_tpu/parallel/train.py`. Every rank runs the same
step on its rows of the global batch (`mesh.local_rows`) with a full
replica of the parameters (or, with a `model` axis, its tensor-parallel
slice of them, `parallel/tp.py`); the gradients are summed over the `data`
group before one AdamW step (`train.stage2.apply_gradients`). Parameters
start equal on every rank (`mesh.broadcast_module`) and stay equal, since
every rank applies the same summed gradient.

Stage 2: flat backbones pair `fuse` with `sharded_bank_infonce`, blip2
pairs `stage2_query_feats` with `sharded_max_query_infonce`; the bank is
this rank's shard (`mesh.bank_shard`). Stage 1: the in-batch losses run
over the global batch, every rank's features gathered with their gradient
(the `gather` that `stage1_loss_fn` passes to them), and each rank
backpropagates its 1/n share, so the summed gradient is the global loss's.

Dropout (`dropout_generator`): the noise is drawn at the global batch's
shape from a generator seeded alike on every rank and each rank keeps its
rows (`models.med.GlobalNoise`), so the sharded step equals the
single-process step for the same seed.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from spn4cir_tpu_torch.models.api import CIRBackbone
from spn4cir_tpu_torch.models.med import GlobalNoise
from spn4cir_tpu_torch.parallel.loss import (sharded_bank_infonce,
                                             sharded_max_query_infonce)
from spn4cir_tpu_torch.parallel.mesh import (AXIS_DATA, Mesh,
                                             all_reduce_grads, gather_rows,
                                             gather_rows_with_grad)
from spn4cir_tpu_torch.train.stage2 import TrainState, apply_gradients


def is_max_query(backbone: CIRBackbone) -> bool:
    """blip2: a training fusion path and a 2-D (Q, D) target row."""
    return (hasattr(backbone, "stage2_query_feats")
            and len(backbone.bank_spec().target_shape) == 2)


def _noise(mesh: Mesh, generator: Optional[torch.Generator], rows: int):
    if generator is None:
        return {}
    n = mesh.size(AXIS_DATA)
    return {"generator": GlobalNoise(generator, mesh.index(AXIS_DATA) * rows,
                                     rows * n)}


def _reduce_over_data(mesh: Mesh):
    return lambda params: all_reduce_grads(params, mesh.group(AXIS_DATA))


def make_sharded_stage2_step(backbone: CIRBackbone, mesh: Mesh, tau=None,
                             m_actual: Optional[int] = None):
    """A step (state, bank_shard, batch, dropout_generator=None) -> loss.

    batch: this rank's rows (refer_feats, text_ids, labels with global
    image ids); bank_shard: this rank's rows of the padded target bank
    (`mesh.bank_shard`), dense or an int8 QuantBank; `m_actual` the bank's
    true row count. `tau` overrides the backbone's (`loss_tau`, the live
    parameter where it trains). Returns the global loss as a detached
    device scalar, the same on every rank."""
    max_query = is_max_query(backbone)

    def step(state: TrainState, bank_shard, batch: Dict[str, torch.Tensor],
             dropout_generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        kw = _noise(mesh, dropout_generator, batch["labels"].shape[0])
        t = tau if tau is not None else backbone.loss_tau()
        if max_query:
            feats = backbone.stage2_query_feats(batch["refer_feats"],
                                                batch["text_ids"], **kw)
            loss = sharded_max_query_infonce(feats, bank_shard,
                                             batch["labels"], t, mesh,
                                             m_actual=m_actual)
        else:
            query = backbone.fuse(batch["refer_feats"], batch["text_ids"],
                                  **kw)
            loss = sharded_bank_infonce(query, bank_shard, batch["labels"],
                                        t, mesh, m_actual=m_actual)
        return apply_gradients(state, loss, _reduce_over_data(mesh))

    step.max_query = max_query
    return step


def make_sharded_stage1_step(backbone: CIRBackbone, mesh: Mesh,
                             with_dropout: bool = False, neg_type: int = 0,
                             raw_kind: Optional[str] = None):
    """A step (state, batch, dropout_generator=None) -> loss over a (data[,
    model]) mesh, the scale-out form of `train.stage1.stage1_train_step`:
    batch holds this rank's rows (refer_images, target_images, text_ids;
    RawBatch canvases with `raw_kind`); the loss is the single-process
    `stage1_loss_fn` over the global batch. The build configuration rides
    on the step (`neg_type`, `with_dropout`, `raw_kind`) so that
    `train_epoch_stage1` can refuse an epoch that asks for another."""
    from spn4cir_tpu_torch.train.stage1 import stage1_loss_fn

    group = mesh.group(AXIS_DATA)
    n = mesh.size(AXIS_DATA)

    def gather(x: torch.Tensor) -> torch.Tensor:
        return gather_rows_with_grad(x, group)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             dropout_generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        rows = batch["text_ids"].shape[0]
        gen = _noise(mesh, dropout_generator, rows).get("generator")
        loss = stage1_loss_fn(backbone, batch, neg_type, gen, raw_kind,
                              gather)
        apply_gradients(state, loss / n, _reduce_over_data(mesh))
        return loss.detach()

    step.neg_type = neg_type
    step.with_dropout = with_dropout
    step.raw_kind = raw_kind
    return step


def make_sharded_gallery_encode(encode: Callable, mesh: Mesh) -> Callable:
    """`encode` (this rank's rows of a batch, and any per-row arguments ->
    a tensor, or a tuple or dict of them) made data-parallel: its outputs
    are gathered over `data` in rank order, so every rank gets the whole
    batch's. The rows come from an iterator cut with `part=mesh.part()`
    (`data.datasets`), which decodes only this rank's rows and yields the
    whole batch's ids. The gallery index (`eval.retrieval.
    extract_index_features`), the bank and the unlabeled pool
    (`cli.train.build_bank`) are encoded so. A model axis needs the towers
    cut first (`parallel.tp.tensor_parallel` / `shard_module_tp`)."""
    if mesh.size(AXIS_DATA) == 1:
        return encode
    group = mesh.group(AXIS_DATA)

    def gather(out):
        if isinstance(out, dict):
            return {k: gather(v) for k, v in out.items()}
        if isinstance(out, (tuple, list)):
            return type(out)(gather(v) for v in out)
        return gather_rows(out.contiguous(), group)

    def sharded(*args):
        return gather(encode(*args))

    return sharded
