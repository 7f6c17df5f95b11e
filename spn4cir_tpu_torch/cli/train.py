"""Training CLI of the PyTorch port: stage 2 ("scaling negatives") of
clip4cir, zscir, tgcir, blip4cir and blip24cir, and stage 1 (`--wo_bank`)
of clip4cir, zscir and blip4cir, on one CUDA device.

Counterpart of the single-device branches of `spn4cir_tpu/cli/train.py`.
Stage 2: build the dataset, run the frozen image tower once over the unique
train images into a `Bank` (cached `.npz`), then per step gather refer rows
on the host, tokenize, run the text side, the full-bank InfoNCE and masked
AdamW. Stage 1 (`--wo_bank`): no bank; every step decodes both images of
its triplets, runs them through the live image tower and trains every
weight with the in-batch InfoNCE (or, with `--neg_type`, the
negative-type ablation's losses). Either way: validate every
`--validation-frequency` epochs and keep the best checkpoint.

    python -m spn4cir_tpu_torch.cli.train --dataset cirr \\
        --data_path cirr_dataset --clip-model-name RN50x4 --bf16 \\
        --bank_dtype int8
    python -m spn4cir_tpu_torch.cli.train tgcir --dataset cirr \\
        --data_path cirr_dataset --bf16
    python -m spn4cir_tpu_torch.cli.train zs --dataset cirr \\
        --data_path cirr_dataset --bf16 --wo_bank
    python -m spn4cir_tpu_torch.cli.train blip --dataset cirr \\
        --data_path cirr_dataset --bf16 --dropout 0.1
    python -m spn4cir_tpu_torch.cli.train blip2 --dataset cirr \\
        --data_path cirr_dataset --bf16

An optional first word, `clip` (the default), `zs`, `tgcir`, `blip` or
`blip2`, picks the backbone and its recipe defaults (zs: ViT-L/14, tau
0.01, learning rate 2e-6, batch 48, 10 epochs, the generated triplets in
place of the human ones; tgcir: ViT-B/16, tau 0.02, learning rate 2e-5,
batch 256, 5 epochs; blip: tau 0.03, learning rate 5e-6, batch 128, 10
epochs, BLIP base unless `--clip-model-name large`; blip2: tau 0.05,
learning rate 1e-5, batch 32, 3 epochs, EVA ViT-g + Q-Former unless
`--clip-model-name test-tiny`). The `train_negtype`, `train_negplus`,
`train_zs` and `train_zs_bank` modules of this package are the ablation
and zscir recipes on top of this one. blip and blip2 need the BERT
vocabulary: `SPN4CIR_BERT_VOCAB` names `bert-base-uncased/vocab.txt`.
tgcir's refer bank holds each image's (12, 512) token set on the host.
blip2's bank is caption-aware: its refer rows are the fused query states
of each (reference image, caption) pair, keyed by triplet (by image under
`--plus`), and its target rows the (32, 256) query features of each image.
tgcir and blip2 have no stage 1, so `--wo_bank` raises for them.
`--grad_ckpt` rematerialises the ViT blocks (and CLIP's transformer blocks)
in the backward; `--dropout` is MED's train-mode dropout.

`--neg_type` (a 4-bit mask: bit0 refer, bit1 text, bit2 target, bit3 query
negatives) goes with `--wo_bank` and a CLIP backbone (clip, zs); the JAX
CLI ignores it in stage 2, the port refuses it there. `--use_cc` reads the
CC triplets with `--plus` (or for zs, in place of its generated ones).

`--bank_dtype int8` quantizes the target bank (per-row absmax) after it is
extracted and extended, and the loss runs through the int8 kernels; it
needs the full-bank loss, so with sampled negatives (`--neg_num` without
`--unlabeled`) it exits. `--unlabeled` appends the features of the
unlabeled image pool to the target bank as extra negatives (`--neg_num`
then keeps only the first `neg_num` of them), cached beside the bank as
`<bank>_unlabeled.npz`.

`--resume` keeps the full training state under `<output>/resume/` (the
trainable parameters, the optimizer state, the global step and the dropout
generator's state; `utils.checkpoint.CheckpointManager`) at every epoch's
end, and with `--ckpt_every_steps N` every N optimizer steps too; a run
started again with the same flags goes on from the newest one, at its
epoch and step (`divmod(global_step, steps_per_epoch)`: the epoch's
shuffle, captions and negatives are functions of the seed, the epoch and
the step, so the skipped batches are the ones already taken). A directory
without the `format.json` marker of that layout is refused. `--profile_dir`
writes a `torch.profiler` trace of the epoch loop there.

`--loader_procs N` decodes the bank, unlabeled-pool and stage-1 images on N
worker processes (`data/mploader.py`). `--device_preprocess` stages uint8
canvases on the host (`--device_canvas`, default twice the input size) and
runs resize/crop/normalize on the device: the bank and unlabeled-pool
encoders absorb it (`ops.preprocess.absorb_raw`), the validation index runs
it ahead of its encoder, and stage 1 inside each step.

Several GPUs (`parallel/`): one process per GPU, launched by torchrun or
the `SPN4CIR_DIST_*` variables, with `--distributed` or a `--mesh_*` > 1.
Stage 2 splits the batch over `--mesh_data` and the bank's rows over
`--mesh_bank` (the bank-sharded InfoNCE); stage 1 splits the batch over
`--mesh_data`; `--mesh_model` slices the towers Megatron-style, for bank
extraction, training and validation alike. Parameters start from rank 0's;
rank 0 alone writes the bank cache, checkpoints and JSON. Refused under a
mesh, as in the JAX CLI: `--neg_num` (the sharded loss is full-bank) and
`--mesh_bank` with `--wo_bank`; and `--resume` with `--mesh_model` > 1
(the tensor-parallel training state is not checkpointed).

    torchrun --nproc_per_node 8 -m spn4cir_tpu_torch.cli.train \
        --dataset cirr --data_path cirr_dataset --mesh_bank 2 --bf16

Runs on cuda:0 unless --device says otherwise (`--device cpu` for the CPU;
under torchrun cuda:LOCAL_RANK).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from spn4cir_tpu_torch.bank.bank import (Bank, extend_target_bank,
                                         extract_banks, extract_fusion_banks,
                                         extract_unlabeled_features)
from spn4cir_tpu_torch.cli.common import (
    BLIP4CIR_DEFAULTS,
    BLIP24CIR_DEFAULTS,
    CLIP4CIR_DEFAULTS,
    TGCIR_DEFAULTS,
    ZSCIR_DEFAULTS,
    backbone_from_argv,
    base_parser,
    finalize_args,
    load_or_init_params,
    make_backbone,
    make_cli_mesh,
    make_transform,
    recipe_defaults,
    refuse_unported,
    resolve_output_path,
    setup_distributed,
    uses_mesh,
)
from spn4cir_tpu_torch.data.datasets import (
    CIRDataset,
    iter_train_bank,
    iter_train_images,
    iter_unique_images,
    iter_unlabeled,
)
from spn4cir_tpu_torch.eval.metrics import fiq_average
from spn4cir_tpu_torch.eval.retrieval import (cirr_val_retrieval,
                                              fiq_val_retrieval)
from spn4cir_tpu_torch.models.api import backbone_class
from spn4cir_tpu_torch.ops.bank_kernels import quantize_bank
from spn4cir_tpu_torch.ops.preprocess import absorb_raw
from spn4cir_tpu_torch.parallel.mesh import (AXIS_BANK, AXIS_DATA, AXIS_MODEL,
                                             bank_shard, broadcast_module,
                                             broadcast_str, process_is_main)
from spn4cir_tpu_torch.parallel.tp import full_state_dict, shard_module_tp
from spn4cir_tpu_torch.parallel.train import (make_sharded_gallery_encode,
                                              make_sharded_stage1_step,
                                              make_sharded_stage2_step)
from spn4cir_tpu_torch.train.stage1 import (create_stage1_state,
                                            train_epoch_stage1)
from spn4cir_tpu_torch.train.stage2 import (create_train_state,
                                            make_lr_schedule, train_epoch)
from spn4cir_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                load_train_state, save_model,
                                                train_state)
from spn4cir_tpu_torch.utils.logging import MetricLogger, profiler_trace
from spn4cir_tpu_torch.utils.seeding import seed_everything

__all__ = ["BLIP4CIR_DEFAULTS", "BLIP24CIR_DEFAULTS", "CLIP4CIR_DEFAULTS",
           "TGCIR_DEFAULTS", "ZSCIR_DEFAULTS", "run_validation", "train_main"]


def run_validation(backbone, args, preprocess, mesh=None
                   ) -> tuple[float, dict]:
    """Per-epoch validation; score definitions mirror
    clip4cir/train.py:134-195. With `mesh`, every rank runs it and the
    gallery encode splits over the mesh (`extract_index_features`)."""
    backbone.eval()
    if args.dataset == "cirr":
        m = cirr_val_retrieval(backbone, args.data_path, preprocess,
                               batch_size=32, mesh=mesh)
        return m["arithmetic_mean"], m
    per_type = []
    results = {}
    for dt in args.dress_types:
        m = fiq_val_retrieval(backbone, args.data_path, dt, preprocess,
                              batch_size=32, fiq_val_type=args.fiq_val_type,
                              mesh=mesh)
        per_type.append(m)
        results[dt] = m
    avg = fiq_average(per_type)
    results.update(avg)
    return avg["mean_recall"], results


def build_bank(backbone, args, train_ds, preprocess, output_path, device,
               write: bool = True, mesh=None) -> Bank:
    """The stage-2 bank: one frozen-tower pass over the unique train images
    (cached; blip2: over the train triplets, caption-aware), the unlabeled
    pool appended under `--unlabeled`, the target cast or quantized per
    `--bank_dtype`. Under `--device_preprocess` each encoder runs the
    device preprocess on the staged canvases first. A rank that must not
    `write` reads a cache that exists and otherwise extracts without
    saving (every rank of a tensor-parallel tower runs the pass). With
    `mesh` each rank decodes and encodes its rows of every batch over the
    data axis and the features are gathered back
    (`make_sharded_gallery_encode`): every rank holds the whole bank."""

    def cache(path):
        """The cache argument of this rank: every rank reads one that
        exists; only a writer saves a new one."""
        fresh = args.reload_bank or not os.path.exists(Bank.cache_file(path))
        return path if write or not fresh else None

    part = mesh.part() if mesh is not None else None

    def absorb(fn):
        if args.device_preprocess:
            fn = absorb_raw(fn, backbone.input_dim, args.transform)
        return fn if mesh is None else make_sharded_gallery_encode(fn, mesh)

    # --- bank extraction (cached) ---
    bank_path = args.bank_path or os.path.join(
        output_path, f"{args.dataset}_bank.npz")
    backbone.eval()
    if backbone.caption_aware_bank:
        # the refer entries are caption-dependent fusion states
        bank = extract_fusion_banks(
            absorb(backbone.fusion_bank_features),
            iter_train_images(train_ds, args.batch_size, part=part),
            len(train_ds.triplets), train_ds.num_unique_images,
            backbone.tokenize, cache_path=cache(bank_path),
            reload=args.reload_bank, by_image=args.plus, device=device)
    else:
        bank = extract_banks(
            absorb(backbone.bank_features),
            iter_unique_images(train_ds, args.batch_size, part=part),
            train_ds.num_unique_images,
            cache_path=cache(bank_path),
            reload=args.reload_bank,
            device=device,
        )
    if args.unlabeled:
        unlabeled_ds = CIRDataset(args.dataset, "train", "unlabeled",
                                  preprocess, args.data_path,
                                  args.dress_types,
                                  extend_suffix=backbone.extend_suffix)
        # from the RESOLVED cache name: with an extensionless --bank_path
        # the replace would do nothing and both caches would be one file
        unlabeled_cache = Bank.cache_file(bank_path).replace(
            ".npz", "_unlabeled.npz")
        extra = extract_unlabeled_features(
            absorb(backbone.gallery_features),
            iter_unlabeled(unlabeled_ds, args.batch_size, part=part),
            len(unlabeled_ds.unlabeled_imagepaths),
            cache_path=cache(unlabeled_cache), reload=args.reload_bank,
            device=device)
        bank = extend_target_bank(bank, extra,
                                  args.neg_num if args.neg_num > 0 else 0)
    if args.bank_dtype == "bfloat16":
        bank = Bank(refer=bank.refer, target=bank.target.to(torch.bfloat16),
                    refer_key=bank.refer_key)
    elif args.bank_dtype == "int8":
        if args.neg_num > 0 and not args.unlabeled:
            raise SystemExit("--bank_dtype int8 needs the full-bank loss"
                             " (no sampled negatives)")
        bank = Bank(refer=bank.refer, target=quantize_bank(bank.target),
                    refer_key=bank.refer_key)
    if write:
        print(f"bank: {bank.num_images} images, refer {bank.refer.shape}, "
              f"target {tuple(bank.target.shape)} {bank.target.dtype} -> "
              f"{bank_path}")
    return bank


def _to_cpu(target):
    """A bank target (a tensor or a QuantBank) on the host."""
    if isinstance(target, torch.Tensor):
        return target.cpu()
    return type(target)(*(t.cpu() for t in target))


def resume_manager(output_path: str, steps_per_epoch: int
                   ) -> CheckpointManager:
    """The `--resume` manager over `<output>/resume/`, its checkpoints keyed
    by global step (epoch * steps_per_epoch + step in the epoch). A
    directory that holds checkpoints but not the `format.json` marker of
    that layout is refused: resuming it would start at the wrong
    position."""
    resume_dir = os.path.join(output_path, "resume")
    mgr = CheckpointManager(resume_dir)
    marker = os.path.join(resume_dir, "format.json")
    if mgr.latest_step() is not None and not os.path.exists(marker):
        raise SystemExit(
            f"{resume_dir} holds checkpoints without the global-step "
            "marker format.json; delete the directory (or finish that run "
            "with the code that wrote it): resuming would restart at the "
            "wrong position")
    if not os.path.exists(marker):
        with open(marker, "w") as f:
            json.dump({"keys": "global_step",
                       "steps_per_epoch": steps_per_epoch}, f)
    return mgr


def train_main(backbone_name: str = "clip", argv: Optional[list] = None,
               tokenizer=None, log_every: int = 50, **parser_kw):
    """Parse `argv` and train; returns the best validation score.
    `tokenizer` overrides the tokenizer the backbone would load; the parser
    defaults are the backbone's recipe unless `parser_kw` gives others."""
    args = base_parser(**(parser_kw or recipe_defaults(backbone_name))
                       ).parse_args(argv)
    finalize_args(args)
    if args.wo_bank:
        # stage 1 builds no bank: a flag that shapes one has nothing to act on
        for flag, is_set in (
                ("--bank_dtype " + args.bank_dtype,
                 args.bank_dtype != "float32"),
                ("--bank_path", args.bank_path),
                ("--reload_bank", args.reload_bank),
                ("--neg_num", args.neg_num > 0),
                ("--unlabeled", args.unlabeled)):
            if is_set:
                raise SystemExit(f"--wo_bank (stage-1) has no bank: {flag} "
                                 "goes with stage-2 training only")
    # what the backbone can do is stated on its class
    cls = backbone_class(backbone_name)
    refuse_unported(args, [
        ("--neg_type without --wo_bank (the negtype losses are stage-1 "
         "losses; the JAX CLI ignores the flag in stage 2)",
         args.neg_type and not args.wo_bank),
        (f"--neg_type with {backbone_name} (its JAX backbone has no negtype "
         "loss)", args.neg_type and not hasattr(cls, "stage1_negtype_loss")),
        ("--use_cc without --plus (only the extended train set of --plus, "
         "or zs's generated one, takes the CC triplets)",
         args.use_cc and not args.plus and not cls.replace_extended),
        (f"--unlabeled with {backbone_name} (its gallery features are not "
         "target-bank rows)",
         args.unlabeled and not cls.gallery_extends_target_bank),
        ("--loss_impl pallas/xla (one route per device here)",
         args.loss_impl != "auto"),
    ])
    on_mesh = uses_mesh(args)
    if on_mesh and args.wo_bank and args.mesh_bank > 1:
        raise SystemExit("--wo_bank (stage-1) has no bank axis; shard with "
                         "--mesh_data / --mesh_model")
    if on_mesh and not args.wo_bank and args.neg_num > 0 and \
            not args.unlabeled:
        raise SystemExit("--neg_num (sampled negatives) is not supported "
                         "with a mesh; the sharded loss is full-bank")
    if on_mesh and args.resume and args.mesh_model > 1:
        raise SystemExit("--resume with --mesh_model > 1: the "
                         "tensor-parallel training state is not "
                         "checkpointed")
    if args.ckpt_every_steps and not args.resume:
        raise SystemExit("--ckpt_every_steps goes with --resume (the step "
                         "checkpoints are resume state)")
    if args.neg_type and not 0 < args.neg_type < 16:
        raise SystemExit("--neg_type is a 4-bit mask, 1-15 (bit0 refer, "
                         "bit1 text, bit2 target, bit3 query)")
    if args.wo_bank and not cls.has_stage1:
        raise NotImplementedError(
            f"--wo_bank with {backbone_name}: the JAX package's "
            f"{backbone_name} backbone has no stage-1 loss, so there is none "
            "to port yet")
    setup_distributed(args)
    generator = seed_everything(args.seed)

    backbone = make_backbone(backbone_name, args, tokenizer=tokenizer)
    preprocess = make_transform(backbone, args)
    load_or_init_params(backbone, args, generator)
    device = backbone.device
    mesh = None
    if on_mesh:
        mesh = make_cli_mesh(args, device)
        if args.batch_size % mesh.size(AXIS_DATA):
            raise SystemExit(f"--batch-size {args.batch_size} does not split "
                             f"over --mesh_data {mesh.size(AXIS_DATA)}")
        broadcast_module(backbone)
        if mesh.size(AXIS_MODEL) > 1:
            shard_module_tp(backbone, mesh)
        if process_is_main():
            print(f"mesh: data={mesh.size(AXIS_DATA)} "
                  f"bank={mesh.size(AXIS_BANK)} "
                  f"model={mesh.size(AXIS_MODEL)}")
    main = process_is_main()
    output_path = broadcast_str(resolve_output_path(args, backbone_name)
                                if main else "")
    os.makedirs(output_path, exist_ok=True)
    logger = MetricLogger(prefix=f"{backbone_name}-train")

    train_ds = CIRDataset(args.dataset, "train", "relative", preprocess,
                          args.data_path, args.dress_types, plus=args.plus,
                          llmcap=args.llmcap, use_cc=args.use_cc,
                          extend_suffix=backbone.extend_suffix, seed=args.seed,
                          replace_extended=backbone.replace_extended)

    bank = shard = sharded_step = None
    if not args.wo_bank:
        bank = build_bank(backbone, args, train_ds, preprocess, output_path,
                          device, write=main, mesh=mesh)
        if mesh is not None:
            # the whole target goes back to the host and only this rank's
            # shard stays on its device
            bank = Bank(refer=bank.refer, target=_to_cpu(bank.target),
                        refer_key=bank.refer_key)
            shard, _ = bank_shard(bank.target, mesh)
            sharded_step = make_sharded_stage2_step(
                backbone, mesh, m_actual=int(bank.target.shape[0]))
    elif mesh is not None:
        sharded_step = make_sharded_stage1_step(
            backbone, mesh, with_dropout=bool(args.dropout),
            neg_type=args.neg_type,
            raw_kind=args.transform if args.device_preprocess else None)

    steps_per_epoch = max(len(train_ds.triplets) // args.batch_size, 1)
    if args.lr_schedule != "constant":
        lr = make_lr_schedule(args.lr_schedule, args.learning_rate,
                              steps_per_epoch, args.num_epochs,
                              args.warmup_steps)
    else:
        lr = args.learning_rate
    best_score = 0.0
    neg_num = (args.neg_num if (args.neg_num > 0 and not args.unlabeled)
               else None)

    state = (create_stage1_state(backbone, lr) if args.wo_bank
             else create_train_state(backbone, lr))

    # --- preemption resume: checkpoints keyed by global step ---
    ckpt, start_epoch, start_step, saved_rng = None, 0, 0, None
    if args.resume:
        ckpt = resume_manager(output_path, steps_per_epoch)
        saved, global_step = ckpt.restore(None)
        if saved is not None:
            load_train_state(saved, backbone, state)
            saved_rng = saved["dropout_rng"]
        start_epoch, start_step = divmod(global_step, steps_per_epoch)
        if global_step:
            print(f"resumed from epoch {start_epoch} step {start_step}")

    def step_hook(epoch, drop):
        """Save every --ckpt_every_steps optimizer steps inside the epoch
        (its end is saved after the validation)."""
        if ckpt is None or not args.ckpt_every_steps:
            return None

        def hook(step_in_epoch, st):
            gs = epoch * steps_per_epoch + step_in_epoch
            if gs % args.ckpt_every_steps == 0 and \
                    step_in_epoch < steps_per_epoch and main:
                ckpt.save(gs, train_state(backbone, st, drop))
        return hook

    with profiler_trace(args.profile_dir):
        for epoch in range(start_epoch, args.num_epochs):
            ep_start = start_step if epoch == start_epoch else 0
            # train() makes MED's dropout live (blip with --dropout); the
            # CLIP towers have none, and BatchNorm runs on its stored
            # statistics in either mode
            backbone.train()
            drop = None
            if args.dropout:  # only a backbone with dropout gets past it
                drop = torch.Generator(device=device).manual_seed(
                    args.seed * 1000 + epoch)
                if ep_start and saved_rng is not None:
                    drop.set_state(saved_rng)   # mid-epoch: replay its noise
            log_fn = ((lambda step, loss: logger.log(step, epoch=epoch,
                                                     loss=loss)) if main
                      else (lambda step, loss: None))
            if args.wo_bank:
                state, mean_loss = train_epoch_stage1(
                    backbone, state,
                    iter_train_images(train_ds, args.batch_size, shuffle=True,
                                      epoch_seed=args.seed + epoch,
                                      start_step=ep_start,
                                      part=(mesh.part() if mesh is not None
                                            else None)),
                    neg_type=args.neg_type, dropout_generator=drop,
                    log_every=log_every, log_fn=log_fn, start_step=ep_start,
                    step_hook=step_hook(epoch, drop),
                    raw_kind=(args.transform if args.device_preprocess
                              else None), sharded_step=sharded_step)
            else:
                state, mean_loss = train_epoch(
                    backbone, state, bank,
                    iter_train_bank(train_ds, args.batch_size,
                                    epoch_seed=args.seed + epoch,
                                    start_step=ep_start),
                    neg_num=neg_num, neg_seed=args.seed * 1000 + epoch,
                    log_every=log_every, log_fn=log_fn,
                    dropout_generator=drop, start_step=ep_start,
                    step_hook=step_hook(epoch, drop),
                    sharded_step=sharded_step, mesh=mesh, bank_shard=shard)
            if main:
                print(f"epoch {epoch}: mean loss {mean_loss:.4f}")

            if (epoch + 1) % args.validation_frequency == 0:
                score, results = run_validation(backbone, args, preprocess,
                                                mesh)
                if main:
                    print(json.dumps({"epoch": epoch, "score": score, **{
                        k: v for k, v in results.items()
                        if isinstance(v, float)}}))
                if args.nni and main:  # HPO reporting (ref :157,188)
                    try:
                        import nni

                        nni.report_intermediate_result(score)
                    except ImportError:
                        pass
                if score > best_score:
                    best_score = score
                    # a tensor-parallel model is gathered by every rank
                    weights = (full_state_dict(backbone.model, mesh)
                               if mesh is not None
                               and mesh.size(AXIS_MODEL) > 1 else None)
                    if main:
                        save_model(os.path.join(output_path, "best.pt"),
                                   backbone.model, epoch=epoch,
                                   extra={"score": score,
                                          "dataset": args.dataset},
                                   state_dict=weights)
                        print(f"saved best (score {score:.2f})")
            if ckpt is not None and main:
                ckpt.save((epoch + 1) * steps_per_epoch,
                          train_state(backbone, state, drop))
        if ckpt is not None:
            ckpt.wait()
    if args.nni and main:  # (ref clip4cir/train.py:196-197)
        try:
            import nni

            nni.report_final_result(best_score)
        except ImportError:
            pass
    if main:
        print(f"best score: {best_score:.2f}")
    return best_score


if __name__ == "__main__":
    import sys

    train_main(*backbone_from_argv(sys.argv[1:]))
