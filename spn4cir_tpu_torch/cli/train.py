"""Training CLI of the PyTorch port: clip4cir stage-2 ("scaling negatives")
on one CUDA device.

Counterpart of the single-device clip stage-2 branch of
`spn4cir_tpu/cli/train.py`: build the dataset, run the frozen image tower
once over the unique train images into a `Bank` (cached `.npz`), then per
step gather refer rows on the host, tokenize, run the text tower, the
full-bank InfoNCE and masked AdamW; validate every
`--validation-frequency` epochs and keep the best checkpoint.

    python -m spn4cir_tpu_torch.cli.train --dataset cirr \\
        --data_path cirr_dataset --clip-model-name RN50x4 --bf16 \\
        --bank_dtype int8

`--bank_dtype int8` quantizes the target bank (per-row absmax) after it is
extracted and extended, and the loss runs through the int8 kernels; it
needs the full-bank loss, so with sampled negatives (`--neg_num` without
`--unlabeled`) it exits. `--unlabeled` appends the features of the
unlabeled image pool to the target bank as extra negatives (`--neg_num`
then keeps only the first `neg_num` of them), cached beside the bank as
`<bank>_unlabeled.npz`.

Runs on cuda:0 unless --device says otherwise (`--device cpu` for the CPU).
Flags whose path is not ported raise "not yet ported": stage-1 training
(--wo_bank, --neg_type), --use_cc, meshes, --distributed,
--device_preprocess, --loader_procs, --resume / --ckpt_every_steps,
--grad_ckpt and --profile_dir.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from spn4cir_tpu_torch.bank.bank import (Bank, extend_target_bank,
                                         extract_banks,
                                         extract_unlabeled_features)
from spn4cir_tpu_torch.cli.common import (
    base_parser,
    finalize_args,
    load_or_init_params,
    make_backbone,
    make_transform,
    refuse_unported,
    resolve_output_path,
)
from spn4cir_tpu_torch.data.datasets import (
    CIRDataset,
    iter_train_bank,
    iter_unique_images,
    iter_unlabeled,
)
from spn4cir_tpu_torch.eval.metrics import fiq_average
from spn4cir_tpu_torch.eval.retrieval import (cirr_val_retrieval,
                                              fiq_val_retrieval)
from spn4cir_tpu_torch.ops.bank_kernels import quantize_bank
from spn4cir_tpu_torch.train.stage2 import (create_train_state,
                                            make_lr_schedule, train_epoch)
from spn4cir_tpu_torch.utils.checkpoint import save_model
from spn4cir_tpu_torch.utils.logging import MetricLogger
from spn4cir_tpu_torch.utils.seeding import seed_everything

CLIP4CIR_DEFAULTS = dict(default_model="RN50x4", default_tau=0.02,
                         default_lr=2e-05, default_bs=256, default_epochs=3)


def run_validation(backbone, args, preprocess) -> tuple[float, dict]:
    """Per-epoch validation; score definitions mirror
    clip4cir/train.py:134-195."""
    backbone.eval()
    if args.dataset == "cirr":
        m = cirr_val_retrieval(backbone, args.data_path, preprocess,
                               batch_size=32)
        return m["arithmetic_mean"], m
    per_type = []
    results = {}
    for dt in args.dress_types:
        m = fiq_val_retrieval(backbone, args.data_path, dt, preprocess,
                              batch_size=32, fiq_val_type=args.fiq_val_type)
        per_type.append(m)
        results[dt] = m
    avg = fiq_average(per_type)
    results.update(avg)
    return avg["mean_recall"], results


def train_main(backbone_name: str = "clip", argv: Optional[list] = None,
               tokenizer=None, log_every: int = 50, **parser_kw):
    """Parse `argv` and train; returns the best validation score.
    `tokenizer` overrides the CLIP tokenizer the backbone would load."""
    args = base_parser(**(parser_kw or CLIP4CIR_DEFAULTS)).parse_args(argv)
    finalize_args(args)
    refuse_unported(args, [
        ("--wo_bank (stage-1 training)", args.wo_bank),
        ("--neg_type (stage-1 ablation)", args.neg_type),
        ("--use_cc", args.use_cc),
        ("--mesh_data/--mesh_bank/--mesh_model > 1",
         args.mesh_data > 1 or args.mesh_bank > 1 or args.mesh_model > 1),
        ("--distributed", args.distributed),
        ("--loader_procs (multi-process image loader)", args.loader_procs),
        ("--resume / --ckpt_every_steps (full training-state checkpoints)",
         args.resume or args.ckpt_every_steps),
        ("--profile_dir", args.profile_dir),
        ("--loss_impl pallas/xla (one route per device here)",
         args.loss_impl != "auto"),
    ])
    generator = seed_everything(args.seed)

    backbone = make_backbone(backbone_name, args, tokenizer=tokenizer)
    preprocess = make_transform(backbone, args)
    load_or_init_params(backbone, args, generator)
    device = backbone.device
    output_path = resolve_output_path(args, backbone_name)
    logger = MetricLogger(prefix=f"{backbone_name}-train")

    train_ds = CIRDataset(args.dataset, "train", "relative", preprocess,
                          args.data_path, args.dress_types, plus=args.plus,
                          llmcap=args.llmcap, use_cc=args.use_cc,
                          extend_suffix=backbone.extend_suffix, seed=args.seed,
                          replace_extended=backbone.replace_extended)

    # --- bank extraction (cached) ---
    bank_path = args.bank_path or os.path.join(
        output_path, f"{args.dataset}_bank.npz")
    backbone.eval()
    bank = extract_banks(
        backbone.bank_features,
        iter_unique_images(train_ds, args.batch_size),
        train_ds.num_unique_images,
        cache_path=bank_path,
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
            backbone.gallery_features,
            iter_unlabeled(unlabeled_ds, args.batch_size),
            len(unlabeled_ds.unlabeled_imagepaths),
            cache_path=unlabeled_cache, reload=args.reload_bank,
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
    print(f"bank: {bank.num_images} images, refer {bank.refer.shape}, "
          f"target {tuple(bank.target.shape)} {bank.target.dtype} -> "
          f"{bank_path}")

    if args.lr_schedule != "constant":
        steps_per_epoch = max(len(train_ds.triplets) // args.batch_size, 1)
        lr = make_lr_schedule(args.lr_schedule, args.learning_rate,
                              steps_per_epoch, args.num_epochs,
                              args.warmup_steps)
    else:
        lr = args.learning_rate
    best_score = 0.0
    neg_num = (args.neg_num if (args.neg_num > 0 and not args.unlabeled)
               else None)

    state = create_train_state(backbone, lr)

    for epoch in range(args.num_epochs):
        # the text side trains without dropout (the CLIP towers have none),
        # so train() and eval() compute the same function
        backbone.train()
        state, mean_loss = train_epoch(
            backbone, state, bank,
            iter_train_bank(train_ds, args.batch_size,
                            epoch_seed=args.seed + epoch),
            neg_num=neg_num, neg_seed=args.seed * 1000 + epoch,
            log_every=log_every,
            log_fn=lambda step, loss: logger.log(step, epoch=epoch, loss=loss))
        print(f"epoch {epoch}: mean loss {mean_loss:.4f}")

        if (epoch + 1) % args.validation_frequency == 0:
            score, results = run_validation(backbone, args, preprocess)
            print(json.dumps({"epoch": epoch, "score": score, **{
                k: v for k, v in results.items() if isinstance(v, float)}}))
            if args.nni:  # HPO reporting (ref clip4cir/train.py:157,188)
                try:
                    import nni

                    nni.report_intermediate_result(score)
                except ImportError:
                    pass
            if score > best_score:
                best_score = score
                save_model(os.path.join(output_path, "best.pt"),
                           backbone.model, epoch=epoch,
                           extra={"score": score, "dataset": args.dataset})
                print(f"saved best (score {score:.2f})")
    if args.nni:  # (ref clip4cir/train.py:196-197)
        try:
            import nni

            nni.report_final_result(best_score)
        except ImportError:
            pass
    print(f"best score: {best_score:.2f}")
    return best_score


if __name__ == "__main__":
    train_main("clip", None, **CLIP4CIR_DEFAULTS)
