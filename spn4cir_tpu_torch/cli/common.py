"""Shared CLI plumbing for the PyTorch port: the argparse surface of
`spn4cir_tpu/cli/common.py` (less `--use_bank`, which no code of either
package reads), plus the device choice, backbone construction, weight
loading and the output directory. A flag whose path is not ported is parsed
and then refused (`refuse_unported`), never ignored."""

from __future__ import annotations

import argparse
import os

import torch

from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.models.api import CIRBackbone, build_backbone


def base_parser(default_model: str = "RN50x4", default_tau: float = 0.02,
                default_lr: float = 2e-5, default_bs: int = 256,
                default_epochs: int = 5) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, required=True, choices=["fiq", "cirr"])
    p.add_argument("--num-epochs", default=default_epochs, type=int)
    p.add_argument("--clip-model-name", default=default_model, type=str)
    p.add_argument("--learning-rate", default=default_lr, type=float)
    p.add_argument("--batch-size", default=default_bs, type=int)
    p.add_argument("--validation-frequency", default=1, type=int)
    p.add_argument("--target-ratio", default=1.25, type=float)
    p.add_argument("--transform", default="targetpad", type=str,
                   choices=["clip", "squarepad", "targetpad"])
    p.add_argument("--output_path", default="")
    p.add_argument("--tau", default=default_tau, type=float)
    p.add_argument("--dress_types", default="dress,shirt,toptee")
    p.add_argument("--grad_ckpt", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--data_path", default="")
    p.add_argument("--model_path", type=str, default="")
    p.add_argument("--reload_bank", action="store_true")
    p.add_argument("--device", default="0",
                   help="N = cuda:N (the default, cuda:0), or cpu")
    p.add_argument("--bank_path", default="")
    p.add_argument("--nni", action="store_true")
    p.add_argument("--plus", action="store_true")
    p.add_argument("--neg_num", type=int, default=-1)
    p.add_argument("--llmcap", action="store_true")
    p.add_argument("--wo_bank", action="store_true")
    p.add_argument("--fiq_val_type", type=int, default=0, choices=[0, 1],
                   help="FIQ gallery: 0=original image_splits list, 1=VAL-set "
                        "images only (ref clip4cir/validate.py:247, "
                        "data_utils.py:300-310)")
    p.add_argument("--val_ret_train", action="store_true",
                   help="val relative mode returns (ref, cap, tgt) image "
                        "triplets for retrieval-on-train analysis (ref "
                        "data_utils.py:276-285)")
    # extensions beyond the reference's flags; the ones whose path is not
    # ported are parsed for parity and refused by the entry points
    p.add_argument("--bf16", action="store_true", help="bfloat16 activations")
    p.add_argument("--text_max_len", type=int, default=0,
                   help="BLIP text token budget (0 = backbone default 35; "
                        "the reference pads to the longest caption — raise "
                        "this if captions exceed 33 WordPiece tokens)")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="train-mode dropout on the BLIP/BLIP-2 MED text side "
                        "(the reference trains with HF BERT dropout 0.1; 0.0 "
                        "matches eval parity)")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="data-axis size (0 = all devices)")
    p.add_argument("--mesh_bank", type=int, default=1, help="bank-axis size")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel axis for gallery/bank indexing "
                        "(Megatron-style tower sharding, parallel/tp.py)")
    p.add_argument("--loss_impl", default="auto",
                   choices=["auto", "pallas", "xla"])
    # ablation flags (ref clip4cir/train_negtype.py / train_negplus.py)
    p.add_argument("--neg_type", type=int, default=0,
                   help="negtype ablation bitmask 1-15 (stage-1 only)")
    p.add_argument("--unlabeled", action="store_true",
                   help="extend the target bank with unlabeled negatives")
    p.add_argument("--use_cc", action="store_true",
                   help="zscir: train on out-of-domain CC triplets")
    p.add_argument("--loader_procs", type=int, default=0,
                   help="decode with N worker PROCESSES x native C++ "
                        "threads (data/mploader.py) for the gallery/bank "
                        "image scans — the production-rate input pipeline "
                        "(0 = in-process thread pool)")
    p.add_argument("--device_preprocess", action="store_true",
                   help="run resize/crop/normalize on the device (not "
                        "ported to PyTorch yet)")
    p.add_argument("--device_canvas", type=int, default=0,
                   help="staging canvas side for --device_preprocess "
                        "(0 = 2x the backbone input dim); images whose "
                        "padded extent exceeds it are host-downscaled first")
    p.add_argument("--profile_dir", default="",
                   help="write a profiler trace of the train loop here")
    p.add_argument("--resume", action="store_true",
                   help="save/restore full training state (orbax); restores "
                        "to the exact epoch+step of the latest checkpoint")
    p.add_argument("--ckpt_every_steps", type=int, default=0,
                   help="with --resume: ALSO checkpoint every N optimizer "
                        "steps (async), so a preemption mid-epoch loses at "
                        "most N steps — matters for live-encode stage-1 "
                        "epochs (0 = epoch boundaries only)")
    p.add_argument("--lr_schedule", default="constant",
                   choices=["constant", "cosine", "linear"])
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--bank_dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="device dtype of the target bank (int8 = per-row "
                        "absmax quantization; logits accumulate f32)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host training (not ported to PyTorch yet)")
    return p


def finalize_args(args) -> None:
    if args.data_path == "":
        args.data_path = ("fashionIQ_dataset" if args.dataset == "fiq"
                          else "cirr_dataset")
    if isinstance(args.dress_types, str):
        args.dress_types = args.dress_types.split(",")
    if args.nni:
        try:
            import nni

            for k, v in (nni.get_next_parameter() or {}).items():
                setattr(args, k.replace("-", "_"), v)
        except ImportError:
            print("[warn] --nni requested but nni is not installed; ignoring")
    print("Arguments:")
    for k, v in sorted(vars(args).items()):
        print("    ", k, ":", v)


def resolve_device(spec: str) -> torch.device:
    """--device: "N" -> cuda:N, "cpu" -> the CPU. A CUDA device that is not
    there raises; nothing falls back to the CPU."""
    if spec == "cpu":
        return torch.device("cpu")
    device = torch.device(f"cuda:{int(spec)}" if spec.isdigit() else spec)
    if device.type != "cuda":
        raise ValueError(f"--device takes N (cuda:N) or cpu, not {spec!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {spec}: CUDA is not available (pass "
                           "--device cpu to run on the CPU)")
    if (device.index or 0) >= torch.cuda.device_count():
        raise RuntimeError(f"--device {spec}: only "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return device


def make_backbone(name: str, args, tokenizer=None) -> CIRBackbone:
    if name not in ("clip", "zs"):
        raise NotImplementedError(f"the {name} backbone is not ported to "
                                  "PyTorch yet")
    refuse_unported(args, [
        ("--grad_ckpt (activation rematerialisation)", args.grad_ckpt),
        ("--dropout (the BLIP/BLIP-2 text side)", args.dropout),
        ("--text_max_len (the BLIP text side)", args.text_max_len),
        ("--val_ret_train (retrieval-on-train analysis)", args.val_ret_train),
    ])
    return build_backbone(
        name, clip_model_name=args.clip_model_name, tau=args.tau,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=resolve_device(args.device), tokenizer=tokenizer)


def make_transform(backbone: CIRBackbone, args) -> ImageTransform:
    """The host preprocess; --device_preprocess is not ported yet."""
    refuse_unported(args, [
        ("--device_preprocess", args.device_preprocess),
        ("--device_canvas (goes with --device_preprocess)",
         args.device_canvas)])
    return ImageTransform(args.transform, backbone.input_dim, args.target_ratio)


def load_or_init_params(backbone: CIRBackbone, args,
                        generator: torch.Generator) -> CIRBackbone:
    """--model_path loads an OpenAI CLIP / clip4cir `.pt` checkpoint (the
    port keeps OpenAI's parameter names); otherwise random weights from
    `generator`. Returns the backbone, its weights filled in place."""
    if not args.model_path:
        backbone.init_params(generator)
        return backbone
    if not args.model_path.endswith((".pt", ".pth")):
        raise NotImplementedError(
            "the PyTorch port loads .pt/.pth checkpoints; convert a JAX "
            "checkpoint with models.convert.clip_state_dict_from_jax and "
            "torch.save")
    from spn4cir_tpu_torch.models.convert import load_clip_checkpoint

    backbone.model.load_state_dict(load_clip_checkpoint(args.model_path))
    return backbone


def refuse_unported(args, flags) -> None:
    """Raise for the first flag of `flags` (pairs of flag text and whether
    it is set) whose path the port does not have yet: nothing that was
    asked for is silently ignored."""
    for flag, is_set in flags:
        if is_set:
            raise NotImplementedError(f"{flag}: not yet ported to PyTorch")


def resolve_output_path(args, backbone_name: str) -> str:
    if args.debug:
        out = os.path.join("models", "debug")
    elif args.output_path:
        out = args.output_path
    else:
        import datetime

        stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
        out = os.path.join("models", f"{args.dataset}_{backbone_name}_{stamp}")
    os.makedirs(out, exist_ok=True)
    return out
