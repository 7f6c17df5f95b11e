"""Shared CLI plumbing for the PyTorch port: the argparse surface of
`spn4cir_tpu/cli/common.py` (less `--use_bank`, which no code of either
package reads), plus the device choice, backbone construction, weight
loading and the output directory. A flag whose path is not ported is parsed
and then refused (`refuse_unported`), never ignored."""

from __future__ import annotations

import argparse
import os

import torch

from spn4cir_tpu_torch.data.transforms import ImageTransform, RawStageTransform
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
                   help="N = cuda:N (the default, cuda:0; under torchrun "
                        "cuda:LOCAL_RANK), or cpu")
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
                   help="data-axis size (0 = the ranks left after bank x "
                        "model); a mesh > 1 runs one process per GPU, "
                        "launched by torchrun or the SPN4CIR_DIST_* "
                        "variables")
    p.add_argument("--mesh_bank", type=int, default=1,
                   help="bank-axis size (the stage-2 bank's rows split over "
                        "ranks; serve: gallery shards over cuda:0..N-1)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel axis: Megatron slices of the "
                        "towers (parallel/tp.py) for training and indexing")
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
                   help="the host only decodes and stages uint8 canvases; "
                        "resize/crop/normalize run on the device ahead of "
                        "the encoder (ops/preprocess.py)")
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
                   help="join the process group of a multi-process launch "
                        "(torchrun, or SPN4CIR_DIST_COORDINATOR / "
                        "SPN4CIR_DIST_NPROCS / SPN4CIR_DIST_PROC_ID); "
                        "SPN4CIR_DIST_BACKEND overrides nccl/gloo")
    return p


def uses_mesh(args, bank: bool = True) -> bool:
    """The flags ask for a process group: --distributed, or a --mesh_* > 1
    (with `bank=False`, --mesh_bank does not count: the sharded service
    holds its bank shards in one process)."""
    return (args.mesh_data > 1 or args.mesh_model > 1 or args.distributed
            or (bank and args.mesh_bank > 1))


def launch_size() -> int:
    """The process count of the launch (SPN4CIR_DIST_NPROCS, else
    torchrun's WORLD_SIZE), 0 when the process was started alone."""
    env = os.environ
    return int(env.get("SPN4CIR_DIST_NPROCS") or env.get("WORLD_SIZE") or 0)


def setup_distributed(args, bank: bool = True) -> bool:
    """Join the process group when --distributed or a --mesh_* > 1 asks for
    one (`parallel.mesh.initialize_distributed`); returns True inside one.
    A process started alone is refused: a mesh runs one process per GPU,
    launched by torchrun or the SPN4CIR_DIST_* variables. Each rank runs on
    --device, except that under torchrun the default cuda:0 becomes
    cuda:LOCAL_RANK; `args.device` is set to the rank's."""
    from spn4cir_tpu_torch.parallel.mesh import (initialize_distributed,
                                                 rank, world_size)

    if not uses_mesh(args, bank):
        return False
    nprocs = _need_launch()
    if args.device == "0" and os.environ.get("LOCAL_RANK"):
        args.device = os.environ["LOCAL_RANK"]
    device = resolve_device(args.device)
    on = initialize_distributed(num_processes=nprocs, device=device)
    print(f"distributed: rank {rank()} of {world_size()} on {device}")
    return on


def _need_launch() -> int:
    nprocs = launch_size()
    if not nprocs:
        raise SystemExit(
            "--distributed / --mesh_* > 1 need a multi-process launch, one "
            "process per GPU: torchrun, or SPN4CIR_DIST_COORDINATOR, "
            "SPN4CIR_DIST_NPROCS and SPN4CIR_DIST_PROC_ID")
    return nprocs


def setup_model_mesh(args):
    """--mesh_model N of the datagen CLIs (captioner, serve_mllm,
    get_cir_data): N ranks, one process per GPU, each holding its
    tensor-parallel slice of the model (`parallel.tp`); returns the (1, 1,
    N) mesh, or None for N <= 1. Rank 0 alone writes and serves."""
    if args.mesh_model <= 1:
        return None
    from spn4cir_tpu_torch.parallel.mesh import initialize_distributed
    from spn4cir_tpu_torch.parallel.tp import make_model_mesh

    nprocs = _need_launch()
    if args.device == "0" and os.environ.get("LOCAL_RANK"):
        args.device = os.environ["LOCAL_RANK"]
    device = resolve_device(args.device)
    initialize_distributed(num_processes=nprocs, device=device)
    return make_model_mesh(args.mesh_model, device)


def encode_mesh(args, device, bank: bool = True):
    """The indexing mesh of validate / submission / validate_case / serve:
    --mesh_data x --mesh_model over the ranks (bank 1), or None for one
    process (call `setup_distributed` with the same `bank` first)."""
    if not uses_mesh(args, bank):
        return None
    return make_cli_mesh(args, device, bank=1)


def make_cli_mesh(args, device, bank: int = None):
    """The (data, bank, model) mesh of --mesh_data / --mesh_bank /
    --mesh_model over the world (`bank` overrides --mesh_bank); across
    hosts the data axis spans them (`make_hybrid_mesh`)."""
    from spn4cir_tpu_torch.parallel.mesh import (make_hybrid_mesh, make_mesh,
                                                 world_size)

    bank = args.mesh_bank if bank is None else bank
    if world_size() > int(os.environ.get("LOCAL_WORLD_SIZE", world_size())):
        return make_hybrid_mesh(bank=bank, model=args.mesh_model,
                                device=device)
    return make_mesh(data=args.mesh_data or None, bank=bank,
                     model=args.mesh_model, device=device)


def finalize_args(args) -> None:
    if args.loader_procs:
        # read by the dataset iterators (data/datasets.py:_mp_loader)
        os.environ["SPN4CIR_MP_PROCS"] = str(args.loader_procs)
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


#: --llm_cache of the LLaMA / LLaVA entry points ('' = the model's default)
CACHE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.int8}
#: --attn_kernel: 'auto' follows models/llama.py:DECODE_ATTN_DEFAULT
ATTN_KERNEL = {"auto": None, "on": True, "off": False}


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


#: the recipe defaults of each ported backbone (the JAX package keeps them
#: in its per-backbone entry scripts): clip4cir/train.py,
#: zscir/{train,validate,cirr_test_submission,serve}.py, tgcir/train.py,
#: blip4cir/train.py and blip24cir/train.py
CLIP4CIR_DEFAULTS = dict(default_model="RN50x4", default_tau=0.02,
                         default_lr=2e-05, default_bs=256, default_epochs=3)
ZSCIR_DEFAULTS = dict(default_model="ViT-L/14", default_tau=0.01,
                      default_lr=2e-06, default_bs=48, default_epochs=10)
#: zscir's stage 2, the bank fine-tune (zscir/train_bank.py)
ZSCIR_BANK_DEFAULTS = dict(default_model="ViT-L/14", default_tau=0.02,
                           default_lr=2e-06, default_bs=128, default_epochs=5)
TGCIR_DEFAULTS = dict(default_model="ViT-B/16", default_tau=0.02,
                      default_lr=2e-05, default_bs=256, default_epochs=5)
BLIP4CIR_DEFAULTS = dict(default_model="RN50x4", default_tau=0.03,
                         default_lr=5e-06, default_bs=128, default_epochs=10)
BLIP24CIR_DEFAULTS = dict(default_model="pretrain", default_tau=0.05,
                          default_lr=1e-05, default_bs=32, default_epochs=3)
BACKBONE_DEFAULTS = {"clip": CLIP4CIR_DEFAULTS, "zs": ZSCIR_DEFAULTS,
                     "tgcir": TGCIR_DEFAULTS, "blip": BLIP4CIR_DEFAULTS,
                     "blip2": BLIP24CIR_DEFAULTS}
#: the backbones an entry point takes as its first word
FIRST_WORDS = tuple(BACKBONE_DEFAULTS)


def recipe_defaults(backbone_name: str) -> dict:
    """The parser defaults of a ported backbone; any other name raises here,
    before a parser is built on another backbone's recipe."""
    if backbone_name not in BACKBONE_DEFAULTS:
        raise NotImplementedError(f"the {backbone_name} backbone is not "
                                  "ported to PyTorch yet")
    return BACKBONE_DEFAULTS[backbone_name]


def backbone_from_argv(argv: list) -> tuple:
    """`python -m spn4cir_tpu_torch.cli.<entry> [clip|zs|tgcir|blip|blip2]
    ...`: an optional first word picks the backbone, and with it the recipe
    defaults (clip when absent). Returns (backbone name, the remaining
    argv)."""
    if argv and argv[0] in FIRST_WORDS:
        return argv[0], argv[1:]
    return "clip", argv


def make_backbone(name: str, args, tokenizer=None) -> CIRBackbone:
    """`tokenizer` overrides the tokenizer the backbone would load (CLIP's
    BPE for clip / zs / tgcir, BERT WordPiece for blip and blip2)."""
    if name not in BACKBONE_DEFAULTS:
        raise NotImplementedError(f"the {name} backbone is not ported to "
                                  "PyTorch yet")
    refuse_unported(args, [
        ("--val_ret_train (retrieval-on-train analysis)", args.val_ret_train),
    ])
    kw = dict(tau=args.tau, remat=bool(args.grad_ckpt),
              dtype=torch.bfloat16 if args.bf16 else torch.float32,
              device=resolve_device(args.device), tokenizer=tokenizer)
    if name == "blip":
        # --clip-model-name doubles as the BLIP size (base/large/test-tiny)
        kw["blip_size"] = (args.clip_model_name if args.clip_model_name
                           in ("base", "large", "test-tiny") else "base")
        if args.text_max_len:
            kw["text_max_len"] = args.text_max_len
        if args.dropout:
            kw["dropout"] = args.dropout
    elif name == "blip2":
        refuse_unported(args, [
            ("--text_max_len (blip2 tokenizes to its fixed 32)",
             args.text_max_len)])
        # --clip-model-name doubles as the BLIP-2 size (pretrain/test-tiny;
        # the backbone refuses any other)
        kw["blip2_size"] = args.clip_model_name
        if args.dropout:
            kw["dropout"] = args.dropout
    else:
        refuse_unported(args, [
            ("--dropout (the CLIP towers have none)", args.dropout),
            ("--text_max_len (the BLIP text side)", args.text_max_len),
        ])
        kw["clip_model_name"] = args.clip_model_name
    return build_backbone(name, **kw)


def make_transform(backbone: CIRBackbone, args):
    """The host preprocess (ImageTransform), or under --device_preprocess
    its raw staging half (RawStageTransform on a canvas of --device_canvas,
    else twice the input size): the iterators then yield uint8 canvases
    and the device runs resize/crop/normalize ahead of the encoder."""
    if args.device_preprocess:
        canvas = args.device_canvas or 2 * backbone.input_dim
        return RawStageTransform(args.transform, backbone.input_dim, canvas,
                                 args.target_ratio)
    if args.device_canvas:
        raise SystemExit("--device_canvas goes with --device_preprocess")
    return ImageTransform(args.transform, backbone.input_dim, args.target_ratio)


def load_or_init_params(backbone: CIRBackbone, args,
                        generator: torch.Generator) -> CIRBackbone:
    """--model_path loads an OpenAI CLIP / clip4cir `.pt` checkpoint, for
    blip a BLIP / BLIP4CIR `.pth`, for blip2 a LAVIS BLIP-2 / SPRC `.pth`
    (the port keeps the checkpoints' parameter names), for tgcir a TG-CIR
    `CIRPlus` `.pt`; otherwise random weights from `generator`. Returns the
    backbone, its weights filled in place."""
    if not args.model_path:
        backbone.init_params(generator)
        return backbone
    if not args.model_path.endswith((".pt", ".pth")):
        raise NotImplementedError(
            "the PyTorch port loads .pt/.pth checkpoints; convert a JAX "
            "checkpoint with models.convert.clip_state_dict_from_jax (or "
            "tgcir_state_dict_from_jax, blip_state_dict_from_jax, "
            "blip2_state_dict_from_jax) and torch.save")
    from spn4cir_tpu_torch.models import convert

    if backbone.name == "blip":
        sd = convert.load_blip_checkpoint(
            args.model_path, num_tokens=backbone.vit_cfg.num_tokens)
        # an upstream BLIP checkpoint has no temperature: --tau then
        sd.setdefault("tau", torch.tensor(float(args.tau)))
    elif backbone.name == "blip2":
        sd = convert.load_blip2_checkpoint(
            args.model_path, num_tokens=backbone.vit_cfg.num_tokens)
        sd.setdefault("temp", torch.tensor(float(args.tau)))
    elif backbone.name == "tgcir":
        sd = convert.load_tgcir_checkpoint(args.model_path)
    else:
        sd = convert.load_clip_checkpoint(args.model_path)
    backbone.model.load_state_dict(sd)
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
