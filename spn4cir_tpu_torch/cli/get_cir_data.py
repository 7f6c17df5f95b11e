"""Extended-triplet generation from the command line: the port's counterpart
of `zscir/get_cir_data.py`, over the port's datagen core.

    python -m spn4cir_tpu_torch.cli.get_cir_data --dataset cirr \
        --data_path <root> --it_list <it.json> --use_llm 1 \
        --llm_backend torch --llm_ckpt <hf_llama.pt> --llm_tokenizer <dir>

The flags are the JAX script's, with these differences: `--llm_backend`
takes `torch` (the LLaMA-2 7B decoder, from `--llm_ckpt`) or `torch-tiny`
(a random tiny LM with the byte tokenizer, for smoke runs) in place of
`jax`, `jax-tiny` and `hf`; `--device` picks the card ("N" is cuda:N, the
default cuda:0; "cpu" the CPU). `--mesh_model N` splits the LM over N
ranks (tensor parallelism, `parallel/tp.py`), one process per GPU launched
by torchrun or the `SPN4CIR_DIST_*` variables; every rank rewrites the same
captions and rank 0 alone writes the triplets. Not yet ported, and
refused: a `--llm_tokenizer` (it needs `transformers`). Without a tokenizer
the 7B cannot run, so `torch` needs a ported tokenizer first; `torch-tiny`
runs today.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional, Sequence

import numpy as np

from spn4cir_tpu_torch.cli.common import (ATTN_KERNEL, CACHE_DTYPES,
                                          setup_model_mesh)
from spn4cir_tpu_torch.parallel.mesh import process_is_main
from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.datagen.generate import (
    generate_cc_triplets, generate_extended_triplets, load_it_list,
    write_cc_triplets, write_extended_triplets)

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", "--data", dest="dataset", required=True,
                   choices=["fiq", "cirr", "ccfiq", "cccirr"])
    p.add_argument("--data_path", default="")
    p.add_argument("--dress_types", default="dress,shirt,toptee")
    p.add_argument("--it_list", default="",
                   help="mm_data it-list JSON from the captioner; empty = "
                        "the reference's default filename from "
                        "--mllm/--word_num (comma-separated or glob for "
                        "the CC shards)")
    p.add_argument("--mllm", default="llava",
                   choices=["blip", "blip2", "llava", "stub"])
    p.add_argument("--word_num", type=int, default=10)
    p.add_argument("--model", default="zs", help="filename tag (clip/tgcir/...)")
    p.add_argument("--k", type=int, default=1)
    p.add_argument("--K", type=int, default=0, help="total cap")
    p.add_argument("--p_list", default="0", help="comma prompt ids 0-2")
    p.add_argument("--refer", action="store_true")
    p.add_argument("--i2i_rank", type=int, default=-1)
    p.add_argument("--i2i_rank_max", type=int, default=-1)
    p.add_argument("--srm", default="",
                   help="alias for --sims (an npz with an 'i2i' matrix)")
    p.add_argument("--sims", default="", help="sims npz with an 'i2i' matrix")
    p.add_argument("--use_llm", type=int, nargs="?", const=1, default=0,
                   help="LLaMA-2 rewriting; the value is the reference's "
                        "llm_type (1 = few-shot chat prompt, 2 = plain "
                        "template). Bare --use_llm means 1.")
    p.add_argument("--llm_backend", default="torch",
                   choices=["torch", "torch-tiny"],
                   help="'torch' = the LLaMA-2 7B decoder (needs --llm_ckpt "
                        "and a tokenizer); 'torch-tiny' = a random tiny LM "
                        "with the byte tokenizer (smoke runs)")
    p.add_argument("--llm_ckpt", default="",
                   help="HF LlamaForCausalLM torch state dict for "
                        "--llm_backend torch")
    p.add_argument("--llm_tokenizer", default="",
                   help="LLaMA tokenizer dir (not yet ported)")
    p.add_argument("--llm_batch", type=int, default=0,
                   help="0 (default) = bucket-aware batching at "
                        "DECODE_BUCKET_BATCH's working points; >1 = fixed "
                        "left-padded device batches; 1 = one prompt per "
                        "generate (the reference's loop)")
    p.add_argument("--mesh_model", type=int, default=0,
                   help="tensor-parallel model over this many ranks: one "
                        "process per GPU, launched by torchrun or the "
                        "SPN4CIR_DIST_* variables; rank 0 alone writes")
    p.add_argument("--llm_cache", default="",
                   choices=["", "f32", "bf16", "int8"],
                   help="KV cache type ('' = bf16 at 7B, f32 at tiny; int8 "
                        "with per-row scales)")
    p.add_argument("--prefill_chunk", type=int, default=128,
                   help="prefill the prompt in chunks of this many "
                        "positions (0 = one dense prefill)")
    p.add_argument("--attn_kernel", default="auto",
                   choices=["auto", "on", "off"],
                   help="decode attention through kernel #11 "
                        "(ops/decode_attn.py); 'auto' follows "
                        "models/llama.py:DECODE_ATTN_DEFAULT")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="0",
                   help="N = cuda:N (default cuda:0), or cpu")
    return p


def _rewriter(args, base: str):
    if args.llm_tokenizer:
        raise SystemExit("--llm_tokenizer is not yet ported (it needs "
                         "transformers)")
    from spn4cir_tpu_torch.datagen.llm_rewrite import load_torch_rewriter

    # the reference composes the LM input differently per dataset: fiq
    # rewrites caption2 alone (mod_type=1), cirr the "{1} instead of {0}"
    # composition (mod_type=0) — get_cir_data.py:94,169
    return load_torch_rewriter(
        args.llm_ckpt, None, data=base, mod_type=1 if base == "fiq" else 0,
        llm_type=int(args.use_llm), tiny=args.llm_backend == "torch-tiny",
        seed=args.seed, batch_size=args.llm_batch,
        prefill_chunk=args.prefill_chunk or None,
        cache_dtype=CACHE_DTYPES.get(args.llm_cache),
        attn_kernel=ATTN_KERNEL[args.attn_kernel],
        device=args.device, mesh=setup_model_mesh(args))


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Generate and write the triplets; returns the written file's path."""
    args = build_parser().parse_args(argv)
    use_cc = args.dataset.startswith("cc")
    base = args.dataset[2:] if use_cc else args.dataset
    data_path = args.data_path or ("fashionIQ_dataset" if base == "fiq"
                                   else "cirr_dataset")
    if use_cc:
        # CC partners sample uniformly (ref get_cc :199-205); fail loud
        # rather than silently discard the SRM rank window / refer filter
        if args.refer or args.i2i_rank >= 0:
            raise SystemExit("--refer/--i2i_rank do not apply to the CC "
                             "modes (out-of-domain partners sample "
                             "uniformly, ref get_cir_data.py:199-205)")
        pats = (args.it_list.split(",") if args.it_list else
                [f"mm_data/zs/cc_it_*_{args.mllm}_{args.word_num}.json"])
        paths = sorted(p_ for pat in pats for p_ in glob.glob(pat))
        if not paths:
            raise SystemExit(f"no CC it-lists found for {pats}")
        cc_items = []
        for path in paths:
            with open(path) as f:
                cc_items.extend(json.load(f))
    else:
        ds = CIRDataset(base, "train", "relative",
                        ImageTransform("targetpad", 224), data_path,
                        args.dress_types.split(",") if base == "fiq" else None)
        it_path = args.it_list or os.path.join(
            "mm_data", base,
            f"{'fashioniq' if base == 'fiq' else 'cirr'}"
            f"_it_{args.mllm}_{args.word_num}.json")
        name2cap = load_it_list(it_path)
    i2i_ranks = None
    sims_path = args.sims or args.srm
    if args.i2i_rank >= 0 and sims_path:
        data = np.load(sims_path)
        if "i2i" not in data:
            raise SystemExit(f"{sims_path} has no 'i2i' matrix")
        i2i_ranks = np.argsort(-data["i2i"], axis=1)
    elif args.i2i_rank >= 0:
        raise SystemExit("--i2i_rank needs --sims/--srm (an npz with 'i2i')")
    rewriter = _rewriter(args, base) if args.use_llm else None
    prompt_ids = [int(x) for x in args.p_list.split(",")]
    if use_cc:
        triplets = generate_cc_triplets(
            cc_items, base, k=args.k, prompt_ids=prompt_ids,
            total_cap=args.K, llm_rewrite=rewriter, seed=args.seed)
        out = (write_cc_triplets(data_path, base, triplets)
               if process_is_main() else "")
    else:
        triplets = generate_extended_triplets(
            ds, name2cap, k=args.k, total_cap=args.K,
            prompt_ids=prompt_ids,
            refer_only=args.refer, i2i_ranks=i2i_ranks,
            rank_lo=args.i2i_rank, rank_hi=args.i2i_rank_max,
            llm_rewrite=rewriter, seed=args.seed)
        out = (write_extended_triplets(ds, triplets, args.model,
                                       llm=args.use_llm)
               if process_is_main() else "")
    if process_is_main():
        print(f"wrote {len(triplets)} triplets -> {out}")
    return out


if __name__ == "__main__":
    main()
