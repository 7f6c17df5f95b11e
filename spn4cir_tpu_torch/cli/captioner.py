"""The captioning stage from the command line: the port's counterpart of
`zscir/captioner.py` (and of `zscir/captioner_llava.py` /
`captioner_blip.py`, which only force `--mllm`), over the port's datagen
core:

    python -m spn4cir_tpu_torch.cli.captioner --mllm blip --blip_size base \\
        --bert_vocab <vocab.txt> --cir_data cirr --data_path <root>

It captions every train image of FashionIQ (one prompt per dress type, one
model load), CIRR or a CC3M shard and writes
`mm_data/{ds}/{prefix}_it_{mllm}_{k}.json` (`mm_data/zs/cc_it_{id}_{mllm}_
{k}.json` for CC) under the working directory. Finished batches go to a
jsonl sidecar beside the output at once (`--caption_ckpt auto`; its name
carries the checkpoint's basename, so captions of another model never
satisfy a resume); a rerun skips them without decoding, and a run with
nothing left loads no model.

The flags are the JAX script's, plus `--device` ("N" is cuda:N, the default
cuda:0; "cpu" the CPU). Not yet ported, and refused: `--tokenizer_path` (an
HF LLaMA tokenizer needs `transformers`) and `--mesh_model` > 1. Without a
tokenizer the 7B LLaVA has none to run with, so `--mllm llava` runs
`--llava_size tiny` (the byte tokenizer) today.
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from spn4cir_tpu_torch.cli.common import ATTN_KERNEL, CACHE_DTYPES
from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.datagen.captioner import (
    caption_images, caption_images_batched, caption_prompt,
    load_caption_checkpoint, load_cc_shard, make_blip_captioner,
    make_llava_captioner, stub_captioner, write_it_list)

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", "--cir_data", dest="dataset", required=True,
                   choices=["fiq", "cirr", "cc"])
    p.add_argument("--data_path", default="")
    p.add_argument("--dress_types", default="dress,shirt,toptee")
    p.add_argument("--mllm", default="stub", choices=["stub", "blip", "llava"],
                   help="'llava' = LLaVA-v1 (CLIP-L tower + LLaMA, the "
                        "canonical path); 'blip' = the BLIP captioner (ViT + "
                        "MED LM decoder); 'stub' = model-free fallback")
    p.add_argument("--ckpt", default="",
                   help="captioner checkpoint (torch; LAVIS blip_caption "
                        "for --mllm blip, LlavaLlamaForCausalLM state dict "
                        "for --mllm llava); empty = random weights")
    p.add_argument("--tokenizer_path", default="",
                   help="LLaMA tokenizer dir (not yet ported)")
    p.add_argument("--llava_size", default="7b", choices=["7b", "tiny"])
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--mesh_model", type=int, default=0,
                   help="tensor-parallel LLaVA over this many cards (not "
                        "yet ported)")
    p.add_argument("--llm_cache", default="",
                   choices=["", "f32", "bf16", "int8"],
                   help="KV cache type of the LLaVA LM ('' = bf16 at 7B, "
                        "f32 at tiny)")
    p.add_argument("--attn_kernel", default="auto",
                   choices=["auto", "on", "off"],
                   help="decode attention through kernel #11 "
                        "(ops/decode_attn.py); 'auto' follows "
                        "models/llama.py:DECODE_ATTN_DEFAULT")
    p.add_argument("--blip_size", default="base")
    p.add_argument("--bert_vocab", default="", help="WordPiece vocab path "
                   "(or SPN4CIR_BERT_VOCAB)")
    p.add_argument("--num_beams", type=int, default=3)
    p.add_argument("--nucleus", action="store_true")
    p.add_argument("--batch_size", type=int, default=0,
                   help="0 (default) = the working point of --mllm (llava: "
                        "recommended_llm_batch(448) for the cache type; "
                        "blip: 32)")
    p.add_argument("--word_num", "--k", dest="word_num", type=int, default=10)
    p.add_argument("--category", default="image")
    p.add_argument("--cc_id", type=int, default=0,
                   help="CC3M shard id for --cir_data cc")
    p.add_argument("--cc_path", default="pretrain_data/cc3m/part_{}.data",
                   help="CC shard path template ('{}' = --cc_id); one JSON "
                        "per line with url/image/caption.en")
    p.add_argument("--caption_ckpt", default="auto",
                   help="resume sidecar (jsonl): finished batches append to "
                        "it at once and a rerun skips them. 'auto' = beside "
                        "the output, named after --ckpt; '' = off")
    p.add_argument("--device", default="0",
                   help="N = cuda:N (default cuda:0), or cpu")
    return p


def output_name(args) -> tuple:
    """(folder under mm_data, file name) of the it-list."""
    if args.dataset == "cc":
        return "zs", f"cc_it_{args.cc_id}_{args.mllm}_{args.word_num}.json"
    prefix = {"fiq": "fashioniq", "cirr": "cirr"}[args.dataset]
    return args.dataset, f"{prefix}_it_{args.mllm}_{args.word_num}.json"


def sidecar_path(args, out_folder: str, out_name: str) -> str:
    if args.caption_ckpt != "auto":
        return args.caption_ckpt
    # the sidecar name carries the checkpoint's basename: captions of
    # another model must not satisfy a resume
    tag = os.path.basename(args.ckpt.rstrip("/")) or "nockpt"
    return os.path.join("mm_data", out_folder,
                        f".{out_name}.{tag}.partial.jsonl")


def _load_captioner(args):
    """(transform, batched_fn) of --mllm, loaded once."""
    if args.mllm == "llava":
        _, transform, batched_fn = make_llava_captioner(
            args.ckpt, llava_size=args.llava_size, category=args.category,
            word_num=args.word_num, max_new_tokens=args.max_new_tokens,
            batch_size=args.batch_size,
            cache_dtype=CACHE_DTYPES.get(args.llm_cache),
            attn_kernel=ATTN_KERNEL[args.attn_kernel], device=args.device)
        return transform, batched_fn
    _, transform, batched_fn = make_blip_captioner(
        args.ckpt, blip_size=args.blip_size,
        bert_vocab_path=args.bert_vocab or None,
        use_nucleus_sampling=args.nucleus, num_beams=args.num_beams,
        batch_size=args.batch_size, device=args.device)
    return transform, batched_fn


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Caption the split and write the it-list; returns its path."""
    args = build_parser().parse_args(argv)
    if args.tokenizer_path:
        raise SystemExit("--tokenizer_path is not yet ported to PyTorch (an "
                         "HF LLaMA tokenizer needs transformers)")
    if args.mesh_model > 1:
        raise SystemExit("--mesh_model > 1 is not yet ported to PyTorch (the "
                         "tensor-parallel LLaVA)")
    if args.batch_size == 0:
        # the llava_v1 caption prompt plus 64 new tokens fits the 448 bucket
        from spn4cir_tpu_torch.datagen.llm_rewrite import recommended_llm_batch
        args.batch_size = (32 if args.mllm == "blip" else
                           recommended_llm_batch(
                               448, CACHE_DTYPES.get(args.llm_cache)))
    out_folder, out_name = output_name(args)
    ckpt_path = sidecar_path(args, out_folder, out_name)
    if ckpt_path:
        os.makedirs(os.path.dirname(ckpt_path) or ".", exist_ok=True)
    done = load_caption_checkpoint(ckpt_path)
    if done:
        print(f"resuming: {len(done)} captions already in {ckpt_path}")

    if args.dataset == "cc":
        entries = load_cc_shard(args.cc_path.format(args.cc_id))
        remaining = [e for e in entries if e["image_id"] not in done]
    else:
        data_path = args.data_path or (
            "fashionIQ_dataset" if args.dataset == "fiq" else "cirr_dataset")
        ds = CIRDataset(args.dataset, "train", "relative",
                        ImageTransform("targetpad", 224), data_path,
                        args.dress_types.split(",")
                        if args.dataset == "fiq" else None)
        remaining = [n for n in ds.imagenames if n not in done]

    # a fully resumed run never loads the model
    transform = batched_fn = None
    if remaining and args.mllm != "stub":
        transform, batched_fn = _load_captioner(args)

    if args.dataset == "cc":
        if not remaining:
            run = []
        elif args.mllm == "stub":
            prompt = caption_prompt(args.category, args.word_num)
            run = [{"image_id": e["image_id"], "caption": stub_captioner(
                np.asarray(Image.open(e["image_path"]).convert("RGB")),
                prompt)} for e in remaining]
        else:
            run = caption_images_batched(
                ((e["image_id"], transform(Image.open(e["image_path"])))
                 for e in remaining),
                batched_fn, batch_size=args.batch_size,
                checkpoint_path=ckpt_path)
        capmap = dict(done)
        capmap.update({r["image_id"]: r["caption"] for r in run})
        it_list = [{**e, "caption": capmap[e["image_id"]]} for e in entries]
    else:
        remaining_set = set(remaining)

        def images(sub):
            for name, path in zip(sub.imagenames, sub.imagepaths):
                if name in remaining_set:  # resume: no decode
                    yield name, transform(Image.open(path))

        if args.mllm == "llava":
            # one loaded model; fiq's per-dress-type prompts ride
            # batched_fn's prompt override (ref captioner_llava.py:173-190)
            it_list = []
            groups = ([(dt, dt) for dt in args.dress_types.split(",")]
                      if args.dataset == "fiq" else [(None, args.category)])
            for dress_type, category in groups:
                if not remaining_set:
                    break
                sub = (CIRDataset(args.dataset, "train", "relative",
                                  ImageTransform("targetpad", 224),
                                  data_path, [dress_type])
                       if dress_type is not None else ds)
                fn = functools.partial(
                    batched_fn,
                    prompt=caption_prompt(category, args.word_num))
                it_list.extend(caption_images_batched(
                    images(sub), fn, batch_size=args.batch_size,
                    checkpoint_path=ckpt_path))
        elif args.mllm == "blip":
            it_list = ([] if not remaining_set else caption_images_batched(
                images(ds), batched_fn, batch_size=args.batch_size,
                checkpoint_path=ckpt_path))
        else:
            it_list = caption_images(
                ((n, np.asarray(Image.open(p).convert("RGB")))
                 for n, p in zip(ds.imagenames, ds.imagepaths)),
                stub_captioner, category=args.category,
                num_words=args.word_num)
        if done:
            have = {it["image_id"] for it in it_list}
            it_list.extend({"image_id": n, "caption": c}
                           for n, c in done.items() if n not in have)
    out = write_it_list(it_list, out_folder, args.mllm, args.word_num,
                        filename=out_name)
    print(f"wrote {len(it_list)} captions -> {out}")
    return out


if __name__ == "__main__":
    main()
