"""The MLLM captioning service from the command line: the port's counterpart
of `spn4cir_tpu/cli/serve_mllm.py`. It loads one captioner on one card and
serves `serve/mllm.py`'s endpoints:

    python -m spn4cir_tpu_torch.cli.serve_mllm --mllm blip \\
        --ckpt <blip_caption.pth> --bert_vocab <vocab.txt> --port 8081
    curl -s localhost:8081/caption -d '{"image_b64": "..."}'

The flags are the JAX script's, plus `--device` ("N" is cuda:N, the default
cuda:0; "cpu" the CPU). Not yet ported, and refused: `--tokenizer_path` (an
HF LLaMA tokenizer needs `transformers`) and `--mesh_model` > 1 (the
tensor-parallel model). Without a tokenizer the 7B LLaVA has none to run
with, so `--mllm llava` serves `--llava_size tiny` (the byte tokenizer)
today; the 7B runs through `datagen.captioner.make_llava_captioner` with a
tokenizer object.
"""

from __future__ import annotations

import argparse
from typing import Optional

from spn4cir_tpu_torch.cli.common import ATTN_KERNEL, CACHE_DTYPES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--mllm", default="llava", choices=["llava", "blip"])
    p.add_argument("--ckpt", default="",
                   help="checkpoint (torch state dict); empty = random "
                        "weights (smoke runs only)")
    p.add_argument("--tokenizer_path", default="",
                   help="HF LLaMA tokenizer dir (not yet ported)")
    p.add_argument("--llava_size", default="7b", choices=["7b", "tiny"])
    p.add_argument("--blip_size", default="base")
    p.add_argument("--bert_vocab", default="",
                   help="WordPiece vocab path (blip; or SPN4CIR_BERT_VOCAB)")
    p.add_argument("--category", default="image",
                   help="default-prompt subject (llava only)")
    p.add_argument("--word_num", type=int, default=10,
                   help="default-prompt word budget (llava only)")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=16,
                   help="device batch, and the cap of a coalesced batch")
    p.add_argument("--max_delay_ms", type=float, default=20.0,
                   help="max time a request waits for batch-mates")
    p.add_argument("--quantize_int8", action="store_true",
                   help="weight-only int8 LM (llava)")
    p.add_argument("--mesh_model", type=int, default=0,
                   help="tensor-parallel model over this many cards (not "
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
    p.add_argument("--device", default="0",
                   help="N = cuda:N (default cuda:0), or cpu")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8081)
    p.add_argument("--no-block", dest="block", action="store_false",
                   default=True, help="return the server (tests)")
    return p


def main(argv: Optional[list] = None):
    args = build_parser().parse_args(argv)
    from spn4cir_tpu_torch.datagen.captioner import caption_prompt
    from spn4cir_tpu_torch.serve.mllm import CaptionService, serve_captions

    if args.tokenizer_path:
        raise SystemExit("--tokenizer_path is not yet ported to PyTorch (an "
                         "HF LLaMA tokenizer needs transformers)")
    if args.mesh_model > 1:
        raise SystemExit("--mesh_model > 1 is not yet ported to PyTorch (the "
                         "tensor-parallel model)")
    if args.mllm == "blip" and args.quantize_int8:
        raise SystemExit("--quantize_int8 applies to the LLaVA backend only "
                         "(BLIP base fits any card in full precision)")

    if args.mllm == "llava":
        from spn4cir_tpu_torch.datagen.captioner import make_llava_captioner

        _, transform, batched_fn = make_llava_captioner(
            args.ckpt, llava_size=args.llava_size, category=args.category,
            word_num=args.word_num, max_new_tokens=args.max_new_tokens,
            batch_size=args.batch_size, quantize_weights=args.quantize_int8,
            cache_dtype=CACHE_DTYPES.get(args.llm_cache),
            attn_kernel=ATTN_KERNEL[args.attn_kernel], device=args.device)
    else:
        from spn4cir_tpu_torch.datagen.captioner import make_blip_captioner

        _, transform, batched_fn = make_blip_captioner(
            args.ckpt, blip_size=args.blip_size,
            bert_vocab_path=args.bert_vocab or None,
            max_length=args.max_new_tokens, batch_size=args.batch_size,
            device=args.device)

    # BLIP's decoder prompt is fixed ("a picture of"); only LLaVA takes a
    # prompt per request
    default_prompt = (caption_prompt(args.category, args.word_num)
                      if args.mllm == "llava" else None)
    service = CaptionService(
        batched_fn, transform, model_name=args.mllm,
        max_batch=args.batch_size, max_delay_s=args.max_delay_ms / 1000.0,
        default_prompt=default_prompt,
        supports_prompt=(args.mllm == "llava"))
    server = serve_captions(service, args.host, args.port)
    print(f"caption service ({args.mllm}) on {args.host}:{args.port}",
          flush=True)
    if args.block:
        import threading
        threading.Event().wait()
    return server, service


if __name__ == "__main__":
    main()
