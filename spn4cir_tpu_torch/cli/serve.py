"""Serving CLI of the PyTorch port: index a gallery and stand up the
retrieval HTTP service (`/retrieve`, `/gallery/add`, `/healthz`,
`/metrics`) on one CUDA device.

Counterpart of `spn4cir_tpu/cli/serve.py`: build the backbone, load a
checkpoint or draw random weights from --seed, encode the gallery split,
optionally cast it to bfloat16 or quantize it to int8, then serve it with
or without micro-batching (--serve_batch).

    python -m spn4cir_tpu_torch.cli.serve --dataset cirr \\
        --data_path cirr_dataset --clip-model-name ViT-B/32 --bf16 \\
        --serve_batch 32
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch

from spn4cir_tpu_torch.cli.common import (
    base_parser,
    finalize_args,
    load_or_init_params,
    make_backbone,
    make_transform,
    refuse_unported,
)
from spn4cir_tpu_torch.utils.seeding import seed_everything

CLIP4CIR_DEFAULTS = dict(default_model="RN50x4", default_tau=0.02,
                         default_lr=2e-05, default_bs=256, default_epochs=3)


def serve_main(argv: Optional[list] = None, backbone_name: str = "clip",
               tokenizer=None, **parser_kw):
    """Parse `argv`, index the gallery and start the server. With
    --no-block, returns (server, service); `tokenizer` overrides the CLIP
    tokenizer the backbone would load."""
    p = base_parser(**(parser_kw or CLIP4CIR_DEFAULTS))
    p.add_argument("--serve_host", default="0.0.0.0")
    p.add_argument("--serve_port", type=int, default=8080)
    p.add_argument("--serve_split", default="val", choices=["val", "test1"],
                   help="gallery split to index (classic mode)")
    p.add_argument("--default_k", type=int, default=10)
    p.add_argument("--serve_batch", type=int, default=0,
                   help="micro-batch size for coalescing concurrent queries "
                        "(0 = dispatch per query)")
    p.add_argument("--gallery_dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="resident gallery precision; int8 quantizes per row "
                        "(dequantized after the score product)")
    p.add_argument("--index_cache", default="",
                   help="npz path for the encoded gallery index; loaded if "
                        "present (restart without re-encoding), written "
                        "after extraction otherwise")
    p.add_argument("--block", action="store_true", default=True,
                   help="block the main thread on the server (default)")
    p.add_argument("--no-block", dest="block", action="store_false",
                   help="return the server instead of blocking (tests)")
    args = p.parse_args(argv)
    finalize_args(args)
    if args.mesh_data > 1 or args.mesh_model > 1 or args.mesh_bank > 1:
        raise NotImplementedError("--mesh_data/--mesh_model/--mesh_bank > 1: "
                                  "multi-device serving is not yet ported")
    refuse_unported(args, [
        ("--loader_procs (multi-process image loader)", args.loader_procs)])
    generator = seed_everything(args.seed)

    backbone = make_backbone(backbone_name, args, tokenizer=tokenizer)
    preprocess = make_transform(backbone, args)
    load_or_init_params(backbone, args, generator)
    backbone.eval()

    from spn4cir_tpu_torch.eval.retrieval import (GalleryIndex, cache_file,
                                                  extract_index_features)

    cache = args.index_cache
    if cache and os.path.exists(cache_file(cache)):
        index = GalleryIndex.load(cache, device=backbone.device)
        print(f"gallery index loaded from cache: {len(index.names)} images")
    else:
        from spn4cir_tpu_torch.data.datasets import CIRDataset

        classic = CIRDataset(args.dataset, args.serve_split, "classic",
                             preprocess, args.data_path,
                             args.dress_types if args.dataset == "fiq"
                             else None)
        index = extract_index_features(backbone, classic, args.batch_size,
                                       num_workers=0)
        if args.gallery_dtype != "float32":
            from spn4cir_tpu_torch.ops.bank_kernels import quantize_bank

            target = (quantize_bank(index.target)
                      if args.gallery_dtype == "int8"
                      else index.target.to(torch.bfloat16))
            index = GalleryIndex(target=target, refer=index.refer,
                                 names=index.names)
        if cache:
            index.save(cache)
            print(f"gallery index cached -> {cache}")
        print(f"gallery indexed: {len(index.names)} images "
              f"({args.gallery_dtype})")

    from spn4cir_tpu_torch.serve import (BatchingRetrievalService,
                                         RetrievalService, serve)

    kw = dict(preprocess=preprocess, default_k=args.default_k)
    if args.serve_batch > 0:
        service = BatchingRetrievalService(backbone, index,
                                           max_batch=args.serve_batch, **kw)
    else:
        service = RetrievalService(backbone, index, **kw)

    server = serve(service, host=args.serve_host, port=args.serve_port)
    print(f"serving on {server.server_address[0]}:{server.server_address[1]}"
          f" (k={args.default_k}, batch={args.serve_batch or 'off'}, "
          f"device={backbone.device})", flush=True)
    if args.block:  # pragma: no cover - foreground production mode
        threading.Event().wait()
    return server, service


if __name__ == "__main__":
    serve_main(None, "clip", **CLIP4CIR_DEFAULTS)
