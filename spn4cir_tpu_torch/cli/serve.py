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
    python -m spn4cir_tpu_torch.cli.serve blip2 --dataset cirr \\
        --data_path cirr_dataset --bf16 --serve_batch 32

An optional first word, `clip` (the default), `blip` or `blip2`, picks the
backbone. A blip2 gallery holds 32 query features per image on the device
(scored by the best of them; `--gallery_dtype int8` quantizes each of them
per row) and the frozen EVA tokens of each image on the host.

Several GPUs: `--mesh_bank N` holds the gallery as N row shards on
cuda:0..N-1 of this one process (`serve/sharded.py`, an exact two-stage
top-k; N past the visible devices is refused; with `--device cpu` every
shard lives on the CPU). `--mesh_data` / `--mesh_model` encode the gallery
once over several ranks (`cli.validate`'s indexing mesh; a torchrun or
`SPN4CIR_DIST_*` launch), and rank 0 alone serves.

`--profile_dir DIR` serves under the torch profiler with every thread
recorded (the request threads and the batching worker: the `serve.*` and
`text.tokenize` spans beside the kernels they issue) and writes the trace
under DIR when the server stops (Ctrl-C). The trace is held in memory until
then, so profile a short session.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import torch

from spn4cir_tpu_torch.cli.common import (
    backbone_from_argv,
    base_parser,
    finalize_args,
    encode_mesh,
    load_or_init_params,
    make_backbone,
    make_transform,
    recipe_defaults,
    setup_distributed,
)
from spn4cir_tpu_torch.parallel.mesh import broadcast_module, process_is_main
from spn4cir_tpu_torch.utils.logging import profiler_trace
from spn4cir_tpu_torch.utils.seeding import seed_everything


def serve_main(argv: Optional[list] = None, backbone_name: str = "clip",
               tokenizer=None, **parser_kw):
    """Parse `argv`, index the gallery and start the server. With
    --no-block, returns (server, service); `tokenizer` overrides the CLIP
    tokenizer the backbone would load."""
    p = base_parser(**(parser_kw or recipe_defaults(backbone_name)))
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
    shard_devices = None
    if args.mesh_bank > 1:
        if args.device == "cpu":
            shard_devices = ["cpu"] * args.mesh_bank
        else:
            visible = torch.cuda.device_count()
            if args.mesh_bank > visible:
                raise SystemExit(f"--mesh_bank {args.mesh_bank} exceeds the "
                                 f"{visible} visible CUDA devices")
            shard_devices = [f"cuda:{i}" for i in range(args.mesh_bank)]
    setup_distributed(args, bank=False)
    generator = seed_everything(args.seed)

    backbone = make_backbone(backbone_name, args, tokenizer=tokenizer)
    preprocess = make_transform(backbone, args)
    load_or_init_params(backbone, args, generator)
    backbone.eval()
    mesh = encode_mesh(args, backbone.device, bank=False)
    if mesh is not None:
        broadcast_module(backbone)

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
        t0 = time.perf_counter()
        index = extract_index_features(backbone, classic, args.batch_size,
                                       mesh=mesh)
        index_s = time.perf_counter() - t0
        if args.gallery_dtype != "float32":
            from spn4cir_tpu_torch.ops.bank_kernels import quantize_bank

            target = (quantize_bank(index.target)
                      if args.gallery_dtype == "int8"
                      else index.target.to(torch.bfloat16))
            index = GalleryIndex(target=target, refer=index.refer,
                                 names=index.names)
        if cache and process_is_main():
            index.save(cache)
            print(f"gallery index cached -> {cache}")
        print(f"gallery indexed: {len(index.names)} images "
              f"({args.gallery_dtype}) in {index_s:.2f} s, "
              f"{len(index.names) / index_s:.1f} images/s")

    if not process_is_main():  # the indexing ranks are done
        return None, None

    from spn4cir_tpu_torch.serve import (BatchingRetrievalService,
                                         RetrievalService,
                                         ShardedBatchingRetrievalService,
                                         ShardedRetrievalService, serve)

    kw = dict(preprocess=preprocess, default_k=args.default_k)
    if shard_devices is not None:
        if args.serve_batch > 0:
            service = ShardedBatchingRetrievalService(
                backbone, index, shard_devices, max_batch=args.serve_batch,
                **kw)
        else:
            service = ShardedRetrievalService(backbone, index, shard_devices,
                                              **kw)
        print(f"gallery sharded over {args.mesh_bank} devices")
    elif args.serve_batch > 0:
        service = BatchingRetrievalService(backbone, index,
                                           max_batch=args.serve_batch, **kw)
    else:
        service = RetrievalService(backbone, index, **kw)

    server = serve(service, host=args.serve_host, port=args.serve_port)
    print(f"serving on {server.server_address[0]}:{server.server_address[1]}"
          f" (k={args.default_k}, batch={args.serve_batch or 'off'}, "
          f"device={backbone.device})", flush=True)
    if args.block:  # pragma: no cover - foreground production mode
        with profiler_trace(args.profile_dir):
            threading.Event().wait()
    return server, service


if __name__ == "__main__":
    import sys

    _name, _argv = backbone_from_argv(sys.argv[1:])
    serve_main(_argv, _name)
