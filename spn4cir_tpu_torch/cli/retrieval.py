"""Image-to-image and text-to-image retrieval over a folder of images from
the command line: the port's counterpart of `zscir/retrieval.py`:

    python -m spn4cir_tpu_torch.cli.retrieval --gallery <dir> [--query <dir>]
    python -m spn4cir_tpu_torch.cli.retrieval --gallery <dir> \\
        --text "a red dress,two dogs"

CLIP ViT-L/14 by default (its gallery encode runs the long attention,
kernel #3, at S = 257; a text query the short causal one, #1, at S = 77),
random weights from seed 0 unless `--model_path` names an OpenAI / clip4cir
`.pt`. Without `--query` the gallery retrieves itself, each image's own row
left out. One folder per query lands in `--out_dir`. The flags are the JAX
script's, plus `--device` ("N" is cuda:N, the default cuda:0; "cpu" the
CPU).
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from spn4cir_tpu_torch.cli.common import resolve_device
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.eval.generic_retrieval import (encode_paths,
                                                      export_results,
                                                      i2i_topk, list_images,
                                                      t2i_topk)
from spn4cir_tpu_torch.models.api import build_backbone


def main(argv: Optional[list] = None, tokenizer=None) -> np.ndarray:
    """Rank and export; returns the (queries, topk) gallery indices.
    `tokenizer` overrides the CLIP tokenizer the backbone would load."""
    p = argparse.ArgumentParser()
    p.add_argument("--gallery", required=True,
                   help="dir / JSON list / CSV of images")
    p.add_argument("--query", default="",
                   help="query images (defaults to gallery i2i)")
    p.add_argument("--text", default="",
                   help="comma-separated text queries (t2i)")
    p.add_argument("--clip-model-name", default="ViT-L/14")
    p.add_argument("--model_path", default="")
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--out_dir", default="retrieval_results")
    p.add_argument("--device", default="0",
                   help="N = cuda:N (default cuda:0), or cpu")
    args = p.parse_args(argv)
    bb = build_backbone("clip", clip_model_name=args.clip_model_name,
                        device=resolve_device(args.device),
                        tokenizer=tokenizer)
    if args.model_path:
        from spn4cir_tpu_torch.models.convert import load_clip_checkpoint
        bb.model.load_state_dict(load_clip_checkpoint(args.model_path))
    else:
        bb.init_params(torch.Generator().manual_seed(0))
    bb.eval()
    tf = ImageTransform("clip", bb.input_dim)
    gallery_paths = list_images(args.gallery)
    gallery = encode_paths(bb, gallery_paths, tf)
    if args.text:
        top = t2i_topk(bb, args.text.split(","), gallery, args.topk)
        export_results([], gallery_paths, top, args.out_dir)
    else:
        qpaths = list_images(args.query) if args.query else gallery_paths
        qfeats = encode_paths(bb, qpaths, tf) if args.query else gallery
        top = i2i_topk(qfeats, gallery, args.topk,
                       exclude_self=not args.query)
        export_results(qpaths, gallery_paths, top, args.out_dir)
    print(f"wrote results for {top.shape[0]} queries to {args.out_dir}")
    return top


if __name__ == "__main__":
    main()
