"""SRM scores and hard negatives from the command line: the port's
counterpart of `zscir/srm_utils.py`.

    python -m spn4cir_tpu_torch.cli.srm_utils --dataset cirr \\
        --data_path cirr_dataset --unicom_ckpt FP16-ViT-L-14.pt \\
        --bge_ckpt bge-base-en.pt --bert_vocab vocab.txt

Encodes every unique train image and every train caption twice: with CLIP
(`--clip-model-name`, ViT-L/14 by default; the cross-modal role, ref
`:102-106`: targetpad images through `gallery_features`) and with the SRM
model (Unicom ViT-L/14 + BGE-base, the intra-modal role, ref `:35-69`:
the `clip` transform at Unicom's input size). Then the four similarity
matrices (`datagen.srm.compute_sims`, written to `--sims_out`: its `i2i`
feeds `cli.get_cir_data --srm`) and the per-triplet rank scores and top-K
hard negatives (`srm_scores`, written to `--out`). The captions are each
triplet's deterministic one (`caption_for(i, train=False)`).

The flags are the JAX script's, plus `--device` ("N" is cuda:N, the default
cuda:0; "cpu" the CPU). The checkpoint checks come before any extraction,
as in the JAX script: without `--unicom_ckpt` and `--bge_ckpt` the run
needs `--tiny_srm` (the test geometry, random weights from seed 0) or
`--allow_clip_srm` (CLIP's features in the SRM roles). The CLIP weights are
random from seed 0 unless `--model_path` names an OpenAI / clip4cir `.pt`.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spn4cir_tpu_torch.cli.common import resolve_device
from spn4cir_tpu_torch.data.datasets import CIRDataset, iter_unique_images
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.datagen.srm import (compute_sims, extract_all_features,
                                           save_srm, srm_scores)
from spn4cir_tpu_torch.models.api import build_backbone
from spn4cir_tpu_torch.ops.infonce import l2_normalize

TEXT_CHUNK = 64


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True, choices=["fiq", "cirr"])
    p.add_argument("--data_path", default="")
    p.add_argument("--dress_types", default="dress,shirt,toptee")
    p.add_argument("--clip-model-name", dest="clip_model_name",
                   default="ViT-L/14")
    p.add_argument("--model_path", default="",
                   help="CLIP .pt (cross-modal role)")
    p.add_argument("--unicom_ckpt", default="",
                   help="Unicom FP16-ViT-L-14.pt (intra-modal image role, "
                        "ref srm_utils.py:37-43)")
    p.add_argument("--bge_ckpt", default="",
                   help="BAAI/bge-base-en BertModel save (intra-modal text "
                        "role, ref srm_utils.py:38-46)")
    p.add_argument("--bert_vocab", default="",
                   help="bert-base-uncased vocab (else SPN4CIR_BERT_VOCAB)")
    p.add_argument("--allow_clip_srm", action="store_true",
                   help="substitute CLIP features for the SRM roles when the "
                        "Unicom/BGE checkpoints are unavailable")
    p.add_argument("--tiny_srm", action="store_true",
                   help="test-geometry SRM with random weights (smoke runs)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--zs_triplets", action="store_true",
                   help="score the generated train set (cap.extend_zs / "
                        "cap.cc), which replaces the human triplets as the "
                        "reference's zscir loader does; the default scores "
                        "the human triplets, whose image ids "
                        "cli.get_cir_data's rank window uses")
    p.add_argument("--out", default="srm.npz")
    p.add_argument("--sims_out", default="sims.npz")
    p.add_argument("--k_negatives", type=int, default=1000)
    p.add_argument("--device", default="0",
                   help="N = cuda:N (default cuda:0), or cpu")
    return p


def make_dataset(args, preprocess) -> CIRDataset:
    return CIRDataset(args.dataset, "train", "relative", preprocess,
                      args.data_path,
                      args.dress_types.split(",") if args.dataset == "fiq"
                      else None,
                      replace_extended=args.zs_triplets, extend_suffix="zs")


def encode_texts(texts: Sequence[str], encode_fn) -> torch.Tensor:
    """`encode_fn` over `texts` TEXT_CHUNK at a time, the rows
    concatenated."""
    with torch.no_grad():
        return torch.cat([encode_fn(list(texts[s: s + TEXT_CHUNK]))
                          for s in range(0, len(texts), TEXT_CHUNK)])


def clip_features(args, device, tokenizer, texts: List[str]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-modal role: CLIP's gallery features of the unique train
    images (targetpad) and its unit text features."""
    bb = build_backbone("clip", clip_model_name=args.clip_model_name,
                        device=device, tokenizer=tokenizer)
    if args.model_path:
        from spn4cir_tpu_torch.models.convert import load_clip_checkpoint
        bb.model.load_state_dict(load_clip_checkpoint(args.model_path))
    else:
        bb.init_params(torch.Generator().manual_seed(0))
    bb.eval()
    ds = make_dataset(args, ImageTransform("targetpad", bb.input_dim))
    images = extract_all_features(
        bb.gallery_features, iter_unique_images(ds, args.batch_size), device)

    def text_fn(chunk):
        ids = torch.from_numpy(bb.tokenize(chunk)).to(device)
        return l2_normalize(bb.encode_text(ids).float())

    return images, encode_texts(texts, text_fn)


def srm_features(args, device, texts: List[str]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The intra-modal role: Unicom's unit image embeddings (the `clip`
    transform at its input size) and BGE's unit CLS states."""
    from spn4cir_tpu_torch.models.convert import (load_bge_checkpoint,
                                                  load_unicom_checkpoint)
    from spn4cir_tpu_torch.models.srm import SRMModel

    srm = SRMModel(tiny=args.tiny_srm, bert_vocab_path=args.bert_vocab or None,
                   device=device)
    if args.unicom_ckpt:
        srm.visual.load_state_dict(load_unicom_checkpoint(args.unicom_ckpt))
        srm.text.load_state_dict(load_bge_checkpoint(args.bge_ckpt))
    else:
        srm.init_params(torch.Generator().manual_seed(0))
    srm.eval()
    ds = make_dataset(args, ImageTransform("clip", srm.input_dim))
    images = extract_all_features(
        srm.encode_image, iter_unique_images(ds, args.batch_size), device)
    return images, encode_texts(texts, srm.encode_text)


def main(argv: Optional[Sequence[str]] = None, tokenizer=None
         ) -> Tuple[str, str]:
    """Write the sims and the scores; returns (sims path, scores path).
    `tokenizer` overrides the CLIP tokenizer the backbone would load."""
    args = build_parser().parse_args(argv)
    args.data_path = args.data_path or ("fashionIQ_dataset"
                                        if args.dataset == "fiq"
                                        else "cirr_dataset")
    # fail fast, before the (slow) extraction
    have_srm = bool(args.unicom_ckpt and args.bge_ckpt) or args.tiny_srm
    if not have_srm and not args.allow_clip_srm:
        raise SystemExit(
            "SRM needs --unicom_ckpt + --bge_ckpt (ref srm_utils.py:35-69); "
            "pass --allow_clip_srm to substitute CLIP features instead")
    device = resolve_device(args.device)
    ds = make_dataset(args, preprocess=None)      # captions and ids only
    texts = [ds.caption_for(i, train=False) for i in range(len(ds.triplets))]
    clip_img, clip_txt = clip_features(args, device, tokenizer, texts)
    if have_srm:
        srm_img, srm_txt = srm_features(args, device, texts)
    else:
        print("WARNING: substituting CLIP features for the SRM roles "
              "(Unicom/BGE checkpoints not provided)")
        srm_img, srm_txt = clip_img, clip_txt
    sims = compute_sims(clip_img, clip_txt, srm_img, srm_txt)
    np.savez_compressed(args.sims_out, **{k: v.cpu().numpy()
                                          for k, v in sims.items()})
    refer = [ds.imagename2id[t["reference_name"]] for t in ds.triplets]
    target = [ds.imagename2id[t["target_name"]] for t in ds.triplets]
    save_srm(args.out, srm_scores(sims, refer, target, args.k_negatives))
    print(f"wrote {args.sims_out} and {args.out}")
    return args.sims_out, args.out


if __name__ == "__main__":
    main()
