"""Image dedup from the command line: the port's counterpart of
`zscir/deduplicate_images.py`.

    python -m spn4cir_tpu_torch.cli.deduplicate_images --dataset cirr \\
        --data_path cirr_dataset

Hashes the decoded pixels of every unique train image
(`datagen.dedup.deduplicate`) and writes `same_image_list.json` and
`optimized_images.json` into the dataset root, where every later
`CIRDataset` over that root reads the map. Host code only: no device.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from spn4cir_tpu_torch.data.datasets import CIRDataset
from spn4cir_tpu_torch.data.transforms import ImageTransform
from spn4cir_tpu_torch.datagen.dedup import deduplicate


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True, choices=["fiq", "cirr"])
    p.add_argument("--data_path", default="")
    p.add_argument("--dress_types", default="dress,shirt,toptee")
    return p


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Write both JSON files; returns the path of optimized_images.json."""
    args = build_parser().parse_args(argv)
    data_path = args.data_path or ("fashionIQ_dataset" if args.dataset == "fiq"
                                   else "cirr_dataset")
    ds = CIRDataset(args.dataset, "train", "relative",
                    ImageTransform("targetpad", 224), data_path,
                    args.dress_types.split(",") if args.dataset == "fiq"
                    else None)
    out = deduplicate(ds, data_path)
    print(f"wrote {out} ({ds.num_unique_images} images scanned)")
    return out


if __name__ == "__main__":
    main()
