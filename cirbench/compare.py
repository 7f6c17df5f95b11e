"""The numbers that decide `correct`, worked out from the program's outputs
and the plain reference's. Each is a gap: 0 where the two agree."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

#: a leaf element whose reference gradient is under this share of the
#: median leaf's RMS gradient moves under Adam by round-off alone; it is
#: left out of the parameters' change (a key's bias under softmax)
STILL_SHARE = 1e-3


def _norms(leaves: Dict[str, Optional[torch.Tensor]],
           masks: Optional[Dict[str, torch.Tensor]] = None
           ) -> Dict[str, float]:
    out = {}
    for k, v in leaves.items():
        if v is None:
            out[k] = 0.0
            continue
        v = v.double()
        if masks is not None:
            v = v[masks[k]]
        out[k] = float(v.norm())
    return out


def leaf_gaps(prog: Dict[str, Optional[torch.Tensor]],
              ref: Dict[str, Optional[torch.Tensor]],
              masks: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, float]:
    """Per leaf of the reference, | |prog| - |ref| | over the larger of |ref|
    and the median leaf's |ref|. A leaf the program lacks reads as zero."""
    keys = [k for k, v in ref.items() if v is not None]
    ref_n = _norms({k: ref[k] for k in keys}, masks)
    prog_n = _norms({k: prog.get(k) for k in keys}, masks)
    median = float(torch.tensor(sorted(ref_n.values())).median())
    out = {}
    for k in keys:
        scale = max(ref_n[k], median)
        if scale > 0.0:
            gap = abs(prog_n[k] - ref_n[k]) / scale
            out[k] = gap if math.isfinite(gap) else math.inf
    return out


def still_masks(ref_grads: Dict[str, Optional[torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """Per leaf, the elements that move by more than round-off: reference
    gradient at least STILL_SHARE of the median leaf's RMS gradient."""
    rms = sorted(float(g.double().pow(2).mean().sqrt())
                 for g in ref_grads.values() if g is not None)
    floor = STILL_SHARE * rms[len(rms) // 2]
    return {k: (g.abs() >= floor) if g is not None else None
            for k, g in ref_grads.items()}


def train_gaps(prog_losses: List[float], prog_grads, prog_delta,
               ref_losses: List[float], ref_grads, ref_delta
               ) -> Dict[str, float]:
    """loss_gap: the largest relative gap of a step's loss; grad_gap: the
    worst leaf's gap of the first gradient's norm; change_gap: the worst
    leaf's gap of the norm of the change after the steps, over the elements
    that `still_masks` keeps."""
    steps = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
             for p, r in zip(prog_losses, ref_losses)]
    masks = still_masks(ref_grads)
    keep = {k: m for k, m in masks.items() if m is not None}
    grads = leaf_gaps(prog_grads, ref_grads)
    change = leaf_gaps(prog_delta, {k: ref_delta[k] for k in keep}, keep)
    return {"loss_gap": max(steps),
            "grad_gap": max(grads.values(), default=0.0),
            "change_gap": max(change.values(), default=0.0)}


def train_detail(prog_losses, prog_grads, prog_delta, ref_losses, ref_grads,
                 ref_delta) -> Dict[str, object]:
    """Diagnostics beside `train_gaps`: each step's loss gap, the median
    leaf's gaps and the three worst leaves of each norm."""
    masks = still_masks(ref_grads)
    keep = {k: m for k, m in masks.items() if m is not None}
    grads = leaf_gaps(prog_grads, ref_grads)
    change = leaf_gaps(prog_delta, {k: ref_delta[k] for k in keep}, keep)

    def median(d):
        v = sorted(d.values())
        return v[len(v) // 2] if v else 0.0

    def worst(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:3]

    return {"step_loss_gaps": [abs(p - r) / abs(r)
                               for p, r in zip(prog_losses, ref_losses)],
            "grad_gap_median": median(grads),
            "change_gap_median": median(change),
            "grad_worst": worst(grads), "change_worst": worst(change)}
