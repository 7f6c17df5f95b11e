"""The bank encode's model FLOPs per batch over the batch time measured
outside the profiler window, as a share of the bf16 peak (989 TFLOP/s)."""

from cirbench.counts.model import blip2_bank_features
from cirbench.counts.peaks import PEAK_FLOPS


def read(r):
    if getattr(r, "batch_s", None) is None:
        return None
    cfg = r.shapes["config"]
    flops = blip2_bank_features(r.shapes["batch"], cfg["vision"],
                                cfg["qformer"], cfg["max_text_tokens"],
                                cfg["embed_dim"])
    return 100.0 * flops / (r.batch_s * PEAK_FLOPS["bfloat16"])
