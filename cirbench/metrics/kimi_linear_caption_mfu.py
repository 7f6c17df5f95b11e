"""The Kimi-Linear captioner's model FLOPs per batch at the held share of the
experts (tower, prefill, decode, the head at each decoded position:
`cirbench/counts/kimi_linear.py`) over the batch time measured outside the
profiler window, as a share of the bf16 peak (989 TFLOP/s)."""

from cirbench.counts.kimi_linear import caption_batch
from cirbench.counts.peaks import PEAK_FLOPS


def read(r):
    s = getattr(r, "shapes", None)
    if (getattr(r, "batch_s", None) is None or not s or "prompt_len" not in s
            or "linear_attn_config" not in s.get("config", {})):
        return None
    flops = caption_batch(s["batch"], s["prompt_len"], s["new_tokens"],
                          s["config"])
    return 100.0 * flops / (r.batch_s * PEAK_FLOPS["bfloat16"])
