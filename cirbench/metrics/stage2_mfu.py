"""The stage-2 step's model FLOPs over the step time measured outside the
profiler window, as a share of the bf16 peak (989 TFLOP/s)."""

from cirbench.counts.model import clip_text_step
from cirbench.counts.peaks import PEAK_FLOPS


def read(r):
    s = r.shapes
    if getattr(r, "step_s", None) is None or s["family"] != "clip":
        return None
    cfg = s["config"]
    flops = clip_text_step(s["batch"], cfg["context_length"],
                           cfg["transformer_width"], cfg["transformer_layers"],
                           cfg["embed_dim"], s["bank_rows"],
                           s["target_shape"][-1])
    return 100.0 * flops / (r.step_s * PEAK_FLOPS["bfloat16"])
