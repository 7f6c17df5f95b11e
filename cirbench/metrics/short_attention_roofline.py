"""Kernels #1 + #2 (`ops/attention_kernels.py`, `csrc/short_attention.cu`)
in the text tower of a stage-2 step: the least time of every launch at its
shape, over their summed device time in the trace."""

from cirbench.counts.kernels import attention_bwd_s, attention_fwd_s


def read(r):
    s = r.shapes
    cfg = s["config"]
    fwd = r.counters.get("short_attention", 0)
    bwd = r.counters.get("short_attention_bwd", 0)
    kernel_s = r.trace.kernel_s("short_attention")
    if kernel_s <= 0 or fwd + bwd == 0:
        return None
    heads = cfg["transformer_heads"]
    shape = (s["batch"] * heads, cfg["context_length"],
             cfg["transformer_width"] // heads, True, cfg["dtype"])
    bound = fwd * attention_fwd_s(*shape) + bwd * attention_bwd_s(*shape)
    return 100.0 * bound / kernel_s
