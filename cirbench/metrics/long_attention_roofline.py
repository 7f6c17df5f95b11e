"""Kernel #3 (`ops/attention_kernels.py`, `csrc/long_attention.cu`) in the
EVA tower: the least time of every launch at (B * heads, tokens, head
size), over its summed device time in the trace."""

from cirbench.counts.kernels import attention_fwd_s


def read(r):
    cfg = r.shapes["config"]
    v = cfg["vision"]
    launches = r.counters.get("long_attention", 0)
    kernel_s = r.trace.kernel_s("long_attention")
    if kernel_s <= 0 or launches == 0:
        return None
    tokens = (v["image_size"] // v["patch_size"]) ** 2 + 1
    bound = attention_fwd_s(r.shapes["batch"] * v["heads"], tokens,
                            v["width"] // v["heads"], False, cfg["dtype"])
    return 100.0 * launches * bound / kernel_s
