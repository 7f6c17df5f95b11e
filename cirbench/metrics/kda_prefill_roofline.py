"""Kernel #15's prefill entry (`ops/kda.py`, `csrc/kda.cu`), one launch a KDA
layer a batch over the whole prompt: the least time of each launch from the
shapes alone (`cirbench/counts/kimi_linear.py`: q, k, g, v and β read and o
written for every prompt token, the final float32 state written once, at
3.35 TB/s; the recurrence's FLOPs at 989 TFLOP/s; the larger), times the
launches the program counted, over the summed device time of
`kda_prefill_kernel` in the trace. None without them."""

from cirbench.counts.kimi_linear import kda_prefill_s, kda_shape

KERNEL = "kda_prefill_kernel"


def read(r):
    launches = (getattr(r, "counters", None) or {}).get("kda_prefill", 0)
    kernel_s = r.trace.kernel_s(KERNEL)
    if not launches or kernel_s <= 0:
        return None
    heads, d, _ = kda_shape(r.shapes["config"])
    bound = kda_prefill_s(r.shapes["batch"], r.shapes["prompt_len"], heads, d)
    return 100.0 * launches * bound / kernel_s
