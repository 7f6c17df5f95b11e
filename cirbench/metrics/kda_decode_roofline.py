"""Kernel #15's decode entry (`ops/kda.py`, `csrc/kda.cu`), one launch a KDA
layer and decode step of the traced batch: the least time of each launch
from the shapes alone (`cirbench/counts/kimi_linear.py`: the float32 state
read once and written once, q, k, g, v and β read and o written, at 3.35
TB/s; the recurrence's FLOPs at 989 TFLOP/s; the larger), times the
launches the program counted (graph replays included), over the summed
device time of `kda_decode_kernel` in the trace. None without them (a
program without the kernel)."""

from cirbench.counts.kimi_linear import kda_decode_s, kda_shape

KERNEL = "kda_decode_kernel"


def read(r):
    launches = (getattr(r, "counters", None) or {}).get("kda_decode", 0)
    kernel_s = r.trace.kernel_s(KERNEL)
    if not launches or kernel_s <= 0:
        return None
    heads, d, _ = kda_shape(r.shapes["config"])
    return 100.0 * launches * kda_decode_s(r.shapes["batch"], heads, d) / kernel_s
