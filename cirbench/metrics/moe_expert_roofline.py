"""Kernel #14 (`ops/moe_grouped.py`, `csrc/moe_grouped.cu`) in every MoE
layer of the traced batch: the least time of its launches, from the rows and
the experts hit that it sums on the device by route (the larger of the bytes
at 3.35 TB/s and the FLOPs at 989 TFLOP/s), over the summed device time of
its kernels by name in the trace. None without them (a program without the
kernel)."""

from cirbench.counts.moonlight import moe_expert_s

KERNEL = "moe_gemm_kernel"


def read(r):
    counters = getattr(r, "counters", None) or {}
    stats = counters.get("moe_stats")
    kernel_s = r.trace.kernel_s(KERNEL)
    if not stats or kernel_s <= 0:
        return None
    cfg = r.shapes["config"]
    bound = moe_expert_s(stats, cfg["hidden_size"], cfg["moe_intermediate_size"])
    return 100.0 * bound / kernel_s
