"""Kernels #5 + #6 (`ops/bank_kernels.py`): the least time their work could
take at the cell's shapes, over their summed device time in the trace."""

from cirbench.counts.kernels import bank_infonce_s


def read(r):
    s = r.shapes
    kernel_s = r.trace.kernel_s("bank_infonce")
    steps = r.counters.get("bank_infonce_fwd", 0)
    if kernel_s <= 0 or steps == 0:
        return None
    bound = bank_infonce_s(s["batch"], s["bank_rows"], s["target_shape"][-1],
                           s["bank_dtype"])
    return 100.0 * steps * bound / kernel_s
