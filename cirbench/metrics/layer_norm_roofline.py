"""The LayerNorm kernel pair (`ops/layer_norm.py`, `csrc/layer_norm.cu`) in
the text tower of a stage-2 step: the least time of every forward and dx
launch in the trace at the cell's shape (rows = batch x context, the
tower's width; forward x read and y written, backward dy and x read and dx
written, the per-block partial sums left out), over the summed device time
of its three kernels. None where the trace holds none of them."""

from cirbench.counts.kernels import ITEM
from cirbench.counts.peaks import bound_s

KERNELS = ("ln_f32_fwd_kernel", "ln_f32_bwd_kernel", "ln_f32_dparams_kernel")


def launches(trace, name: str) -> int:
    return sum(1 for n, cat, _, _ in trace.device
               if cat == "kernel" and name in n)


def read(r):
    kernel_s = r.trace.kernel_s(*KERNELS)
    fwd = launches(r.trace, KERNELS[0])
    bwd = launches(r.trace, KERNELS[1])
    if kernel_s <= 0 or fwd + bwd == 0:
        return None
    cfg = r.shapes["config"]
    elems = r.shapes["batch"] * cfg["context_length"] * cfg["transformer_width"]
    item = ITEM[cfg["dtype"]]
    bound = (fwd * bound_s(2 * elems * item, 0, "float32")
             + bwd * bound_s(3 * elems * item, 0, "float32"))
    return 100.0 * bound / kernel_s
