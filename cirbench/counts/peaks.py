"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, no sparsity),
at its 700 W limit: the yardstick of every MFU and roofline share."""

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}


def bound_s(n_bytes: float, n_flops: float, peak: str) -> float:
    """The least time the chip could take: the larger of bytes over HBM
    bandwidth and operations over the peak rate of `peak`."""
    return max(n_bytes / HBM_BYTES_S, n_flops / PEAK_FLOPS[peak])
