"""The share of the traced captioning window in which no kernel, copy or set
ran on the device: 1 - busy / window."""


def read(r):
    tr = r.trace
    if tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
