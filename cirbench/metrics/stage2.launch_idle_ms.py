"""Device idle a stage-2 step while the host issues the forward and the
backward (`stage2.forward`, `stage2.backward`): launches that reach an idle
card, what fewer or graphed launches would take back."""

from cirbench.spans import idle_ms

SPANS = ("stage2.forward", "stage2.backward")


def read(r):
    return idle_ms(r.trace, SPANS, "stage2.step")
