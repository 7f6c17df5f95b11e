"""Device idle a stage-2 step while the host runs the optimizer
(`stage2.optimizer`: zero_grad, the learning rate, AdamW's step); what a
fused or foreach AdamW would take back."""

from cirbench.spans import idle_ms

SPANS = ("stage2.optimizer",)


def read(r):
    return idle_ms(r.trace, SPANS, "stage2.step")
