"""Device idle a batch inside the bank encode (`bank.encode` of
`Blip2CIR.fusion_bank_features`), where the host issues the EVA-g, fusion
and query work: launches that reach an idle card."""

from cirbench.spans import idle_ms

SPANS = ("bank.encode",)


def read(r):
    return idle_ms(r.trace, SPANS, "bank.encode")
