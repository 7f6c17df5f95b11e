"""Device idle a decode step inside `llm.decode` (`models/generation.py:
decode_loop`), where the host issues the step's ~1,500 launches (27 layers
of latent attention, routing, #14 and the combine) and samples: launches
that reach an idle card."""

from cirbench.spans import idle_ms

SPANS = ("llm.decode",)


def read(r):
    return idle_ms(r.trace, SPANS, "llm.decode")
