"""Device idle a stage-2 step while the host waits for its batch, gathers
its refer rows, tokenizes its captions or copies them to the device
(`train/stage2.py:train_epoch`); what pinned or prefetched inputs would
take back."""

from cirbench.spans import idle_ms

SPANS = ("prefetch.wait", "stage2.gather_refer", "text.tokenize",
         "stage2.to_device")


def read(r):
    return idle_ms(r.trace, SPANS, "stage2.step")
