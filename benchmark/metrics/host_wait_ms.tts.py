"""Host milliseconds a decode segment spends in the program's ``harvest``
span (the segment's one readback of live flags, counts and tokens: a wait
for the segment's device work), over the traced slice's segments."""

from benchmark.harness.laura import span_ms


def read(run):
    return span_ms(run, "harvest", "segments", device=False)
