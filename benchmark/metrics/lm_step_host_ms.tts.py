"""Host milliseconds a decode step spends in the program's ``lm_segment``
spans (``LauraServingSession.poll``: launching one segment's steps), over
the traced slice's decode steps."""

from benchmark.harness.laura import span_ms


def read(run):
    return span_ms(run, "lm_segment", "steps", device=False)
