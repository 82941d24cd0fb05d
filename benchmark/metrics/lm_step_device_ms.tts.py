"""Device milliseconds a decode step between the two CUDA events of the
program's ``lm_segment`` spans (one segment's sampling and LM steps over
every slot), over the traced slice's decode steps. None where the program
records no such span (a program without it, or the CPU)."""

from benchmark.harness.laura import span_ms


def read(run):
    return span_ms(run, "lm_segment", "steps")
