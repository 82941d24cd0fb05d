"""Device milliseconds an admitted request between the two CUDA events of
the program's ``admit`` spans (a tick's admissions together: their prefix
embeddings, the text encoder included, and their prefill into the slots),
over the requests the traced slice admitted. None where the program records
no such span."""

from benchmark.harness.laura import span_ms


def read(run):
    return span_ms(run, "admit", "admitted")
