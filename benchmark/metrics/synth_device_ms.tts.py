"""Device milliseconds a synthesised request between the two CUDA events of
the program's ``synth`` spans (``Text2Audio.poll``: a tick's finished
requests together through the text encoder, the NAR codec encoder and the
codec's decode_emb), over the requests the traced slice synthesised. None
where the program records no such span."""

from benchmark.harness.laura import span_ms


def read(run):
    return span_ms(run, "synth", "synthesized")
