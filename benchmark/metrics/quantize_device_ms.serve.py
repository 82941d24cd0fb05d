"""Device milliseconds a batch spends between the two CUDA events of the
program's ``quantize`` span (the RVQ search and codeword gather,
``quantizer.inference``), recorded on the stream at the span's entry and
exit; mean over the traced slice's batches. None where no event was recorded
(the CPU)."""


def read(run):
    try:
        from funcodec_tpu_torch.utils.profiling import device_ms
    except ImportError:  # a program without spans
        return None
    t, batches = run.tracer.result, run.work.get("batches")
    if t is None or not batches:
        return None
    ms = device_ms("quantize", within=(t.t0_ns, t.t1_ns))
    return None if ms is None else ms / len(batches)
