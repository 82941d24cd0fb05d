"""Host milliseconds a batch spends in the program's ``decode`` span (the
SEANet decoder, ``Encodec._decode``) less its children's: the self time of
launching that layer's work, mean over the traced slice's batches."""


def read(run):
    try:
        from funcodec_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    t, batches = run.tracer.result, run.work.get("batches")
    if t is None or not batches:
        return None
    got = spans("decode", within=(t.t0_ns, t.t1_ns))
    return 1e-6 * sum(s.self_ns for s in got) / len(batches) if got else None
