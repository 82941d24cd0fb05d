"""Host milliseconds a batch spends in the program's spans marked ``wait``
(the synchronising copies: ``pcm16.lengths``'s upload of the valid lengths,
``collect``'s ``d2h`` copies), mean over the traced slice's batches."""


def read(run):
    try:
        from funcodec_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    t, batches = run.tracer.result, run.work.get("batches")
    if t is None or not batches:
        return None
    got = spans(within=(t.t0_ns, t.t1_ns))
    return 1e-6 * sum(s.host_ns for s in got if s.wait) / len(batches) if got else None
