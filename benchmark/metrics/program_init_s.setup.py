"""Seconds of the program's ``init`` span: ``Speech2Token``'s construction
(the model built and randomly initialised, weights loaded, parameters cast),
once a process in set-up."""


def read(run):
    try:
        from funcodec_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    got = spans("init")
    return got[-1].host_ns * 1e-9 if got else None
