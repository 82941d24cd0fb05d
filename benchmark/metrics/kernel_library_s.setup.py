"""Seconds of the program's ``kernels.load`` span: the kernel library built
with nvcc when no cached build matches the sources, then loaded; once a
process in set-up. None where no kernel was loaded (the CPU)."""


def read(run):
    try:
        from funcodec_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    got = spans("kernels.load")
    return got[-1].host_ns * 1e-9 if got else None
