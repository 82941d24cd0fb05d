"""Device milliseconds a batch in FreqCodec's 2D convs: every device op of
the traced slice whose name ``costs/freqcodec.json`` lists (cuDNN's conv
kernels and the layout transposes around them), over the slice's batches."""

from benchmark.costs.freqcodec import is_conv2d


def read(run):
    trace, batches = run.tracer.result, run.work.get("batches")
    if trace is None or not batches:
        return None
    seconds, count = trace.kernel_seconds(is_conv2d)
    return 1e3 * seconds / len(batches) if count else None
