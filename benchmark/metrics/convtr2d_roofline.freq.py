"""The port's grouped transposed 2D conv kernel against its roofline: the
least time of the traced slice's transposed 2D convs (x, the weights and the
kept output moved once, costs/convtr2d.py) over the time the trace gives the
device functions named ``convtr2d``. None where the slice ran none of them
(cuDNN's route)."""

from benchmark.costs.convtr2d import convtr2d_bound_s, is_convtr2d


def read(run):
    trace, batches = run.tracer.result, run.work.get("batches")
    if trace is None or not batches:
        return None
    seconds, count = trace.kernel_seconds(is_convtr2d)
    if not count:
        return None
    return 100.0 * sum(convtr2d_bound_s(run.work["codec"], B, T) for B, T in batches) / seconds
