"""Device milliseconds a batch spends in kernels other than the port's own
(group norm, cuDNN convs and LSTM, copies, casts): every device op of the
traced slice whose name matches none of ``costs/kernels.json``, over the
slice's batches."""

from benchmark.costs.codec import is_port_kernel


def read(run):
    trace, batches = run.tracer.result, run.work.get("batches")
    if trace is None or not batches:
        return None
    seconds, _ = trace.kernel_seconds(lambda name: not is_port_kernel(name))
    return 1e3 * seconds / len(batches)
