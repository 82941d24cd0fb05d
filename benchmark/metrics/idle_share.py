"""Share (%) of the traced slice in which no op ran on the device; the
reader of every ``idle_share.<cells>`` metric."""


def read(run):
    t = run.tracer.result
    return None if t is None or t.window_s <= 0 else 100.0 * (1.0 - t.busy_s / t.window_s)
