"""Host milliseconds a batch spends inside ``Speech2Token.dispatch`` (the
benchmark's span around the call), mean over the traced slice's batches."""


def read(run):
    s = run.work.get("dispatch_s")
    return 1e3 * sum(s) / len(s) if s else None
