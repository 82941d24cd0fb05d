"""Device idle milliseconds a batch outside the program: the gaps between
the traced slice's device ops whose middle falls in none of the program's
spans (the harness's own work between calls), mean over the slice's
batches. The spans' clock is the profiler's, so the two line up."""

import bisect


def read(run):
    try:
        from funcodec_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    t, batches = run.tracer.result, run.work.get("batches")
    if t is None or not batches:
        return None
    got = sorted(spans(within=(t.t0_ns, t.t1_ns)), key=lambda s: s.t0_ns)
    busy = t.busy_intervals()
    if not got or not busy:
        return None
    covered = []  # the spans merged into disjoint intervals
    for s in got:
        if covered and s.t0_ns <= covered[-1][1]:
            covered[-1][1] = max(covered[-1][1], s.t1_ns)
        else:
            covered.append([s.t0_ns, s.t1_ns])
    starts = [c[0] for c in covered]
    idle, last = 0, t.t0_ns
    for s, e in busy + [(t.t1_ns, t.t1_ns)]:
        if s > last:
            mid = (last + s) // 2
            i = bisect.bisect_right(starts, mid) - 1
            if i < 0 or mid >= covered[i][1]:
                idle += s - last
        last = max(last, e)
    return 1e-6 * idle / len(batches)
