"""The whole FreqCodec request's share (%) of the chip's bf16 peak over the
traced slice: the 2D stacks, LSTM, 1D tail and RVQ search FLOPs of the
slice's batches (from shapes, costs/freqcodec.py) over the slice's length."""

from benchmark.costs.codec import PEAKS
from benchmark.costs.freqcodec import serve_flops


def read(run):
    t, batches = run.tracer.result, run.work.get("batches")
    if t is None or not batches or t.window_s <= 0:
        return None
    flops = sum(serve_flops(run.work["codec"], B, T, run.work["n_q"]) for B, T in batches)
    return 100.0 * flops / (t.window_s * PEAKS["bf16_flops_per_s"])
