"""Closed-loop bulk FreqCodec serving: ``codec_batch``'s loop (length-sorted
batches of int16 PCM through ``Speech2Token.dispatch`` / ``collect``,
``pipeline_depth`` in flight, PCM16 back) over the FreqCodec program, judged
against the FreqCodec reference (``harness/freqcodec.py``).

The window is ``codec_batch``'s. Set-up repeats ``codec_batch``'s (whose
``State`` builds its EnCodec program by name): one shard of the mix's
length law, wrap-padded to the bucket, every padded shape served a few
times over before the window. The check's sample is ``codec_batch``'s
seeded reservoir of the collected rows with the longest beside it.
"""

from __future__ import annotations

import collections

import numpy as np

from benchmark.drivers import codec_batch
from benchmark.drivers.codec_batch import window  # noqa: F401  (the serving loop, shared)
from benchmark.harness import freqcodec as freq_side
from benchmark.harness import traffic
from benchmark.harness.context import Run


class State(codec_batch.State):
    """codec_batch's shard and reservoir over a FreqProgram."""

    def __init__(self, run: Run):
        tr = run.cell.traffic
        self.prog = freq_side.FreqProgram(run)
        sr, hop = self.prog.sr, self.prog.hop
        lengths = np.sort((traffic.quantiles(tr["length_s"], tr["shard_utterances"]) * sr).astype(np.int64))
        pool = traffic.pcm_pool(tr["pool_s"], sr, run.seed, run.device)
        offsets = traffic.rng(run.seed, 3).integers(0, pool.shape[0] - lengths + 1)
        self.batches = [(traffic.wrap_pad([pool[o: o + n] for o, n in zip(offsets[a:b], lengths[a:b])], padded),
                         lengths[a:b].tolist())
                        for a, b, padded in traffic.sorted_batches(lengths, tr["batch"], hop, tr["bucket_frames"])]
        self.depth = int(tr.get("pipeline_depth", 2))
        self.sample_max = int(tr.get("sample_max", 16))
        self.sample_rng = traffic.rng(run.seed, 1)
        self.offered = 0
        self.samples: list = []
        self.longest: list = []


def setup(run: Run) -> State:
    st = State(run)
    shapes = {}
    for pcm, lens in st.batches:
        shapes.setdefault(pcm.shape, (pcm, lens))
    pending: collections.deque = collections.deque()
    for pcm, lens in list(shapes.values()) * codec_batch.WARM_PASSES:
        pending.append(st.prog.serve(pcm, lens))
        if len(pending) >= st.depth:
            st.prog.collect(pending.popleft())
    while pending:
        st.prog.collect(pending.popleft())
    return st


def check(run: Run, st: State) -> None:
    freq_side.check(run, st.prog, st.judged())


def readings(run: Run, st: State, control: bool) -> dict:
    """The program's numbers on the kept requests, or (control) those of
    the fp8 control put in its place on the same requests."""
    st.prog.free()
    samples = st.judged()
    if control:
        samples = freq_side.control_samples(run, st.prog, samples)
    return freq_side.judge_samples(run, st.prog, samples)
