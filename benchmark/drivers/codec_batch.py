"""Closed-loop bulk codec serving: a corpus tokenized and reconstructed in
length-sorted batches, as ``cli/codec_inference.inference_pipeline``
drives ``Speech2Token``: batch i+1 is dispatched before batch i is
collected (``pipeline_depth`` in flight), int16 PCM goes in and PCM16
comes back.

Set-up assembles one shard: the mix's length law at ``shard_utterances``
quantiles, sorted, cut into batches of ``batch`` and wrap-padded to the
bucket, each utterance's audio cut by the seed from a PCM pool. It then
serves one batch of each padded shape, a few times over and pipelined as
the window is, which warms every shape the window uses. The window serves
the shard's batches over and over until ``--seconds`` have passed (no
batch is assembled inside it), then collects what is in flight; the rate
is the real audio of every collected batch over the whole window.

The check's sample is drawn by the seed from every batch the window
collected (one candidate row a batch, a reservoir of ``sample_max``), with
the first of the longest rows served beside it.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from benchmark.harness import codec as codec_side
from benchmark.harness import traffic
from benchmark.harness.codec import CodecProgram, keep
from benchmark.harness.context import Run

WARM_PASSES = 4
SEGMENT_S = 10.0


class State:
    def __init__(self, run: Run):
        tr = run.cell.traffic
        self.prog = CodecProgram(run)
        sr, hop = self.prog.sr, self.prog.hop
        lengths = np.sort((traffic.quantiles(tr["length_s"], tr["shard_utterances"]) * sr).astype(np.int64))
        pool = traffic.pcm_pool(tr["pool_s"], sr, run.seed, run.device)
        offsets = traffic.rng(run.seed, 3).integers(0, pool.shape[0] - lengths + 1)
        # (pcm (B, padded) int16, valid lengths) of each batch of the shard
        self.batches = [(traffic.wrap_pad([pool[o: o + n] for o, n in zip(offsets[a:b], lengths[a:b])], padded),
                         lengths[a:b].tolist())
                        for a, b, padded in traffic.sorted_batches(lengths, tr["batch"], hop, tr["bucket_frames"])]
        self.depth = int(tr.get("pipeline_depth", 2))
        self.sample_max = int(tr.get("sample_max", 16))
        self.sample_rng = traffic.rng(run.seed, 1)
        self.offered = 0
        self.samples: list = []
        self.longest: list = []

    def offer(self, pcm, lens, tokens, recon) -> None:
        """One seeded row of a collected batch, offered to the reservoir; the
        batch's longest row, if longer than any kept so far."""
        n, self.offered = self.offered, self.offered + 1
        r = int(self.sample_rng.integers(0, len(lens)))
        j = n if n < self.sample_max else int(self.sample_rng.integers(0, n + 1))
        if j < self.sample_max:
            row: list = []
            keep(row, pcm[r], lens[r], tokens[:, r], recon[r])
            if j < len(self.samples):
                self.samples[j] = row[0]
            else:
                self.samples.append(row[0])
        r = int(np.argmax(lens))
        if not self.longest or lens[r] > self.longest[0]["ilen"]:
            self.longest = []
            keep(self.longest, pcm[r], lens[r], tokens[:, r], recon[r])

    def judged(self) -> list:
        return self.samples + self.longest


def setup(run: Run) -> State:
    st = State(run)
    shapes = {}
    for pcm, lens in st.batches:
        shapes.setdefault(pcm.shape, (pcm, lens))
    pending: collections.deque = collections.deque()
    for pcm, lens in list(shapes.values()) * WARM_PASSES:
        pending.append(st.prog.serve(pcm, lens))
        if len(pending) >= st.depth:
            st.prog.collect(pending.popleft())
    while pending:
        st.prog.collect(pending.popleft())
    return st


def window(run: Run, st: State) -> None:
    prog, spans, tracer = st.prog, run.spans, run.tracer
    pending: collections.deque = collections.deque()
    done = {"audio_s": 0.0, "utterances": 0, "batches": [], "at": []}

    def collect_one():
        pcm, lens, out = pending.popleft()
        with spans("collect"):
            tokens, recon = prog.collect(out)
        st.offer(pcm, lens, tokens, recon)
        done["audio_s"] += sum(lens) / prog.sr
        done["utterances"] += len(lens)
        done["batches"].append(tuple(pcm.shape))
        done["at"].append((time.perf_counter(), done["audio_s"]))

    def traced_work():
        run.work.update(batches=list(done["batches"]), audio_s=done["audio_s"], requests=done["utterances"],
                        dispatch_s=list(spans.seconds["dispatch"]))

    run.work.update(codec=prog.codec, n_q=prog.n_q)
    spans.active = True
    tracer.start()
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    trace_end = t0 + min(run.seconds, float(run.cell.traffic.get("trace_seconds", run.seconds)))
    k = 0
    while time.perf_counter() < deadline:
        pcm, lens = st.batches[k % len(st.batches)]
        k += 1
        with spans("dispatch"):
            out = prog.serve(pcm, lens)
        pending.append((pcm, lens, out))
        run.attempted += len(lens)
        if len(pending) >= st.depth:
            collect_one()
        if tracer.prof is not None and time.perf_counter() >= trace_end:
            while pending:
                collect_one()
            tracer.stop()
            traced_work()
    while pending:
        collect_one()
    t1 = time.perf_counter()
    if tracer.prof is not None:
        tracer.stop()
        traced_work()
    spans.active = False
    run.e2e["serve_audio_s_per_s"] = done["audio_s"] / (t1 - t0)
    run.failed = run.attempted - done["utterances"]
    run.notes.append(f"{len(done['batches'])} batches, {done['utterances']} utterances, "
                     f"{done['audio_s']:.1f} audio-s in {t1 - t0:.3f} s")
    run.notes.append(f"audio-s/s by {SEGMENT_S:g} s of the window: {segment_rates(done['at'], t0, t1)}")


def segment_rates(at: list, t0: float, t1: float) -> list:
    """The audio collected in each SEGMENT_S of the window over its length
    (the last segment the rest): how the rate moves within one run."""
    out, edge, before = [], t0, 0.0
    while edge < t1:
        end = min(edge + SEGMENT_S, t1)
        upto = max((a for t, a in at if t <= end), default=0.0)
        out.append(round((upto - before) / (end - edge), 1))
        edge, before = end, upto
    return out


def check(run: Run, st: State) -> None:
    codec_side.check(run, st.prog, st.judged())


def readings(run: Run, st: State, control: bool) -> dict:
    """The program's numbers on the kept requests, or (control) those of
    the fp8 control put in its place on the same requests."""
    st.prog.free()
    samples = st.judged()
    if control:
        samples = codec_side.control_samples(run, st.prog, samples)
    return codec_side.judge_samples(run, st.prog, samples)
