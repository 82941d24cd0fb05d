"""Closed-loop bulk LauraTTS synthesis: a backlog of texts turned into speech
through ``Text2Audio``'s incremental API over one ``LauraServingSession``,
every slot kept full (a slot freed at a harvest re-admits at once).

Set-up draws the shard: ``requests`` caps at the quantiles of the mix's law
(a fixed multiset; the seed orders them), each request's text
ceil(phonemes_per_s x its seconds) phoneme ids and its sampling seed drawn
from the seed. It then warms what the window runs: a session's admissions at
every text bucket, its decode segments, harvests and batched syntheses, and
the codec's decode of every number of syntheses a tick can finish (their
length is fixed: ``Text2Audio.synth_frames``). Last it opens the
window's session and serves until ``preroll`` x slots requests have
finished, so that the window starts with every slot full, the rows at all
stages of their lengths, and past a fresh process's start-up slowness (the
mix's ``preroll_source``). The window goes on submitting the shard over
and over, keeping ``2 x slots`` requests outstanding, and polls until
``--seconds`` have passed; a request counts when its ``gen`` waveform is on
the host, by its unpadded length; rows still in flight when the window
closes are dropped, not drained.

The check's sample is a seeded reservoir of the window's finished requests
with the longest beside it, judged after the window (``harness/laura.py``).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from benchmark.drivers.codec_batch import segment_rates
from benchmark.harness import codec as codec_side
from benchmark.harness import laura as laura_side
from benchmark.harness import traffic
from benchmark.harness.context import Run

SPECIAL = ("<blank>", "<unk>", "<sos/eos>")  # token-list entries that are no phoneme


def _serving_api() -> None:
    """Exit at once, before any set-up, where the program has no incremental
    TTS serving API."""
    from funcodec_tpu_torch.cli.text2audio_inference import Text2Audio

    if not all(hasattr(Text2Audio, name) for name in ("start_serving", "submit", "poll")):
        print("benchmark: this program's Text2Audio has no incremental serving API (start_serving, submit, poll)",
              file=sys.stderr)
        raise SystemExit(2)


class State:
    def __init__(self, run: Run):
        tr = run.cell.traffic
        self.prog = laura_side.LauraProgram(run)
        n = int(tr["requests"])
        self.slots, self.segment = int(tr["slots"]), int(tr["segment_steps"])
        group_s = self.prog.hop / self.prog.sr
        order = traffic.rng(run.seed, 4).permutation(n)
        self.caps = np.round(traffic.quantiles(tr["cap_groups"], n)).astype(np.int64)[order]
        self.text_len = np.ceil(tr["phonemes_per_s"] * self.caps * group_s - 1e-9).astype(np.int64)
        phonemes = np.array([i for i, t in enumerate(self.prog.tokens) if t not in SPECIAL])
        r = traffic.rng(run.seed, 5)
        self.texts = [phonemes[r.integers(0, len(phonemes), int(m))] for m in self.text_len]
        self.seeds = traffic.rng(run.seed, 6).integers(0, 1 << 62, n)
        self.max_new = int(self.caps.max())
        self.prefix_budget = int(self.text_len.max()) + 2  # [sos, text, task], no prompt
        self.sample_max = int(tr.get("sample_max", 8))
        self.sample_rng = traffic.rng(run.seed, 1)
        self.offered = 0
        self.samples: list = []
        self.longest: list = []
        self.replayed = None
        self.graph_flip = None
        self.submitted: list = []  # shard index of each submission, in order (the session admits in that order)
        self.finished = 0  # requests the window's session returned

    def start(self):
        return self.prog.t2a.start_serving(self.slots, max_length=self.max_new, prefix_budget=self.prefix_budget,
                                           segment_steps=self.segment)

    def top_up(self) -> None:
        """Submit the shard's next requests (under names of their own) until
        2 x slots are outstanding."""
        while len(self.submitted) - self.finished < 2 * self.slots:
            k = len(self.submitted)
            i = k % len(self.caps)
            self.prog.t2a.submit(f"r{k}", self.texts[i], seed=int(self.seeds[i]), cap=int(self.caps[i]))
            self.submitted.append(i)

    def poll(self) -> list:
        """One tick of the window's session: (shard index, output) of each request that finished."""
        out = [(self.submitted[int(uid[1:])], o) for uid, o in self.prog.t2a.poll().items()]
        self.finished += len(out)
        self.top_up()
        return out

    def offer(self, i: int, out: dict) -> None:
        """A finished request offered to the seeded reservoir; the longest kept beside it."""
        row = dict(ids=self.texts[i], seed=int(self.seeds[i]), tokens=np.asarray(out["tokens"]).copy(),
                   gen=np.asarray(out["gen"]).copy(), frames=self.prog.t2a.synth_frames)
        n, self.offered = self.offered, self.offered + 1
        keep = self.sample_max - 1
        j = n if n < keep else int(self.sample_rng.integers(0, n + 1))
        if j < keep:
            if j < len(self.samples):
                self.samples[j] = row
            else:
                self.samples.append(row)
        if not self.longest or len(row["tokens"]) > len(self.longest[0]["tokens"]):
            self.longest = [row]

    def judged(self) -> list:
        return self.samples + self.longest


def setup(run: Run) -> State:
    _serving_api()
    st = State(run)
    t2a = st.prog.t2a
    # admissions at every text bucket of the session's prefix, segments, harvests and batched syntheses
    st.start()
    firsts = {}
    for i, m in enumerate(st.text_len):
        firsts.setdefault(-(-int(m) // t2a.session.text_bucket), i)
    warm = list(firsts.values())
    warm += [i for i in range(len(st.caps)) if i not in firsts.values()][: max(0, st.slots - len(warm))]
    for k, i in enumerate(warm):
        t2a.submit(f"warm{k}", st.texts[i], seed=int(st.seeds[i]), cap=st.segment)
    while t2a.serving_busy:
        t2a.poll()
    # the codec's decode of every batch of syntheses a tick can finish: 1 to slots rows
    emb = np.zeros((st.slots, t2a.synth_frames, t2a.model.cfg.codebook_dim), np.float32)
    for n in range(1, st.slots + 1):
        t2a.codec(emb[:n], run_mod="decode_emb")
    st.start()  # the window's session, served into its steady state
    st.top_up()
    while st.finished < int(run.cell.traffic["preroll"]) * st.slots:
        st.poll()
    return st


def window(run: Run, st: State) -> None:
    from funcodec_tpu_torch.cli.text2audio_inference import SYNTH_BUCKET

    t2a, spans, tracer = st.prog.t2a, run.spans, run.tracer
    hop, sr = st.prog.hop, st.prog.sr
    done = {"audio_s": 0.0, "requests": 0, "failed": 0, "early": 0, "at": []}
    submitted = st.submitted
    slice_synths: list = []

    def traced_work(stats0, t_stats):
        stats = t2a.stats
        delta = {k: stats[k] - stats0[k] for k in stats}
        run.work.update(delta, steps=delta["slot_steps"] // st.slots, slots=st.slots,
                        capacity=t2a.session.capacity, prefix_budget=st.prefix_budget,
                        text_bucket=t2a.session.text_bucket, bucket=SYNTH_BUCKET, synth_frames=t2a.synth_frames,
                        admitted_text=[int(st.text_len[i]) for i in submitted[stats0["admitted"]: stats["admitted"]]],
                        synths=list(slice_synths), polls=t_stats)

    run.work.update(model=st.prog.model, codec=st.prog.codec)
    spans.active = True
    launches0 = _launches()
    stats0 = dict(t2a.stats)
    tracer.start()
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    trace_end = t0 + min(run.seconds, float(run.cell.traffic.get("trace_seconds", run.seconds)))
    polls = 0
    while time.perf_counter() < deadline:
        with spans("poll"):
            finished = st.poll()
        polls += 1
        for i, out in finished:
            G, wav = len(out["tokens"]), out["gen"]
            if wav.shape != (G * hop,) or not np.isfinite(wav).all():
                done["failed"] += 1
                continue
            done["requests"] += 1
            done["early"] += int(G < st.caps[i])
            done["audio_s"] += G * hop / sr
            st.offer(i, out)
            if tracer.prof is not None:
                slice_synths.append((int(st.text_len[i]), G))
        done["at"].append((time.perf_counter(), done["audio_s"]))
        if tracer.prof is not None and time.perf_counter() >= trace_end:
            tracer.stop()
            traced_work(stats0, polls)
    t1 = time.perf_counter()
    if tracer.prof is not None:
        tracer.stop()
        traced_work(stats0, polls)
    spans.active = False
    stats = t2a.stats
    run.e2e["serve_audio_s_per_s"] = done["audio_s"] / (t1 - t0)
    run.attempted = done["requests"] + done["failed"]
    run.failed = done["failed"]
    synth = stats["synthesized"] - stats0["synthesized"]
    per_request = {k: (v - launches0[k]) / max(synth, 1) for k, v in _launches().items()}
    run.notes.append(f"{polls} polls, {done['requests']} requests, {done['audio_s']:.1f} audio-s in {t1 - t0:.3f} s; "
                     f"{done['early']} ended before their caps; {len(submitted) - st.finished} dropped in flight")
    run.notes.append(f"session: {stats['segments'] - stats0['segments']} segments, slot occupancy "
                     f"{(stats['live_steps'] - stats0['live_steps']) / max(stats['slot_steps'] - stats0['slot_steps'], 1):.4f}"
                     f", {stats['admitted'] - stats0['admitted']} admitted, {synth} synthesised")
    run.notes.append(f"SEANet kernel launches a synthesised request: {per_request}")
    run.notes.append(f"audio-s/s by 10 s of the window: {segment_rates(done['at'], t0, t1)}")


def _launches() -> dict:
    from funcodec_tpu_torch.ops import conv_kernel, resblock_kernel, tgn_kernel

    return {"conv1d_s1": conv_kernel.LAUNCHES, "resblock_tgn": resblock_kernel.LAUNCHES,
            "resblock_tgn_finalize": resblock_kernel.FINALIZE_LAUNCHES, "tgn_norm": tgn_kernel.LAUNCHES}


def _samples(st: State) -> list:
    """The judged requests with the program's replayed logits and served
    PCM16 (replayed once; the program is then freed)."""
    if st.replayed is None:
        samples = st.judged()
        if not samples:  # nothing finished in the window: nothing to judge, and no check passes
            st.prog.free()
            st.replayed = []
            return st.replayed
        st.graph_flip = laura_side.graph_flip(st.prog)
        logits = laura_side.replay_logits(st.prog, samples)
        st.replayed = [dict(s, logits=lg, pcm=laura_side.pcm16(s["gen"])) for s, lg in zip(samples, logits)]
        st.prog.free()
    return st.replayed


def check(run: Run, st: State) -> None:
    samples = _samples(st)
    numbers = laura_side.judge(st.prog, samples, run.device)
    if samples:
        numbers["graph_flip"] = st.graph_flip
    codec_side.record(run, numbers, len(samples))


def readings(run: Run, st: State, control: bool) -> dict:
    """The program's numbers on the kept requests, or (control) those of
    the fp8 control put in its place on the same requests."""
    samples = _samples(st)
    if control:
        samples = laura_side.control(st.prog, samples, run.device)
    return laura_side.judge(st.prog, samples, run.device)
