"""The TTS service on a card: the serving session's CUDA graph step against
its eager step, and the synthesis that hides behind a decode segment.

The model is the benchmark's LauraTTS configuration as served
(``benchmark/configs/lauratts_libritts.json``: bf16 LM weights and KV
cache, the bf16 codec, the kernel switches), with the program's own random
weights, at the cell's 64 slots, 25-step segments and caps of 100-482
groups. This file imports neither JAX nor the JAX package. On a machine
with a card:

    python -m pytest --noconftest -q tests/test_torch_serving_graph.py
"""

import importlib
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import laura as laura_side
from funcodec_tpu_torch.cli.text2audio_inference import Text2Audio

CONFIG = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / "lauratts_libritts.json"
SLOTS, SEGMENT, CAPS, TEXT = 64, 25, (100, 482), (24, 116)
STEPS = 50  # two segments compared step for step


@pytest.fixture(scope="module")
def pipe():
    """A bf16 Text2Audio of the cell's configuration, the switches set for
    the module's tests and put back after them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph and the overlap are of CUDA work")
    conf = json.loads(CONFIG.read_text())
    with pytest.MonkeyPatch.context() as mp:
        for path, value in conf["flags"].items():
            module, attr = path.rsplit(".", 1)
            mp.setattr(importlib.import_module(module), attr, value)
        yield Text2Audio(conf["laura"], None, conf["funcodec"], None, token_list=conf["token_list"],
                         sampling=conf["top_k"], device="cuda", dtype=conf["dtype"])
        torch.cuda.synchronize()


def _serve(pipe, n: int, polls: int, seed: int):
    """A 64-slot session given n requests and run `polls` ticks: rows in
    flight at every stage, slots re-admitted over stale rows."""
    rs = np.random.RandomState(seed)
    sess = pipe.start_serving(SLOTS, max_length=CAPS[1], prefix_budget=TEXT[1] + 2, segment_steps=SEGMENT)
    ids = np.arange(3, len(pipe.converter.token_list))  # no <blank>, <unk>, <sos/eos>
    for i in range(n):
        pipe.submit(f"r{i}", rs.choice(ids, rs.randint(*TEXT)), seed=int(rs.randint(0, 2**62)),
                    cap=int(rs.randint(*CAPS)))
    for _ in range(polls):
        pipe.poll()
    return sess


def _state(sess):
    return [sess.logits, sess.toks, sess.counts, sess.live, sess.cache.length, *sess.cache.k, *sess.cache.v]


@pytest.mark.gpu
def test_graph_step_equals_the_eager_step_at_64_slots_bf16(pipe):
    """From one state of a running 64-slot bf16 session, 50 steps of the
    captured graph and 50 of the eager step give the same groups, counts,
    logits and cache, bit for bit."""
    sess = _serve(pipe, 4 * SLOTS, polls=14, seed=1)
    assert sess._graph is not None and int(sess.live.sum()) > SLOTS // 2
    with torch.inference_mode():
        saved = [t.clone() for t in _state(sess)]
        sess._segment(STEPS)
        by_graph = [t.clone() for t in _state(sess)]
        for t, s in zip(_state(sess), saved):
            t.copy_(s)
        graph, sess._graph = sess._graph, None
        try:
            sess._segment(STEPS)
        finally:
            sess._graph = graph
    emitted = int((sess.counts - saved[2]).sum())
    assert emitted > STEPS * SLOTS // 2
    for got, want in zip(by_graph, _state(sess)):
        assert torch.equal(got, want)
    assert laura_side.graph_flip(SimpleNamespace(t2a=pipe)) == 0.0


@pytest.mark.gpu
def test_graph_flip_sees_a_step_captured_over_a_stale_tensor(pipe):
    """A session whose graph reads a tensor that the admissions no longer
    write (its seeds replaced after the capture) draws other groups than
    the eager step: the benchmark's graph_flip reads above 0."""
    sess = pipe.start_serving(SLOTS, max_length=CAPS[1], prefix_budget=TEXT[1] + 2, segment_steps=SEGMENT)
    sess.seeds = sess.seeds.clone()  # the graph keeps reading the old one
    rs = np.random.RandomState(2)
    ids = np.arange(3, len(pipe.converter.token_list))
    for i in range(SLOTS):
        pipe.submit(f"s{i}", rs.choice(ids, rs.randint(*TEXT)), seed=int(rs.randint(1, 2**62)),
                    cap=int(rs.randint(*CAPS)))
    pipe.poll()
    assert laura_side.graph_flip(SimpleNamespace(t2a=pipe)) > 0.5


@pytest.mark.gpu
def test_synthesis_and_admission_make_no_synchronising_call(pipe):
    """The synthesis queued behind a segment, and the admissions (staged
    behind a segment or not), launch their work without waiting for the
    card (torch's sync debug mode raises on a synchronising call); the
    syntheses come back cut to their frames."""
    _serve(pipe, 0, polls=0, seed=3)
    launch, admit, stage = pipe._launch_synth, pipe.session._admit_ready, pipe.session._stage
    calls = {"synth": 0, "admit": 0, "stage": 0}

    def strict(name, fn):
        def run(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                calls[name] += 1
        return run

    pipe._launch_synth = strict("synth", launch)
    pipe.session._admit_ready = strict("admit", admit)
    pipe.session._stage = strict("stage", stage)
    try:
        rs = np.random.RandomState(4)
        ids = np.arange(3, len(pipe.converter.token_list))
        caps = rs.randint(20, 60, 2 * SLOTS)
        for i, cap in enumerate(caps):
            pipe.submit(f"q{i}", rs.choice(ids, rs.randint(*TEXT)), cap=int(cap))
        served = {}
        while pipe.serving_busy:
            served.update(pipe.poll())
    finally:
        del pipe._launch_synth, pipe.session._admit_ready, pipe.session._stage
    assert calls["synth"] > 1 and calls["admit"] > 1 and calls["stage"] > 1 and len(served) == len(caps)
    for i, cap in enumerate(caps):
        out = served[f"q{i}"]
        assert len(out["tokens"]) <= cap
        assert out["gen"].shape == (len(out["tokens"]) * pipe.codec.hop_length,) and np.isfinite(out["gen"]).all()
