"""The port's program spans (utils/profiling.py) on the CPU.

A tiny fp32 codec served through ``Speech2Token``: with no profiler a
request records nothing and enters no ``record_function``; under
``torch.profiler`` every serving span is recorded with its parent and the
request's id, at the times of the trace's own ``funcodec::`` events. The
once-a-process set-up spans are recorded either way.
"""

import ctypes
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from funcodec_tpu_torch.cli.codec_inference import Speech2Token
from funcodec_tpu_torch.kernels import build
from funcodec_tpu_torch.utils import profiling
from funcodec_tpu_torch.utils.profiling import SPAN_PREFIX, SpanRecorder

torch.set_num_threads(1)

SEANET = {"norm": "time_group_norm", "n_filters": 4, "ratios": [4, 2]}
CONFIG = {
    "input_size": 1,
    "encoder": "encodec_seanet_encoder", "encoder_conf": SEANET,
    "decoder": "encodec_seanet_decoder", "decoder_conf": SEANET,
    "quantizer": "costume_quantizer",
    "quantizer_conf": {"codebook_size": 32, "num_quantizers": 4, "kmeans_init": False,
                       "sampling_rate": 16000, "encoder_hop_length": 8},
    "model": "encodec",
    "model_conf": {"odim": 16, "target_sample_hz": 16000, "audio_normalize": True, "segment_dur": None,
                   "overlap_ratio": None},
}
ILENS = [800, 700, 600, 500]
# a span's own stamps, taken just inside the record_function range, against the
# kineto event of that range
CLOCK_TOL_NS = 100_000

# (span, parent) of one request, dispatch and collect, by run mode; d2h once a copy
INFERENCE = [("h2d", "dispatch"), ("encode", "dispatch"), ("quantize", "dispatch"), ("decode", "dispatch"),
             ("pcm16.lengths", "pcm16"), ("pcm16", "dispatch"), ("dispatch", None),
             ("d2h", "collect"), ("d2h", "collect"), ("collect", None)]
EXPECTED = {
    ("inference", 1): INFERENCE,
    ("inference", 2): INFERENCE[:6] * 2 + INFERENCE[6:7] + INFERENCE[7:9] * 2 + INFERENCE[9:],
    ("encode", 1): [("h2d", "dispatch"), ("encode", "dispatch"), ("quantize", "dispatch"), ("dispatch", None),
                    ("d2h", "collect"), ("collect", None)],
    ("decode", 1): [("h2d", "dispatch"), ("quantize", "dispatch"), ("decode", "dispatch"), ("pcm16.lengths", "pcm16"),
                    ("pcm16", "dispatch"), ("dispatch", None), ("d2h", "collect"), ("collect", None)],
}
WAITS = {"pcm16.lengths", "d2h"}


@pytest.fixture(scope="module")
def models():
    return {n: Speech2Token(CONFIG, None, bit_width=None, devices=["cpu"] * n) for n in (1, 2)}


def _request(s2t: Speech2Token, run_mod: str = "inference"):
    rs = np.random.RandomState(3)
    if run_mod == "decode":
        x = rs.randint(0, 32, (len(ILENS), max(ILENS) // 8, 4))  # tokens at the hop of 8
    else:
        x = (rs.randn(len(ILENS), max(ILENS)) * 3000).astype(np.int16)
    recon = run_mod != "encode"  # as inference_pipeline serves each mode
    out = s2t.dispatch(x, need_recon=recon, run_mod=run_mod, pcm16_ilens=ILENS if recon else None)
    return s2t.collect(out, need_sub_quants=False)


def _profiled(fn):
    """fn() under a CPU profiler (one profiled call first: the first
    record_function of a process is slow to enter) -> (result, kineto
    events of the program's spans)."""
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("warm-up"):
            pass
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith(SPAN_PREFIX)]
    return out, events


def test_no_profiler_records_nothing(models, monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name, *args, **kwargs):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    profiling.clear()
    codes, _, recon, _ = _request(models[1])
    assert profiling.spans() == [] and entered == []
    assert codes[0].shape == (4, len(ILENS), 100) and recon.dtype == np.int16
    assert profiling.span("dispatch") is profiling.span("encode")  # the one shared null context


@pytest.mark.parametrize("run_mod,replicas", sorted(EXPECTED))
def test_serving_spans_and_parents(models, run_mod, replicas):
    _profiled(lambda: _request(models[replicas], run_mod))
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == EXPECTED[run_mod, replicas]
    ids = {s.request_id for s in got}
    assert len(ids) == 1 and ids.pop() is not None  # dispatch and collect share the batch's id
    assert all(s.wait == (s.name in WAITS) for s in got)
    assert all(s.t0_ns <= s.t1_ns and s.events is None for s in got)
    assert profiling.device_ms("encode") is None  # no CUDA events on the CPU


def test_request_ids_count_batches(models):
    s2t = models[1]
    _profiled(lambda: [_request(s2t) for _ in range(3)])
    roots = [s for s in profiling.spans() if s.parent is None]
    first = roots[0].request_id
    assert [(s.name, s.request_id) for s in roots] == [
        (n, first + i) for i in range(3) for n in ("dispatch", "collect")]


def test_self_time_is_duration_less_children(models):
    _profiled(lambda: _request(models[2]))
    got = profiling.spans()
    for parent in ("dispatch", "pcm16", "collect"):
        for p in [s for s in got if s.name == parent]:
            kids = [s for s in got if s.parent == parent and p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns]
            assert kids and p.self_ns == p.host_ns - sum(k.host_ns for k in kids)
    leaves = [s for s in got if s.name in ("encode", "quantize", "decode", "d2h", "h2d")]
    assert leaves and all(s.self_ns == s.host_ns for s in leaves)


def test_nested_self_time():
    rec = SpanRecorder()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("outer"):
            for _ in range(2):
                with rec.span("inner"):
                    time.sleep(0.002)
            time.sleep(0.001)
    assert [s.name for s in rec.spans()] == ["inner", "inner", "outer"]
    outer = rec.spans("outer")[0]
    assert outer.child_ns == sum(s.host_ns for s in rec.spans("inner")) >= 4_000_000
    assert 1_000_000 <= outer.self_ns == outer.host_ns - outer.child_ns


@pytest.mark.parametrize("run_mod,replicas", [("inference", 1), ("inference", 2), ("decode", 1)])
def test_spans_on_the_profilers_clock(models, run_mod, replicas):
    _, events = _profiled(lambda: _request(models[replicas], run_mod))
    got = profiling.spans()
    by_name = {}
    for e in sorted(events, key=lambda e: e.start_ns()):
        by_name.setdefault(e.name()[len(SPAN_PREFIX):], []).append(e)
    assert sorted(by_name) == sorted({s.name for s in got})
    offsets = []
    for s in sorted(got, key=lambda s: s.t0_ns):
        e = by_name[s.name].pop(0)
        t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
        # stamped inside the event's range: a descheduled process widens the gap, never reverses it
        assert t0 - CLOCK_TOL_NS <= s.t0_ns <= s.t1_ns <= t1 + CLOCK_TOL_NS, s.name
        offsets += [abs(s.t0_ns - t0), abs(s.t1_ns - t1)]
    assert all(not left for left in by_name.values())
    assert np.median(offsets) <= CLOCK_TOL_NS


def test_init_is_recorded_without_a_profiler():
    profiling.clear()
    t0 = time.time_ns()
    Speech2Token(CONFIG, None, devices=["cpu"])
    (init,) = profiling.spans("init")
    assert t0 <= init.t0_ns < init.t1_ns <= time.time_ns()
    assert init.parent is None and not init.wait


def test_kernel_library_load_is_recorded_without_a_profiler(monkeypatch, tmp_path):
    class Library:
        def __getattr__(self, name):
            return type("Entry", (), {})()

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build", lambda: tmp_path / "libfuncodec_kernels.so")
    monkeypatch.setattr(ctypes, "CDLL", lambda path: Library())
    profiling.clear()
    build.load()
    build.load()  # loaded once a process
    (load,) = profiling.spans("kernels.load")
    assert load.t0_ns <= load.t1_ns and load.parent is None


@pytest.mark.parametrize("maxlen", [1, 8])
def test_list_stays_within_its_bound(maxlen):
    rec = SpanRecorder(maxlen)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3 * maxlen + 2):
            with rec.span(f"s{i}"):
                pass
    assert [s.name for s in rec.spans()] == [f"s{i}" for i in range(2 * maxlen + 2, 3 * maxlen + 2)]
    rec.clear()
    assert rec.spans() == []


def test_spans_within_a_window():
    rec = SpanRecorder()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("a"):
            pass
        mid = time.time_ns()
        with rec.span("b"):
            pass
    assert [s.name for s in rec.spans(within=(mid, time.time_ns()))] == ["b"]
    assert rec.spans("a", within=(mid, time.time_ns())) == []
