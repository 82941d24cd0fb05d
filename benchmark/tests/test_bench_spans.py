"""The per-layer metrics read from the program's own spans, on the CPU at a
tiny size: each is listed for the cell, the host and set-up ones are
finite in a traced run, and the program's ``dispatch`` spans lie inside
the benchmark's ``bench::dispatch`` spans of the same batches."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark.harness import main

CELL = "encodec_nq32ds320.serve_batch"
SEED = 2**31 + 977
HOST = ["encode_host_ms.serve", "quantize_host_ms.serve", "decode_host_ms.serve", "host_wait_ms.serve"]
DEVICE = ["encode_device_ms.serve", "quantize_device_ms.serve", "decode_device_ms.serve",
          "idle_outside_program_ms.serve"]
SETUP = ["program_init_s.setup", "kernel_library_s.setup"]
# the two clocks' stamps of one span agree to a few microseconds on the CPU
CLOCK_TOL_NS = 100_000


@pytest.fixture()
def traced(tiny_root, monkeypatch):
    """(result, Run) of one traced run."""
    from funcodec_tpu_torch.utils import profiling

    runs = []

    class Kept(main.Run):
        def __post_init__(self):
            super().__post_init__()
            runs.append(self)

    monkeypatch.setattr(main, "Run", Kept)
    profiling.clear()
    res = main.execute(CELL, SEED, 1.0, True, torch.device("cpu"), time.perf_counter(), root=tiny_root)
    return res, runs[0]


def test_program_span_metrics_are_listed(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    mine = {m["name"]: m for m in spec["per_layer"] if m["source"] == "program_span"}
    assert set(HOST + DEVICE + SETUP) <= set(mine)
    for name in HOST + DEVICE + SETUP:
        assert mine[name]["workloads"] == [CELL]
        assert mine[name]["moves"] == ("setup_s" if name in SETUP else "serve_audio_s_per_s")


def test_host_and_setup_metrics_are_finite(traced):
    res, _ = traced
    assert res["correct"] is True, res["checks"]
    got = res["metrics"]
    for name in HOST + ["program_init_s.setup"]:
        assert np.isfinite(got[name]["value"]) and got[name]["value"] >= 0, name
    assert got["program_init_s.setup"]["unit"] == "s"
    # no device events and no kernel library on the CPU: those readers find nothing
    assert not set(got) & set(DEVICE + ["kernel_library_s.setup"])


def test_program_dispatch_inside_the_benchmarks(traced):
    from funcodec_tpu_torch.utils import profiling

    _, run = traced
    t = run.tracer.result
    outer = sorted((s, e) for name, s, e in t.host_spans if name == "dispatch")
    inner = profiling.spans("dispatch", within=(t.t0_ns, t.t1_ns))
    assert len(inner) == len(outer) == len(run.work["batches"]) > 0
    for (s, e), span in zip(outer, inner):
        assert s - CLOCK_TOL_NS <= span.t0_ns <= span.t1_ns <= e + CLOCK_TOL_NS
    collects = profiling.spans("collect", within=(t.t0_ns, t.t1_ns))
    assert [c.request_id for c in collects] == [d.request_id for d in inner]
