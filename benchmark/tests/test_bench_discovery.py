"""The harness finds a cell, a mix and a metric by their names alone: a
throwaway cell added as data files (and a metric reader as a file of its
own) in a copy of the benchmark runs and reports without a code change."""

import json
import time

import torch

from benchmark.harness import cell as cells
from benchmark.harness.main import execute


def test_throwaway_cell_mix_and_metric_are_found(tiny_root):
    bench = tiny_root / "benchmark"
    mix = json.loads((bench / "traffic/corpus_mean_b64.json").read_text())
    mix["length_s"] = {"law": "uniform", "min": 0.5, "max": 1.0}
    (bench / "traffic/throwaway_mix.json").write_text(json.dumps(mix))
    (bench / "workloads/encodec_nq32ds320.throwaway.json").write_text(
        json.dumps({"limits": {"token_gap": 0.05, "recon_err": 0.01}}))
    (bench / "metrics/throwaway_batches.serve.py").write_text(
        "def read(run):\n    return float(len(run.work.get('batches', []))) or None\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "encodec_nq32ds320.throwaway", "config": "encodec_nq32ds320",
                              "traffic": "throwaway_mix", "chips": 1, "why": "a test"})
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    e2e["serve_audio_s_per_s"]["workloads"].append("encodec_nq32ds320.throwaway")
    spec["per_layer"] += [
        {"name": "throwaway_batches.serve", "unit": "batches", "better": "higher", "source": "program_counter",
         "layer": "entry", "moves": "serve_audio_s_per_s", "workloads": ["encodec_nq32ds320.throwaway"]},
        # a split quantity with no file of its own: read by metrics/idle_share.py
        {"name": "idle_share.throwaway", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "serve_audio_s_per_s", "workloads": ["encodec_nq32ds320.throwaway"]}]
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    found = cells.load("encodec_nq32ds320.throwaway", tiny_root)
    assert found.traffic["length_s"]["max"] == 1.0 and found.workload["limits"]["token_gap"] == 0.05
    assert [m["name"] for m in found.per_layer] == ["throwaway_batches.serve", "idle_share.throwaway"]
    assert cells.reader_path("idle_share.throwaway", tiny_root).name == "idle_share.py"
    res = execute("encodec_nq32ds320.throwaway", 7, 1.0, True, torch.device("cpu"), time.perf_counter(),
                  root=tiny_root)
    assert res["correct"] and res["metrics"]["throwaway_batches.serve"]["value"] >= 1
    assert 0 <= res["metrics"]["idle_share.throwaway"]["value"] <= 100
    res = execute("encodec_nq32ds320.throwaway", 7, 1.0, False, torch.device("cpu"), time.perf_counter(),
                  root=tiny_root)
    assert set(res["metrics"]) == {"serve_audio_s_per_s", "setup_s"}
