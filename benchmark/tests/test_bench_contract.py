"""BENCHMARK.json keeps to the benchmark's contract, and every piece it
names has its file."""

import json
import re
from pathlib import Path

from benchmark.harness.cell import reader_path

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, run_seconds + 60 each, 2 x 90 s a cell, 1,200 spare
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_cells_and_metrics():
    configs = {c["name"]: c for c in SPEC["configs"]}
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in configs.values())
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in cells.values())
    for c in configs.values():
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"]) and w["chips"] == 1
        mix = json.loads((ROOT / "benchmark/traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark/drivers" / f"{mix['driver']}.py").is_file()
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    reported = {w: {n for n, m in e2e.items() if w in m.get("workloads", [w])} for w in cells}
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and _line(m["layer"])
        assert reader_path(m["name"], ROOT).is_file()
        assert all(m["moves"] in reported[w] for w in m["workloads"])
    for w in cells:
        assert "setup_s" in reported[w] and len(reported[w]) >= 2
        assert any(w in m["workloads"] for m in SPEC["per_layer"])
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))


def test_shares_of_a_roofline_or_a_peak_are_named_so():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
