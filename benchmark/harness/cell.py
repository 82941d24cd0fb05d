"""Find a cell's pieces by the names in BENCHMARK.json.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each lives in a file of its own under the benchmark's directory:

- ``configs/<config>.json``: the model's FunCodec config as it is run, its
  serving options and ``reduced`` / ``assumed``;
- ``traffic/<traffic>.json``: the mix's parameters and the serving loop that
  serves it (``drivers/<driver>.py``);
- ``workloads/<cell>.json``: what is the cell's own (a rate, the limits of
  the numbers compared);
- ``metrics/<metric>.py``: one reader per per-layer metric; a metric split
  by the cells' end-to-end metric (``idle_share.serve``, ``idle_share.tts``)
  may share ``metrics/<name before the first dot>.py``.

A new cell, mix or metric is a new file and a new entry; no code changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    workload: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    def driver(self):
        return importlib.import_module(f"benchmark.drivers.{self.traffic['driver']}")


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def reports(metric: Dict[str, Any], cell: str, e2e_names: List[str]) -> bool:
    """Whether the cell reports a metric: listed in its ``workloads``, or,
    without that key, wherever the metric it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load(name: str, root: Path = ROOT) -> Cell:
    spec = _read(root / "BENCHMARK.json")
    bench = root / "benchmark"
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    conf_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    own = bench / "workloads" / f"{name}.json"
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = [m["name"] for m in e2e]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        traffic_name=w["traffic"],
        config=_read(root / conf_entry["file"]),
        traffic=_read(bench / "traffic" / f"{w['traffic']}.json"),
        workload=_read(own) if own.exists() else {},
        end_to_end=e2e,
        per_layer=[m for m in spec["per_layer"] if reports(m, name, e2e_names)],
    )


def reader_path(name: str, root: Path = ROOT) -> Path:
    """``metrics/<name>.py``, or else the reader of the quantity the name
    splits, ``metrics/<name before the first dot>.py``."""
    metrics = root / "benchmark" / "metrics"
    own = metrics / f"{name}.py"
    return own if own.exists() else metrics / f"{name.split('.')[0]}.py"


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(run)`` of the metric's reader (a name may hold dots, so
    the file is loaded by its path)."""
    path = reader_path(name, root)
    module_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read
