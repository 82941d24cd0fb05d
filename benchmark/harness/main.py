"""One run of one cell, start to result line."""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from benchmark.harness import cell as cells
from benchmark.harness import guard
from benchmark.harness.context import Run


def execute(name: str, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
            root: Optional[Path] = None) -> dict:
    """Set up, measure, check; returns the result's fields."""
    cell = cells.load(name, root or cells.ROOT)
    run = Run(cell, seed, seconds, trace, device)
    driver = cell.driver()
    state = driver.setup(run)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # what set-up made lives for the whole run: keep the collector from
    # scanning it inside the window
    gc.collect()
    gc.freeze()
    guard.check("after set-up")
    setup_s = time.perf_counter() - t_start
    driver.window(run, state)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    guard.check("once the window closed")
    driver.check(run, state)

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"], root or cells.ROOT)(run)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    correct = (bool(run.checks) and run.failed == 0
               and all(lim is not None and v <= lim for v, lim in run.checks.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
              "device": dev}
    t = run.tracer.result
    if trace and t is not None:
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": t.idle_by_host()}
    for note in run.notes:
        print(f"benchmark: {note}", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return result


def emit(result: dict) -> None:
    """The compared numbers as the last lines of stderr, the result as the
    last line of stdout (its ``checks`` key last)."""
    print(f"benchmark: correct={result['correct']} attempted={result['attempted']} failed={result['failed']}",
          file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
