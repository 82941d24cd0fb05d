"""Readings that the limits of ``correct`` are set from, on the chip.

    python3 benchmark/calibrate.py --workload <cell> --seconds 6 --seeds 11 12 13 ...

For each seed, in one process: the cell's program on that seed's weights
and traffic, a short window at the cell's own load and sizes, its served
requests judged against the reference (the program's reading); then the
control (the references at the precision below the configuration's) put in the program's place on
the same requests, judged the same way (the control's reading). Prints a
JSON line per seed and the largest program and smallest control reading of
each number. The benchmark's own runs never run the control. The drivers
give the readings (``readings(run, state, control)``).
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness.context import Run

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    cell = cells.load(args.workload)
    driver = cell.driver()
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = Run(cell, seed, args.seconds, False, device)
        st = driver.setup(run)
        driver.window(run, st)
        row = {"seed": seed, "requests": len(st.judged()), "attempted": run.attempted, "failed": run.failed,
               "program": driver.readings(run, st, control=False)}
        row["control"] = driver.readings(run, st, control=True)
        row["seconds"] = time.perf_counter() - t0
        row["notes"] = run.notes[-12:]
        rows.append(row)
        print(json.dumps(row), flush=True)
        del st, run
        torch.cuda.empty_cache()
    summary = {"program_max": {k: max(r["program"][k] for r in rows if r["program"]) for k in rows[0]["program"]}}
    controls = [r["control"] for r in rows if r.get("control")]
    if controls:
        summary["control_min"] = {k: min(c[k] for c in controls) for k in controls[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
