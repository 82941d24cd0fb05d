"""The benchmark of funcodec_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. It sets up (weights and traffic from the seed, the cell's shapes
warmed up), measures for ``--seconds``, checks what the timed path served
against the plain reference, and prints one JSON line. ``--trace 1`` is a
run of its own under torch.profiler and reports the per-layer metrics.
Without a CUDA card it exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"), ("TRITON_CACHE_DIR", "build/triton")):
    os.environ[var] = str(ROOT / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import cell as cells

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)

    from benchmark.harness import guard
    from benchmark.harness.main import emit, execute

    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    guard.check("at exit")
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
