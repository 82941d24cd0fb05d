"""Timing helpers of the port's measurement tools (counterpart of scripts/_benchlib.py).

- ``make_logger``: print, and append timestamped lines to a log file;
- ``timeit``: best-of-N wall time of a call, fenced by torch.cuda.synchronize();
- ``timeit_amortized``: N launches of an op between two CUDA events, ping-
  ponging two buffers so that each launch reads the last one's output; ms per op.

``resolve_device`` (tasks/codec) gives the tools' device: the card unless the
caller asks for the CPU.

On a CPU device the same helpers time with the host clock; their numbers are
the CPU's, and the tools label them with the device they ran on.
"""

from __future__ import annotations

import subprocess
import time
from pathlib import Path
from typing import Callable, Optional, Union

import torch

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, published (NVIDIA data sheet)


def make_logger(path: Optional[Union[str, Path]] = None) -> Callable[[str], None]:
    """log(msg): prints, and appends a timestamped line to `path` if given."""
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)

    def log(msg: str) -> None:
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        if path is not None:
            with open(path, "a") as f:
                f.write(line + "\n")

    return log


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[device.index or 0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn: Callable[[], object], device: torch.device, warmup: int = 1, iters: int = 3) -> float:
    """Best-of-N wall seconds of fn(), each call fenced by a synchronize."""
    for _ in range(warmup):
        fn()
    _sync(device)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def timeit_amortized(op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], x: torch.Tensor, n_reps: int,
                     warmup: int = 1) -> float:
    """ms per op of op(src, dst) -> output, launched n_reps times in a row;
    each launch reads the last one's output. An op that writes dst and
    returns it ping-pongs two buffers; one that returns a new tensor chains
    through it. The first source is a copy of x; x is not written."""

    def run(n, a, b):
        for _ in range(n):
            a, b = op(a, b), a
        return a, b

    a, b = run(warmup, x.clone(), torch.empty_like(x))
    if x.device.type != "cuda":
        t0 = time.perf_counter()
        run(n_reps, a, b)
        return (time.perf_counter() - t0) * 1e3 / n_reps
    torch.cuda.synchronize(x.device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(n_reps, a, b)
    end.record()
    torch.cuda.synchronize(x.device)
    return start.elapsed_time(end) / n_reps
