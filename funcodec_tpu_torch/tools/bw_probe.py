"""Copy-bandwidth probe of one CUDA card (counterpart of scripts/pallas_bw_probe.py).

How close does a hand-written stream come to the card's 3.35 TB/s? Each
variant computes o = 2 * x over x (256, 20,000, 128), 1.31 GB of bf16:

  A  scale_copy, blocks (1, 4000, 128)
  B  the TPU probe's dimension_semantics: no Hopper counterpart (blocks
     always run in parallel); the tile and row sweep below covers what it
     asked, the cost of one grid step, down to a 4 KB block
  C  scale_copy, multi-row blocks (8, 2000, 128) and (16, 1000, 128)
  D  dma_copy: TMA bulk copies through a ring of shared-memory slots
     (32 KB chunks doubled in place, 4 slots, one producer warp), a
     persistent grid of SMs x resident blocks
  E  A and D in fp32 (2.62 GB)

Every row logs the kernel's ms per op (CUDA events over N launches that
each read the last one's output), GB/s read + written, its share of
3.35 TB/s, and beside it the time of the one PyTorch call that computes the
same function, torch.mul(x, 2, out=y). y.copy_(x) closes the table. The
best rate of the run is the measured copy ceiling.

    python -m funcodec_tpu_torch.tools.bw_probe                # on the card
    python -m funcodec_tpu_torch.tools.bw_probe --device cpu   # plain version, tiny shape

Lines go to stdout and to build/tools/bw_probe.log.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from funcodec_tpu_torch.ops import copy_kernel
from funcodec_tpu_torch.tasks.codec import resolve_device
from funcodec_tpu_torch.tools.benchlib import PEAK_BYTES, card_line, make_logger, timeit_amortized

LOG = Path(__file__).resolve().parents[2] / "build" / "tools" / "bw_probe.log"
SHAPE = (256, 20_000, 128)  # the TPU probe's (B, Tp, L)
TINY = (2, 40, 128)  # --device cpu
GPU_TILE = 16  # a 4 KB bf16 block: one 16-byte vector per thread


def _variants(T: int):
    """(label, kernel, dtype, op(src, dst)) at time length T; tiles scale with T."""
    s = lambda t: max(1, t * T // SHAPE[1])  # noqa: E731
    bf, f32 = torch.bfloat16, torch.float32
    out = [("A tile=4000", "scale_copy", bf, lambda a, b: copy_kernel.scale_copy(a, s(4000), out=b))]
    out += [(f"C block=({r},{t})", "scale_copy", bf, lambda a, b, r=r, t=t: copy_kernel.scale_copy(a, s(t), r, out=b))
            for r, t in ((8, 2000), (16, 1000))]
    out += [(f"sweep tile={GPU_TILE}", "scale_copy", bf, lambda a, b: copy_kernel.scale_copy(a, GPU_TILE, out=b)),
            ("D dma_copy", "dma_copy", bf, lambda a, b: copy_kernel.dma_copy(a, out=b)),
            ("E fp32 tile=4000", "scale_copy", f32, lambda a, b: copy_kernel.scale_copy(a, s(4000), out=b)),
            ("E fp32 dma_copy", "dma_copy", f32, lambda a, b: copy_kernel.dma_copy(a, out=b))]
    return out


def _mul(a, b):
    return torch.mul(a, 2, out=b)


def _copy(a, b):
    return b.copy_(a)


def run(device: torch.device, shape=None, n_reps: Optional[int] = None,
        log: Callable[[str], None] = print) -> List[Dict[str, object]]:
    """Time every variant on `device`; returns one row per timed call."""
    shape = shape or (SHAPE if device.type == "cuda" else TINY)
    n_reps = n_reps or (20 if device.type == "cuda" else 2)
    card = card_line(device)
    gen = torch.Generator(device=device).manual_seed(0)
    x32 = torch.randn(*shape, device=device, generator=gen)
    xs = {torch.float32: x32, torch.bfloat16: x32.to(torch.bfloat16)}
    log(f"x {tuple(shape)}: {xs[torch.bfloat16].nbytes / 1e9:.3f} GB bf16, {x32.nbytes / 1e9:.3f} GB fp32 "
        f"({device}, {card})")
    log("B dimension_semantics: no Hopper counterpart (blocks always run in parallel); "
        "the tile and row sweep covers it")
    rows, lib_ms = [], {}
    for label, kernel, dtype, op in _variants(shape[1]):
        x = xs[dtype]
        if dtype not in lib_ms:
            lib_ms[dtype] = timeit_amortized(_mul, x, n_reps)
        rows.append(_row(label, kernel, x, timeit_amortized(op, x, n_reps), lib_ms[dtype], card, log))
    for dtype, x in xs.items():
        rows.append(_row(f"torch.mul {str(dtype)[6:]}", "torch.mul", x, lib_ms[dtype], lib_ms[dtype], card, log))
        ms = timeit_amortized(_copy, x, n_reps)
        rows.append(_row(f"copy_ {str(dtype)[6:]}", "copy_", x, ms, lib_ms[dtype], card, log))
    best = max(rows, key=lambda r: r["gbps"])
    if device.type == "cuda":  # a CPU run's rates are the host's, not a device ceiling
        log(f"measured copy ceiling: {best['gbps']:.1f} GB/s read + written ({best['name']}), "
            f"{best['share']:.3f} of {PEAK_BYTES / 1e12:.2f} TB/s ({card})")
    return rows


def _row(name, kernel, x, ms, library_ms, card, log) -> Dict[str, object]:
    nbytes = 2 * x.nbytes  # each byte read once and written once
    row = dict(name=name, kernel=kernel, dtype=str(x.dtype)[6:], shape=list(x.shape), ms=ms,
               gbps=nbytes / ms / 1e6, share=nbytes / PEAK_BYTES * 1e3 / ms,
               bound_ms=nbytes / PEAK_BYTES * 1e3, library_ms=library_ms)
    share = f", {row['share']:.3f} of 3.35 TB/s (bound {row['bound_ms']:.4f} ms)" if x.is_cuda else ""
    log(f"{name}: {ms:.4f} ms/op -> {row['gbps']:.1f} GB/s r+w{share}; torch.mul {library_ms:.4f} ms ({card})")
    return row


def main(argv=None) -> List[Dict[str, object]]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log", default=str(LOG), help=f"log file (default {LOG.relative_to(LOG.parents[2])})")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain version, tiny shape)")
    parser.add_argument("--reps", type=int, default=None, help="launches per timing (default 20 on the card)")
    args = parser.parse_args(argv)
    return run(resolve_device(args.device), n_reps=args.reps, log=make_logger(args.log))


if __name__ == "__main__":
    main()
