"""Streaming micro-benchmarks of one CUDA card (counterpart of scripts/pallas_stream_probe.py).

Sections (default all), each op timed by CUDA events over N launches that
each read the last one's output:

  elementwise  one pass of a * 1.0001 + 0.001 in plain torch (one addcmul
               kernel) over bf16 (256, 160,000, 32) and (256, 40,000, 128):
               does the narrow last dim cost bandwidth?
  copy         the scale_copy kernel's GB/s against its tile, beside
               torch.mul(x, 2) in the same run, in bf16 and fp32: the JAX
               probe's tiles 1000 / 4000 / 10000 and a 16-row block
  resblock     the fused residual-block kernel (three launches) against the
               port's unfused block at B = 256 and the widths of the JAX
               probe (T, C) = (160,000, 32), (80,000, 64), (20,000, 128).
               The JAX probe's packed rows have no counterpart: ops/packed.py
               is not ported (ROADMAP.md "Not ported").

Every line carries the card's name and power limit.

    python -m funcodec_tpu_torch.tools.stream_probe [all|elementwise|copy|resblock]
    python -m funcodec_tpu_torch.tools.stream_probe --device cpu   # plain versions, tiny shapes

Lines go to stdout and to build/tools/stream_probe.log.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable

import torch

import funcodec_tpu_torch.ops.conv as conv_ops
from funcodec_tpu_torch.models.seanet import SEANetConfig, _resblock_layers, make_layer
from funcodec_tpu_torch.ops import copy_kernel, resblock_kernel
from funcodec_tpu_torch.tasks.codec import resolve_device
from funcodec_tpu_torch.tools.benchlib import PEAK_BYTES, card_line, make_logger, timeit_amortized

LOG = Path(__file__).resolve().parents[2] / "build" / "tools" / "stream_probe.log"
SECTIONS = ("elementwise", "copy", "resblock")
TILES = (1000, 4000, 10000, 16)


def _rate(nbytes: float, ms: float, device: torch.device) -> str:
    """GB/s read + written, and on a card its share of the published peak."""
    share = f", {nbytes / PEAK_BYTES * 1e3 / ms:.3f} of 3.35 TB/s" if device.type == "cuda" else ""
    return f"{nbytes / ms / 1e6:.1f} GB/s r+w{share}"


def elementwise(device, log: Callable[[str], None], card: str) -> None:
    B, T = (256, 160_000) if device.type == "cuda" else (2, 1600)
    gen = torch.Generator(device=device).manual_seed(0)
    scale = torch.tensor(1.0001, device=device)
    shift = torch.tensor(0.001, device=device)
    for shape, name in (((B, T, 32), "narrow (T,32)"), ((B, T // 4, 128), "packed (T/4,128)")):
        x = torch.randn(*shape, device=device, generator=gen).to(torch.bfloat16)
        ms = timeit_amortized(lambda a, b: torch.addcmul(shift, a, scale, out=b), x, 24 if device.type == "cuda" else 2)
        log(f"elementwise {name} {tuple(shape)}: {ms:.4f} ms/op -> {_rate(2 * x.nbytes, ms, device)} ({card})")


def copy(device, log: Callable[[str], None], card: str) -> None:
    B, T, L = (256, 20_000, 128) if device.type == "cuda" else (2, 40, 128)
    reps = 16 if device.type == "cuda" else 2
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        x = torch.randn(B, T, L, device=device, generator=torch.Generator(device=device).manual_seed(0)).to(dtype)
        mul = timeit_amortized(lambda a, b: torch.mul(a, 2, out=b), x, reps)
        log(f"torch.mul {name}: {mul:.4f} ms/op -> {_rate(2 * x.nbytes, mul, device)} ({card})")
        for tile in TILES:
            t = tile if tile < 1000 else max(1, tile * T // 20_000)
            ms = timeit_amortized(lambda a, b: copy_kernel.scale_copy(a, t, out=b), x, reps)
            steps = B * -(-T // t)
            log(f"scale_copy tile={t} {name} ({t * L * x.element_size()} B per block): {ms:.4f} ms/op -> "
                f"{_rate(2 * x.nbytes, ms, device)}, {ms / mul:.4f} of torch.mul's time | "
                f"{ms / steps * 1e3:.4f} us per block ({card})")
        del x


def resblock(device, log: Callable[[str], None], card: str) -> None:
    B, div = (256, 1) if device.type == "cuda" else (2, 1000)
    cfg = SEANetConfig(norm="time_group_norm")
    gen = torch.Generator(device=device).manual_seed(0)
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = False  # block(x) is the unfused chain
    with torch.inference_mode():
        for T, C in ((160_000, 32), (80_000, 64), (20_000, 128)):
            T //= div
            block = make_layer("resblock", _resblock_layers(cfg, C, 1)[1], device=device, generator=gen)
            block = block.to(torch.bfloat16).eval()
            convs = (block.block[1], block.block[3], block.shortcut)
            x = torch.randn(B, C, T, device=device, generator=gen).to(torch.bfloat16)
            reps = 4 if device.type == "cuda" else 1
            fused = timeit_amortized(lambda a, b: resblock_kernel.fused_resblock_tgn(a, *convs), x, reps)
            unfused = timeit_amortized(lambda a, b: block(a), x, reps)
            log(f"resblock B={B} T={T} C={C}: fused kernel {fused:.3f} ms/op ({_rate(2 * x.nbytes, fused, device)}), "
                f"unfused block {unfused:.3f} ms/op ({card})")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("section", nargs="?", default="all", choices=("all",) + SECTIONS)
    parser.add_argument("--log", default=str(LOG), help=f"log file (default {LOG.relative_to(LOG.parents[2])})")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions, tiny shapes)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    log, card = make_logger(args.log), card_line(device)
    for name, fn in (("elementwise", elementwise), ("copy", copy), ("resblock", resblock)):
        if args.section in ("all", name):
            fn(device, log, card)


if __name__ == "__main__":
    main()
