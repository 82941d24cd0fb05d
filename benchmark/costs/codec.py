"""Operations and bytes of a codec request, from shapes alone.

FLOPs are 2 x the multiply-accumulates of each conv, transposed conv, LSTM
gate matmul and RVQ distance matmul (the count of the port's
``utils/misc.codec_flops_tree``, copied here over the reference's layer
list); elementwise work counts 0. A kernel's bytes count each input byte
read once and each output byte written once, as computed from the call's
shapes (``chip_smoke.py``'s ``_bound`` arithmetic).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Iterator, Tuple

from benchmark.reference import codec as ref

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
KERNELS = json.loads((Path(__file__).with_name("kernels.json")).read_text())["port"]


def bound_s(nbytes: float, flops: float, elem: int = 2) -> float:
    """The least time the chip could take: the larger of bytes over HBM
    bandwidth and operations over the type's peak."""
    peak = PEAKS["bf16_flops_per_s"] if elem == 2 else PEAKS["fp32_flops_per_s"]
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / peak)


def is_kernel(kernel: str):
    subs = KERNELS[kernel]
    return lambda name: any(s in name for s in subs)


def is_port_kernel(name: str) -> bool:
    return any(s in name for subs in KERNELS.values() for s in subs)


def _conv_out(s: dict, t: int) -> int:
    k, st, d = s["k"], s["stride"], s["dilation"]
    total = (k - 1) * d - (st - 1)
    n_frames = (t - k + total) / st + 1
    length = t + total + (math.ceil(n_frames) - 1) * st + (k - total) - t
    return (length - ((k - 1) * d + 1)) // st + 1


def walk(layers, t: int) -> Iterator[Tuple[str, dict, int, int]]:
    """(kind, spec, input length, output length) of each layer."""
    for kind, s in layers:
        if kind == "conv":
            t_out = _conv_out(s, t)
        elif kind == "convtr":
            t_out = t * s["stride"]
        else:
            t_out = t
        yield kind, s, t, t_out
        t = t_out


def _flops(kind: str, s: dict, B: int, t: int, t_out: int) -> float:
    if kind == "conv":
        return 2.0 * B * t_out * s["cout"] * s["cin"] * s["k"]
    if kind == "convtr":
        return 2.0 * B * t * s["cin"] * s["cout"] * s["k"]
    if kind == "lstm":
        return 2.0 * B * t * s["layers"] * 4 * s["dim"] * 2 * s["dim"]
    if kind == "resblock":
        f = sum(_flops(k2, s2, B, t, t) for k2, s2 in s["block"])
        return f + (_flops(*s["shortcut"], B, t, t) if s["shortcut"] else 0.0)
    return 0.0


def serve_flops(codec: ref.Codec, B: int, T: int, n_q: int) -> float:
    """Encode, RVQ search and decode of a (B, T) batch."""
    enc = list(walk(ref.encoder_layers(codec.encoder), T))
    frames = enc[-1][3]
    dec = list(walk(ref.decoder_layers(codec.decoder), frames))
    f = sum(_flops(k, s, B, t, to) for k, s, t, to in enc + dec)
    return f + 2.0 * B * frames * n_q * codec.bins * codec.dim


def resblock_calls(codec: ref.Codec, T: int):
    """(C, T) of every residual block a (., T) request runs, encoder and decoder."""
    enc = list(walk(ref.encoder_layers(codec.encoder), T))
    dec = list(walk(ref.decoder_layers(codec.decoder), enc[-1][3]))
    return [(s["block"][0][1]["cin"], t, s) for k, s, t, _ in enc + dec if k == "resblock"]


def resblock_bound_s(codec: ref.Codec, B: int, T: int, elem: int = 2) -> float:
    """Each block's x read and y written once, its weights once."""
    total = 0.0
    for C, t, s in resblock_calls(codec, T):
        convs = list(s["block"]) + ([s["shortcut"]] if s["shortcut"] else [])
        macs = sum(c["cin"] * c["cout"] * c["k"] for _, c in convs)
        total += bound_s(2 * B * C * t * elem + macs * elem, 2.0 * B * t * macs, elem)
    return total


def rvq_bound_s(codec: ref.Codec, B: int, T: int, n_q: int) -> float:
    """bf16 latents read, bf16 codebooks and fp32 norms read, int32 indices
    and the fp32 sum of codewords written; 2 x the distance MACs."""
    N = B * (list(walk(ref.encoder_layers(codec.encoder), T))[-1][3])
    D, bins = codec.dim, codec.bins
    nbytes = N * D * 2 + n_q * bins * (D * 2 + 4) + n_q * N * 4 + N * D * 4
    return bound_s(nbytes, 2.0 * N * n_q * bins * D)


def roofline_share(run, kernel: str, bound_of):
    """A port kernel's share (%) of its roofline over the traced slice: the
    least time the slice's calls could take over the time the trace gives
    the kernel's device functions. None where the slice ran none of them."""
    trace, batches = run.tracer.result, run.work.get("batches")
    if trace is None or not batches:
        return None
    seconds, count = trace.kernel_seconds(is_kernel(kernel))
    if not count:
        return None
    return 100.0 * sum(bound_of(run.work["codec"], B, T) for B, T in batches) / seconds
