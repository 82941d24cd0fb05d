"""Bytes of FreqCodec's grouped transposed 2D convs, from shapes alone.

The least any implementation must move for one conv: x read once, the
weights and bias once, the kept output (after the conv's trim) written once,
all bf16, over the card's bandwidth (``costs/codec.bound_s``, which takes the
larger of that and the FLOPs over the bf16 peak). The calls are the decoder's
``convtr2d`` layers of ``costs/freqcodec.stacks`` at the request's shapes.
The port's kernel for them (funcodec_tpu_torch/csrc/convtr2d.cu) has
``convtr2d`` in the names of its device functions; no cuDNN kernel does
(``freqcodec.json``'s conv2d names).
"""

from __future__ import annotations

from benchmark.costs.codec import bound_s
from benchmark.costs.freqcodec import layer_flops, stacks
from benchmark.reference import freqcodec as fref

KERNEL = "convtr2d"


def is_convtr2d(name: str) -> bool:
    return KERNEL in name


def convtr2d_calls(codec: fref.FreqCodec, T: int):
    """(spec, input (freq, time), kept output (freq, time)) of each transposed 2D conv of a (., T) request."""
    _, dec = stacks(codec, T)
    return [(s, shape_in, shape_out) for kind, s, shape_in, shape_out in dec if kind == "convtr2d"]


def call_bytes(s: dict, B: int, shape_in, shape_out, elem: int = 2) -> int:
    (fi, ti), (fo, to), (kf, kt) = shape_in, shape_out, s["k"]
    weights = s["cin"] * (s["cout"] // s["groups"]) * kf * kt + s["cout"]
    return elem * (B * s["cin"] * fi * ti + weights + B * s["cout"] * fo * to)


def convtr2d_bound_s(codec: fref.FreqCodec, B: int, T: int, elem: int = 2) -> float:
    """The sum over the request's transposed 2D convs of each one's least time."""
    return sum(bound_s(call_bytes(s, B, i, o, elem), layer_flops("convtr2d", s, B, i, o), elem)
               for s, i, o in convtr2d_calls(codec, T))
