"""Operations of a FreqCodec request, from shapes alone.

FLOPs are 2 x the multiply-accumulates of each 2D conv (a grouped conv's
output sees Cin / groups inputs), transposed 2D conv, LSTM gate matmul, 1D
conv and RVQ distance matmul, walked over the FreqCodec reference's layer
lists at the request's (freq, time) shapes; the STFT, the iSTFT and
elementwise work count 0 (costs/codec.py's rule for the 1D codec).
``freqcodec.json`` names the device functions of the 2D convs: cuDNN's
conv kernels and the layout transposes it runs around them.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Iterator, Optional, Tuple

from benchmark.costs.codec import _conv_out
from benchmark.reference import freqcodec as fref

CONV2D_NAMES = json.loads((Path(__file__).with_name("freqcodec.json")).read_text())["conv2d"]

Shape = Tuple[Optional[int], int]  # (freq, time); freq None once squeezed


def is_conv2d(name: str) -> bool:
    """A device op of the 2D convs: a cuDNN conv kernel or a layout transpose."""
    return any(s in name for s in CONV2D_NAMES)


def _conv2d_out(s: dict, f: int, t: int) -> Shape:
    (kf, kt), (sf, st), (df, dt) = s["k"], s["stride"], s["dilation"]
    pf, pt = (kf - 1) * df - (sf - 1), (kt - 1) * dt - (st - 1)
    extra = (math.ceil((t - kt + pt) / st + 1) - 1) * st + (kt - pt) - t
    return (f + pf - ((kf - 1) * df + 1)) // sf + 1, (t + pt + extra - ((kt - 1) * dt + 1)) // st + 1


def _convtr2d_out(s: dict, f: int, t: int) -> Shape:
    (kf, kt), (sf, st) = s["k"], s["stride"]
    (fo_l, fo_r), (to_l, to_r) = s["out_padding"]
    pf, pt = kf - sf, kt - st
    trim_f = max(pf - pf // 2 - fo_l, 0) + max(pf // 2 - fo_r, 0)
    trim_t = max(pt - pt // 2 - to_l, 0) + max(pt // 2 - to_r, 0)
    return (f - 1) * sf + kf - trim_f, (t - 1) * st + kt - trim_t


def walk(layers, shape: Shape) -> Iterator[Tuple[str, dict, Shape, Shape]]:
    """(kind, spec, input (freq, time), output (freq, time)) of each layer."""
    for kind, s in layers:
        f, t = shape
        if kind == "conv2d":
            out = _conv2d_out(s, f, t)
        elif kind == "convtr2d":
            out = _convtr2d_out(s, f, t)
        elif kind == "conv":
            out = (None, _conv_out(s, t))
        elif kind == "squeeze":
            out = (None, t)
        elif kind == "unsqueeze":
            out = (1, t)
        else:
            out = shape
        yield kind, s, shape, out
        shape = out


def layer_flops(kind: str, s: dict, B: int, shape_in: Shape, shape_out: Shape) -> float:
    if kind == "conv2d":
        (kf, kt), (fo, to) = s["k"], shape_out
        return 2.0 * B * fo * to * s["cout"] * (s["cin"] // s["groups"]) * kf * kt
    if kind == "convtr2d":
        (kf, kt), (fi, ti) = s["k"], shape_in
        return 2.0 * B * fi * ti * s["cin"] * (s["cout"] // s["groups"]) * kf * kt
    if kind == "conv":
        return 2.0 * B * shape_out[1] * s["cout"] * s["cin"] * s["k"]
    if kind == "lstm":
        return 2.0 * B * shape_in[1] * s["layers"] * 4 * s["dim"] * 2 * s["dim"]
    if kind == "resblock2d":
        f = sum(layer_flops(k2, s2, B, shape_in, shape_in) for k2, s2 in s["block"])
        return f + (layer_flops(*s["shortcut"], B, shape_in, shape_in) if s["shortcut"] else 0.0)
    return 0.0


def stacks(codec: fref.FreqCodec, T: int):
    """The encoder's and the decoder's walks for a (., T) request."""
    enc = list(walk(fref.encoder_layers(codec.encoder), (codec.n_fft // 2 + 1, T // codec.stft_hop + 1)))
    dec = list(walk(fref.decoder_layers(codec.decoder), (None, enc[-1][3][1])))
    return enc, dec


def serve_flops(codec: fref.FreqCodec, B: int, T: int, n_q: int) -> float:
    """Encode, RVQ search and decode of a (B, T) batch."""
    enc, dec = stacks(codec, T)
    frames = enc[-1][3][1]
    f = sum(layer_flops(k, s, B, i, o) for k, s, i, o in enc + dec)
    return f + 2.0 * B * frames * n_q * codec.bins * codec.dim
