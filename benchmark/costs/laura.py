"""LauraTTS FLOPs from shapes: the encoder stacks' full forwards, the codec
LM's decode step and prefill against the session's KV cache, and a
synthesis (text encoder, NAR codec encoder, the SEANet decoder by
``costs/codec.py``), each as the program runs it (every slot steps over the
cache's whole capacity; admissions pad the text to the session's text
bucket, syntheses text and frames to the synthesis bucket and decode the
fixed ``synth_frames`` a request; the padding of a batch's rows to its
longest is not counted, so this is a lower bound). A multiply-add
is 2 FLOPs; the rel-pos attention counts its projected distance table and
the product of the queries with every distance the program computes."""

from __future__ import annotations

from benchmark.costs import codec as codec_costs
from benchmark.reference import codec as ref
from benchmark.reference.laura import Laura, Stack


def _round_up(n: int, b: int) -> int:
    return -(-n // b) * b


def block_flops(s: Stack, n: int, keys: int) -> float:
    """One layer over n new positions attending to `keys` positions: the
    four attention Linears and the FFN, (q + u) k and the attention's
    weighted values over the keys, (q + v) p over the 2 keys - 1 distances."""
    d = s.dim
    return 2.0 * n * (4 * d * d + 2 * d * s.ffn) + 2.0 * 2 * n * keys * d + 2.0 * n * (2 * keys - 1) * d


def stack_flops(s: Stack, T: int) -> float:
    """A full forward over T positions: the input Linear, every layer and
    the projection of its (2T - 1)-row distance table."""
    table = 2.0 * (2 * T - 1) * s.dim * s.dim
    return 2.0 * T * s.input_size * s.dim + s.blocks * (block_flops(s, T, T) + table)


def step_flops(m: Laura, keys: int) -> float:
    """One decode step of one slot: the input Linear, the layers over the
    cache's `keys` positions, the decoder to the flattened groups."""
    s = m.lm
    return 2.0 * s.input_size * s.dim + s.blocks * block_flops(s, 1, keys) + 2.0 * s.dim * m.out_voc


def admit_flops(m: Laura, text: int, text_bucket: int, prefix: int, keys: int) -> float:
    """A request's prefix embedding (the text encoder at its text bucket and
    its output Linear) and its prefill of `prefix` positions into the cache."""
    t = _round_up(text, text_bucket)
    s = m.lm
    return (stack_flops(m.text_encoder, t) + 2.0 * t * m.text_encoder.dim * m.dim
            + 2.0 * prefix * s.input_size * s.dim + s.blocks * block_flops(s, prefix, keys)
            + 2.0 * s.dim * m.out_voc)


def synth_flops(m: Laura, codec: ref.Codec, text: int, frames: int, bucket: int, decoded: int) -> float:
    """A request's synthesis: the text encoder and the NAR codec encoder at
    the bucketed text and frames, their output Linears, the SEANet decoder
    over `decoded` frames (one row)."""
    t, f = _round_up(text, bucket), _round_up(frames, bucket)
    dec = codec_costs.walk(ref.decoder_layers(codec.decoder), decoded)
    return (stack_flops(m.text_encoder, t) + 2.0 * t * m.text_encoder.dim * m.dim
            + stack_flops(m.codec_encoder, t + f) + 2.0 * (t + f) * m.codec_encoder.dim * m.dim
            + sum(codec_costs._flops(k, s, 1, ti, to) for k, s, ti, to in dec))


def slice_flops(run) -> float:
    """The traced slice's FLOPs from what the serving loop counted in it."""
    w = run.work
    m, codec = w["model"], w["codec"]
    keys = w["capacity"]
    f = w["steps"] * w["slots"] * step_flops(m, keys)
    f += sum(admit_flops(m, t, w["text_bucket"], w["prefix_budget"], keys) for t in w["admitted_text"])
    f += sum(synth_flops(m, codec, t, g, w["bucket"], w["synth_frames"]) for t, g in w["synths"])
    return f
