"""Low-latency streaming inference for causal codec models (port of funcodec_tpu/models/streaming.py).

A chunked session over a causal SEANet codec that emits, chunk by chunk,
exactly the tokens and samples of the whole-utterance path: no lookahead,
no crossfade. Per-layer carries make the causal stack an exact sliding
computation:

  * forward conv (k, s, d): the causal left pad is ``pt = (k-1)*d-(s-1)``
    (ops/pad.conv_padding_total); with chunk lengths divisible by s each
    chunk emits L/s frames and the carry is the last ``pt`` input samples.
  * transposed conv (k, s): input frame i writes taps to [i*s, i*s + k), so
    a chunk's output overlaps the previous chunk's tail by ``k - s``
    samples. The carry is that bias-free tail; emitted samples are final,
    so bias and norm apply on emission. The causal right trim
    ``ceil((k-s)*trim_right_ratio)`` happens once, at flush(); the left
    trim once, at the first chunk.
  * LSTM: per-layer (h, c) carries (ops/rnn.apply_slstm_streaming).
  * act / snake / 1x1 convs: stateless.

The walk reads the port's modules beside their (kind, spec) layer list, in
torch's (B, C, T) layout; the LayerStack's ELU + conv peephole does not
apply (an activation is stateless, a conv is streamed). A first, unprimed
chunk runs each conv through ``apply_sconv1d``, so ``FUSED_STRIDE1`` takes
the fused kernel there; primed chunks run a plain conv on carry + chunk.

Streamable: ``causal=True`` stacks with norm in {none, weight_norm,
layer_norm} (time_group_norm normalizes over the whole utterance) and
seq_model in {lstm, none}. RVQ encode and decode are frame-local: the
session encodes with ``Quantizer.encode``, the fp32 scan.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from funcodec_tpu_torch.models.seanet import Layer
from funcodec_tpu_torch.ops.conv import ConvSpec, apply_post_norm, apply_sconv1d
from funcodec_tpu_torch.ops.pad import conv_padding_total, pad1d_time
from funcodec_tpu_torch.ops.rnn import apply_slstm_streaming

ConvParams = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]


def _check_streamable(cfg) -> None:
    if not cfg.causal:
        raise ValueError("streaming needs causal=True (non-causal convs read future samples)")
    if cfg.norm not in ("none", "weight_norm", "layer_norm"):
        raise ValueError(
            f"norm={cfg.norm!r} is not streamable: time_group_norm normalizes over the whole "
            "utterance; use weight_norm for causal models (the EnCodec causal operating point)"
        )
    if cfg.seq_model == "transformer":
        raise NotImplementedError(
            "streaming transformer bottleneck (needs a KV-cache step); use seq_model='lstm' or 'none'"
        )


def _fwd_carry_len(spec: ConvSpec) -> int:
    return conv_padding_total(int(spec.kernel_size), int(spec.stride), int(spec.dilation))


def min_first_chunk(layers: Sequence[Layer]) -> int:
    """Smallest first chunk (in stack-input units) for exact whole-utterance
    parity. Only reflect padding constrains it: the stream-start left pad
    mirrors the pt samples after x[0], so a first chunk must cover pt + 1
    samples at every reflect-padded conv. Constant pads and replicate need
    no future sample. Later chunks have no minimum."""
    need = Fraction(0)
    unit = Fraction(1)  # input units per time step at the current layer

    def conv_need(spec):
        pt = _fwd_carry_len(spec)
        return pt + 1 if pt > 0 and spec.pad_mode == "reflect" else 0

    for kind, spec in layers:
        if kind == "conv" and not spec.transposed:
            need = max(need, conv_need(spec) * unit)
            unit *= int(spec.stride)
        elif kind == "conv" and spec.transposed:
            unit /= int(spec.stride)
        elif kind == "resblock":
            block, _sc = spec
            for bkind, bspec in block:
                if bkind == "conv":
                    need = max(need, conv_need(bspec) * unit)
    return int(math.ceil(need))


def init_stream_state(layers: Sequence[Layer], batch: int, dtype=torch.float32, device=None) -> List[Any]:
    """Zero carries matching the layer list: forward convs hold raw inputs
    (B, Cin, pt), transposed convs the bias-free overlap tail (B, Cout, k-s),
    LSTMs a list of (h, c), each (B, H)."""
    state: List[Any] = []
    for kind, spec in layers:
        if kind == "conv":
            if spec.transposed:
                pt = int(spec.kernel_size) - int(spec.stride)
                state.append(torch.zeros(batch, spec.out_channels, pt, dtype=dtype, device=device))
            else:
                pt = _fwd_carry_len(spec)
                state.append(torch.zeros(batch, spec.in_channels, pt, dtype=dtype, device=device))
        elif kind == "lstm":
            dim, nlayers, _skip = spec
            state.append([(torch.zeros(batch, dim, dtype=dtype, device=device),
                           torch.zeros(batch, dim, dtype=dtype, device=device)) for _ in range(nlayers)])
        elif kind == "resblock":
            block, _shortcut = spec
            state.append({"block": init_stream_state(block, batch, dtype, device), "shortcut": None})
        else:  # act / snake: stateless
            state.append(None)
    return state


def conv_params(module: nn.Module, cache: Optional[Dict[nn.Module, ConvParams]] = None,
                dtype: Optional[torch.dtype] = None) -> ConvParams:
    """(weight, bias, norm_scale, norm_bias) of an SConv1d or SConvTranspose1d,
    the weight (weight-norm fused) in `dtype`; kept in `cache` when given,
    so that a session fuses each weight once."""
    if cache is not None and module in cache:
        return cache[module]
    inner = module.convtr if hasattr(module, "convtr") else module.conv
    with torch.no_grad():
        weight = inner.weight()
        params = (weight if dtype is None else weight.to(dtype), inner.layer.bias, *inner.norm_params())
    if cache is not None:
        cache[module] = params
    return params


def _stream_conv(spec: ConvSpec, params: ConvParams, carry, x, primed: bool):
    """One causal forward conv on a chunk. Unprimed (the first chunk) runs
    the regular padded path, identical to the whole-utterance prefix, and
    primes the carry from the chunk's raw tail."""
    weight, bias, norm_scale, norm_bias = params
    pt = _fwd_carry_len(spec)
    if primed:
        xin = x if pt == 0 else torch.cat([carry.to(x.dtype), x], dim=2)
        span = (int(spec.kernel_size) - 1) * int(spec.dilation) + 1
        if xin.shape[2] < span:
            # the flush cascade can bring fewer samples than one window: the
            # whole-utterance path emits nothing for them either
            y = x.new_zeros(x.shape[0], spec.out_channels, 0)
        else:
            y = F.conv1d(xin, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                         stride=int(spec.stride), dilation=int(spec.dilation), groups=spec.groups)
            y = apply_post_norm(spec, y, norm_scale, norm_bias)
    else:
        xin = x
        y = apply_sconv1d(spec, x, weight, bias, norm_scale, norm_bias)
    if pt == 0:
        new_carry = carry
    elif not primed and xin.shape[2] < pt:
        # a first chunk shorter than the receptive context: the carry holds part
        # of the stream-start pad (exact for constant / replicate pads; reflect
        # would need future samples, which min_first_chunk forbids)
        new_carry = pad1d_time(xin, (pt, 0), mode=spec.pad_mode)[:, :, -pt:]
    elif xin.shape[2] >= pt:
        new_carry = xin[:, :, xin.shape[2] - pt:]
    else:  # a short primed chunk (flush tails): shift the window
        new_carry = torch.cat([carry.to(xin.dtype), xin], dim=2)[:, :, -pt:]
    return y, new_carry


def _stream_conv_transpose(spec: ConvSpec, params: ConvParams, carry, x, primed: bool, flush: bool = False):
    """One causal transposed conv on a chunk: overlap-add the carried tail,
    emit the final L*s samples (less the one-time left trim), carry the new
    bias-free tail. With `flush` (the end of the stream) the part of the
    tail the whole-utterance trim keeps, pt - ceil(pt * trim_right_ratio)
    samples, is emitted too."""
    weight, bias, norm_scale, norm_bias = params
    k, s = int(spec.kernel_size), int(spec.stride)
    pt = k - s
    L = x.shape[2]
    if L > 0:
        y = F.conv_transpose1d(x, weight.to(x.dtype), None, stride=s, groups=spec.groups)  # (B, Cout, L*s + pt)
        if pt > 0:
            y = torch.cat([y[:, :, :pt] + carry.to(y.dtype), y[:, :, pt:]], dim=2)
    else:  # the flush cascade reached us with nothing new: only the tail remains
        y = carry
    keep = pt - math.ceil(pt * spec.trim_right_ratio) if flush and pt > 0 else 0
    emit, new_carry = y[:, :, : L * s + keep], y[:, :, L * s:]
    if bias is not None:
        emit = emit + bias.to(emit.dtype)[:, None]
    emit = apply_post_norm(spec, emit, norm_scale, norm_bias)
    if not primed:
        pad_left = pt - math.ceil(pt * spec.trim_right_ratio)
        if pad_left > 0:
            emit = emit[:, :, pad_left:]
    return emit, new_carry


def _shortcut(spec: ConvSpec, params: ConvParams, x):
    """A resblock's 1x1 causal shortcut conv (pt == 0, stateless)."""
    if x.shape[2] == 0:
        return x.new_zeros(x.shape[0], spec.out_channels, 0)
    return apply_sconv1d(spec, x, *params)


def stream_layers(
    layers: Sequence[Layer],
    modules: Sequence[nn.Module],
    state: Sequence[Any],
    x: torch.Tensor,
    primed: bool,
    flush: bool = False,
    weights: Optional[Dict[nn.Module, ConvParams]] = None,
) -> Tuple[torch.Tensor, List[Any]]:
    """One chunk (B, C, L) through a causal layer stack with explicit carries.

    `primed=False` is the first chunk: convs take the standard causal padded
    path (so the stream start's pad_mode semantics match the whole-utterance
    computation) and initialize their carries from raw inputs. `flush=True`
    is the last: transposed convs emit their held-back tails too, which
    cascade through the layers below like ordinary input; the flush input
    may be zero-length. `weights` caches each conv's parameters."""
    new_state: List[Any] = []
    for (kind, spec), m, st in zip(layers, modules, state, strict=True):
        if kind == "conv":
            params = conv_params(m, weights)
            if spec.transposed:
                x, ns = _stream_conv_transpose(spec, params, st, x, primed, flush)
            else:
                x, ns = _stream_conv(spec, params, st, x, primed)
            new_state.append(ns)
        elif kind in ("act", "snake"):
            x = m(x)
            new_state.append(None)
        elif kind == "lstm":
            _dim, _nlayers, skip = spec
            if x.shape[2] == 0:
                new_state.append(st)
            else:
                x, carries = apply_slstm_streaming(m.lstm, x, st, skip=skip)
                new_state.append(carries)
        elif kind == "resblock":
            block, shortcut = spec
            y, sub = stream_layers(block, list(m.block), st["block"], x, primed, flush, weights)
            # the block's convs are stride 1 (span-padded): y has x's length
            sc = x if shortcut is None else _shortcut(shortcut, conv_params(m.shortcut, weights), x)
            x = sc + y
            new_state.append({"block": sub, "shortcut": None})
        else:
            raise NotImplementedError(f"streaming {kind!r}")
    return x, new_state


class StreamingCodecSession:
    """Chunked encode / decode over a causal Encodec: live audio in, tokens
    out (and tokens in, audio out), exact to the whole-utterance path.

        sess = StreamingCodecSession(model, batch=1)
        for chunk in audio_chunks:             # (B, L), hop | L
            tokens = sess.encode_chunk(chunk)  # (n_q, B, L / hop)
            wav = sess.decode_chunk(tokens)    # (B, L)
        tail = sess.flush()

    A live stream has no segment to normalize by, so sessions run unscaled:
    tokens match ``inference_encoding(use_scale=False)``. The session runs
    on the model's device in `dtype`, each conv's weight fused and cast
    once.
    """

    def __init__(self, model, batch: int = 1, n_q: Optional[int] = None, bandwidth: Optional[float] = None,
                 dtype=torch.float32):
        _check_streamable(model.encoder.cfg)
        _check_streamable(model.decoder.cfg)
        if getattr(model.cfg, "audio_normalize", False):
            raise ValueError(
                "audio_normalize computes a whole-segment volume statistic, not available on a live "
                "stream; build the model with audio_normalize=False (tokens then match "
                "inference_encoding(use_scale=False))"
            )
        self.model = model
        self.device = next(model.parameters()).device
        self.hop = math.prod(model.encoder.cfg.ratios)
        self.dtype = dtype
        self.n_q = model.quantizer.n_q_for_bandwidth(bandwidth) if n_q is None else n_q
        self.batch = batch
        self._enc_layers = model.encoder.layers
        self._dec_layers = model.decoder.layers
        self._enc_modules = list(model.encoder.model)
        self._dec_modules = list(model.decoder.model)
        self._enc_state = init_stream_state(self._enc_layers, batch, dtype, self.device)
        self._dec_state = init_stream_state(self._dec_layers, batch, dtype, self.device)
        self._enc_primed = False
        self._dec_primed = False
        self._enc_min = min_first_chunk(self._enc_layers)
        self._dec_min = min_first_chunk(self._dec_layers)
        self._weights: Dict[nn.Module, ConvParams] = {}
        for m in list(model.encoder.modules()) + list(model.decoder.modules()):
            if hasattr(m, "spec") and isinstance(m.spec, ConvSpec):
                conv_params(m, self._weights, dtype)

    @torch.no_grad()
    def encode_chunk(self, wav) -> torch.Tensor:
        """(B, L) waveform chunk, hop | L -> token ids (n_q, B, L / hop)."""
        wav = torch.as_tensor(wav).to(device=self.device, dtype=self.dtype)
        if wav.dim() == 1:
            wav = wav[None]
        L = wav.shape[1]
        if L % self.hop != 0:
            raise ValueError(f"chunk length {L} must be a multiple of hop {self.hop}")
        if not self._enc_primed and L < self._enc_min:
            raise ValueError(
                f"first chunk must be >= {self._enc_min} samples: reflect padding mirrors the stream "
                "start (see min_first_chunk); shorter first chunks need pad_mode='constant'"
            )
        y, self._enc_state = stream_layers(self._enc_layers, self._enc_modules, self._enc_state, wav[:, None, :],
                                           self._enc_primed, weights=self._weights)
        self._enc_primed = True
        return self.model.quantizer.encode(y.transpose(1, 2))[: self.n_q]

    @torch.no_grad()
    def decode_chunk(self, codes) -> torch.Tensor:
        """Token ids (n_q', B, T frames) -> waveform (B, T * hop)."""
        codes = torch.as_tensor(codes).to(self.device)
        if not self._dec_primed and codes.shape[2] < self._dec_min:
            raise ValueError(f"first chunk must be >= {self._dec_min} frames (reflect padding mirrors the "
                             "stream start)")
        emb = self.model.quantizer.decode(codes).to(self.dtype).transpose(1, 2)
        y, self._dec_state = stream_layers(self._dec_layers, self._dec_modules, self._dec_state, emb,
                                           self._dec_primed, weights=self._weights)
        self._dec_primed = True
        return y[:, 0]

    @torch.no_grad()
    def flush(self) -> Optional[torch.Tensor]:
        """End the decode stream: cascade every transposed conv's held-back
        tail through the layers below and emit the result. After the
        decode_chunk outputs it reproduces the whole-utterance decoder output.
        None at trim_right_ratio 1.0, where the causal trim drops all tails."""
        if not self._dec_primed:
            return None
        dim = self._dec_layers[0][1].in_channels
        empty = torch.zeros(self.batch, dim, 0, dtype=self.dtype, device=self.device)
        tail, self._dec_state = stream_layers(self._dec_layers, self._dec_modules, self._dec_state, empty,
                                              primed=True, flush=True, weights=self._weights)
        return None if tail.shape[2] == 0 else tail[:, 0]
