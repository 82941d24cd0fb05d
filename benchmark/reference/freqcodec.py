"""Plain PyTorch FreqCodec (mag_phase) of a FunCodec config: STFT features,
2D SEANet encoder, greedy residual VQ, 2D SEANet decoder, iSTFT.

FreqCodec (FunCodec's ``models/codec_freq.py``; arXiv:2309.07405) codes the
STFT of the waveform instead of the waveform: a center, Hann-windowed STFT
(``domain_n_fft``, ``domain_hop_length``) gives log-magnitude and unit phase
(re, im) features in (B, 3, F, T'); a 2D SEANet over (freq, time) with
grouped convs (``conv_group_ratio`` r: n / 2 / r groups for a conv of n
channels, one group for r <= 0) downsamples both axes until the frequency
axis is 1, drops it, and runs the residual LSTM and the last 1D conv; the
decoder mirrors it with grouped transposed 2D convs back to (B, 3, F, T'),
and the waveform is the iSTFT of softplus(magnitude) times the phase. It
reads a state dict under FunCodec's parameter names
(``encoder.model.{i}.conv.conv.weight``, ``...block.{j}...``,
``decoder.model.{i}.convtr.convtr.weight``, ``quantizer.rq.model.embed``) and
computes in float32 with TF32 off. It imports nothing of the program under
test; the 1D pieces (the LSTM, the 1D convs, the RVQ search, the served
PCM16) are ``benchmark/reference/codec.py``'s.

Departures from FunCodec's ``codec_freq.py`` and ``SEANetEncoder2d`` /
``SEANetDecoder2d``, each deliberate:

- the layer lists are the repository's transcription of the released
  FreqCodec topology (``scripts/bench_freqcodec.freq_config``), not a read of
  the released ``config.yaml``, which is not in the repository;
- ``torch.stft`` / ``torch.istft`` stand for the transforms (plain
  operations here; FunCodec calls the same functions);
- the 2D time padding puts the extra samples that fill the last window on
  the left, as FunCodec's non-causal ``SConv2d`` does (``SConv1d`` puts them
  on the right);
- only what FreqCodec gr8 / gr1 serving uses: mag_phase on both sides,
  ``time_group_norm`` or ``none``, non-causal reflect-padded convs, ELU
  activations, an LSTM bottleneck, no segmenting. Anything else raises.

``Precision`` (codec.py's) lets the same code run as the benchmark's
control: every conv, transposed conv, LSTM and codebook search takes its
weights and its input through ``Precision.cast``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import codec as ref
from benchmark.reference.codec import Precision

Layer = Tuple[str, dict]
Pair = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class SEANet2d:
    """The 2D SEANet fields a FunCodec ``encoder_conf`` / ``decoder_conf`` may
    set; `ratios` are (freq, time) pairs in decoder order."""

    channels: int = 3
    dimension: int = 128
    n_filters: int = 32
    n_residual_layers: int = 1
    ratios: Tuple[Pair, ...] = ((4, 1), (4, 1), (4, 2), (4, 1))
    alpha: float = 1.0
    norm: str = "weight_norm"
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    causal: bool = False
    pad_mode: str = "reflect"
    true_skip: bool = False
    compress: int = 2
    lstm: int = 2
    last_out_padding: Tuple[Pair, Pair] = ((0, 1), (0, 0))
    conv_group_ratio: int = -1
    tr_conv_group_ratio: int = -1

    @staticmethod
    def from_conf(conf: dict, dimension: int, channels: int) -> "SEANet2d":
        conf = dict(conf)
        kw = {"dimension": dimension, "channels": int(conf.pop("channels", channels))}
        if "activation_params" in conf:
            kw["alpha"] = float(dict(conf.pop("activation_params")).get("alpha", 1.0))
        if conf.pop("activation", "ELU") != "ELU":
            raise ValueError("the reference covers ELU activations")
        if conf.pop("seq_model", "lstm") != "lstm" or not conf.pop("res_seq", True):
            raise ValueError("the reference covers a residual LSTM bottleneck")
        if "seq_layer_num" in conf:
            kw["lstm"] = int(conf.pop("seq_layer_num"))
        known = {f.name for f in dataclasses.fields(SEANet2d)}
        for k, v in conf.items():
            if k not in known:
                raise ValueError(f"the reference does not cover 2D SEANet key {k!r}")
            if k in ("ratios", "last_out_padding"):
                v = tuple(tuple(int(i) for i in pair) for pair in v)
            kw[k] = v
        cfg = SEANet2d(**kw)
        if cfg.norm not in ("time_group_norm", "none") or cfg.causal or cfg.pad_mode != "reflect":
            raise ValueError("the reference covers non-causal reflect-padded convs with time_group_norm or none")
        return cfg

    def as_1d(self) -> ref.SEANet:
        """The settings codec.py's 1D convs read."""
        return ref.SEANet(norm=self.norm, causal=self.causal, pad_mode=self.pad_mode, alpha=self.alpha)


def groups(n: int, ratio: int) -> int:
    return n // 2 // ratio if ratio > 0 else 1


def _conv2d(cin: int, cout: int, k: Pair, stride: Pair = (1, 1), dilation: Pair = (1, 1), g: int = 1) -> Layer:
    return ("conv2d", dict(cin=cin, cout=cout, k=k, stride=stride, dilation=dilation, groups=g))


def _resblock2d(cfg: SEANet2d, dim: int, time_dilation: int) -> Layer:
    hidden = dim // cfg.compress
    g = groups(hidden, cfg.conv_group_ratio)
    k = cfg.residual_kernel_size
    return ("resblock2d", dict(
        block=[_conv2d(dim, hidden, (k, k), dilation=(1, time_dilation), g=g), _conv2d(hidden, dim, (1, 1), g=g)],
        shortcut=None if cfg.true_skip else _conv2d(dim, dim, (1, 1), g=groups(dim, cfg.conv_group_ratio)),
    ))


def encoder_layers(cfg: SEANet2d) -> List[Layer]:
    """SEANetEncoder2d's nn.Sequential, index for index."""
    nf, k = cfg.n_filters, cfg.kernel_size
    out: List[Layer] = [_conv2d(cfg.channels, nf, (k, k))]
    mult = 1
    for fr, tr in reversed(cfg.ratios):
        for j in range(cfg.n_residual_layers):
            out.append(_resblock2d(cfg, mult * nf, cfg.dilation_base ** j))
        out.append(("elu", {}))
        out.append(_conv2d(mult * nf, 2 * mult * nf, (2 * fr, 2 * tr), (fr, tr),
                           g=groups(mult * nf, cfg.conv_group_ratio)))
        mult *= 2
    out += [("squeeze", {}), ("lstm", dict(dim=mult * nf, layers=cfg.lstm)), ("elu", {}),
            ("conv", dict(cin=mult * nf, cout=cfg.dimension, k=cfg.last_kernel_size, stride=1, dilation=1))]
    return out


def decoder_layers(cfg: SEANet2d) -> List[Layer]:
    """SEANetDecoder2d's nn.Sequential, index for index; the last transposed
    conv keeps ``last_out_padding``."""
    nf = cfg.n_filters
    mult = 2 ** len(cfg.ratios)
    out: List[Layer] = [("conv", dict(cin=cfg.dimension, cout=mult * nf, k=cfg.kernel_size, stride=1, dilation=1)),
                        ("lstm", dict(dim=mult * nf, layers=cfg.lstm)), ("unsqueeze", {})]
    for i, (fr, tr) in enumerate(cfg.ratios):
        c = mult * nf
        last = i == len(cfg.ratios) - 1
        out.append(("elu", {}))
        out.append(("convtr2d", dict(cin=c, cout=c // 2, k=(2 * fr, 2 * tr), stride=(fr, tr),
                                     groups=groups(c, cfg.tr_conv_group_ratio),
                                     out_padding=cfg.last_out_padding if last else ((0, 0), (0, 0)))))
        for j in range(cfg.n_residual_layers):
            out.append(_resblock2d(cfg, c // 2, cfg.dilation_base ** j))
        mult //= 2
    k = cfg.last_kernel_size
    out += [("elu", {}), _conv2d(nf, cfg.channels, (k, k))]
    return out


@dataclasses.dataclass(frozen=True)
class FreqCodec:
    """The FreqCodec of one FunCodec config dict."""

    encoder: SEANet2d
    decoder: SEANet2d
    n_q: int
    bins: int
    dim: int
    hop: int  # samples a codec frame (the quantizer's encoder_hop_length)
    n_fft: int
    stft_hop: int
    audio_normalize: bool

    @staticmethod
    def from_config(config: dict) -> "FreqCodec":
        mc = dict(config.get("model_conf", {}))
        if config.get("model") != "freq_codec" or mc.get("segment_dur") is not None:
            raise ValueError("the reference covers the unsegmented freq_codec model")
        if tuple(mc.get("codec_domain", ("mag_phase", "mag_phase"))) != ("mag_phase", "mag_phase"):
            raise ValueError("the reference covers the mag_phase domain on both sides")
        if mc.get("phase_invariant_training") or config.get("encoder") != "encodec_seanet_encoder_2d" \
                or config.get("decoder") != "encodec_seanet_decoder_2d":
            raise ValueError("the reference covers the 2D SEANet encoder and decoder")
        odim = mc.get("odim", 128)
        qc = config.get("quantizer_conf", {})
        if qc.get("codec_dim") not in (None, odim) or qc.get("codec_range") is not None:
            raise ValueError("the reference covers a quantizer without projections")
        channels = config.get("input_size", 3)
        codec = FreqCodec(
            encoder=SEANet2d.from_conf(config.get("encoder_conf", {}), odim, channels),
            decoder=SEANet2d.from_conf(config.get("decoder_conf", {}), odim, channels),
            n_q=qc.get("num_quantizers", 32), bins=qc.get("codebook_size", 1024), dim=odim,
            hop=qc.get("encoder_hop_length", 320), n_fft=mc.get("domain_n_fft", 512),
            stft_hop=mc.get("domain_hop_length", 160), audio_normalize=mc.get("audio_normalize", True),
        )
        if codec.encoder.channels != 3 or codec.decoder.channels != 3:
            raise ValueError("mag_phase features have 3 channels on both sides")
        if codec.hop != codec.stft_hop * math.prod(t for _, t in codec.encoder.ratios):
            raise ValueError("the quantizer's hop is the STFT hop times the encoder's time strides")
        return codec

    def frames(self, samples: int) -> int:
        """Codec frames of a (., samples) input: the center STFT's
        samples // stft_hop + 1 frames through the encoder's time strides."""
        t = samples // self.stft_hop + 1
        for _, tr in self.encoder.ratios:
            t = -(-t // tr)
        return t

    def param_specs(self) -> List[Tuple[str, Tuple[int, ...], str, float]]:
        """(name, shape, law, bound) of every tensor of the model's state dict,
        with codec.py's laws: convs, transposed convs and the LSTM torch's
        default initialisers' bounds (U(+-1 / sqrt(fan_in)), fan_in the
        weight's second dimension times its kernel), every norm a gain of
        1 +- NORM_GAIN and a shift of +- NORM_SHIFT per channel, the
        codebooks U(+-sqrt(2/6) sqrt(3/dim)) and their EMA state."""
        specs = []
        for side, cfg, layers in (("encoder", self.encoder, encoder_layers(self.encoder)),
                                  ("decoder", self.decoder, decoder_layers(self.decoder))):
            for i, (kind, s) in enumerate(layers):
                specs += _layer_specs(f"{side}.model.{i}", kind, s, cfg)
        q = "quantizer.rq.model"
        cb = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / self.dim)
        specs += [(f"{q}.inited", (self.n_q,), "ones", 0.0),
                  (f"{q}.cluster_size", (self.n_q, self.bins), "zeros", 0.0),
                  (f"{q}.embed", (self.n_q, self.bins, self.dim), "uniform", cb),
                  (f"{q}.embed_avg", (self.n_q, self.bins, self.dim), f"copy:{q}.embed", 0.0)]
        return specs


def _conv2d_specs(prefix: str, kind: str, s: dict, cfg: SEANet2d):
    inner = "convtr.convtr" if kind == "convtr2d" else "conv.conv"
    kf, kt = s["k"]
    if kind == "convtr2d":
        w_shape = (s["cin"], s["cout"] // s["groups"], kf, kt)
    else:
        w_shape = (s["cout"], s["cin"] // s["groups"], kf, kt)
    bound = 1.0 / math.sqrt(w_shape[1] * kf * kt)
    out = [(f"{prefix}.{inner}.weight", w_shape, "uniform", bound),
           (f"{prefix}.{inner}.bias", (s["cout"],), "uniform", bound)]
    if cfg.norm == "time_group_norm":
        norm = f"{prefix}.{inner.split('.')[0]}.norm"
        out += [(f"{norm}.weight", (s["cout"],), "one_plus_uniform", ref.NORM_GAIN),
                (f"{norm}.bias", (s["cout"],), "uniform", ref.NORM_SHIFT)]
    return out


def _layer_specs(prefix: str, kind: str, s: dict, cfg: SEANet2d):
    if kind in ("conv2d", "convtr2d"):
        return _conv2d_specs(prefix, kind, s, cfg)
    if kind == "resblock2d":
        out = []
        for j, (k2, s2) in enumerate(s["block"]):
            out += _conv2d_specs(f"{prefix}.block.{2 * j + 1}", k2, s2, cfg)
        if s["shortcut"] is not None:
            out += _conv2d_specs(f"{prefix}.shortcut", *s["shortcut"], cfg)
        return out
    if kind in ("conv", "lstm"):
        return ref._layer_specs(prefix, kind, s, cfg.as_1d())
    return []


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _reflect2d(x: torch.Tensor, time: Pair, freq: Pair) -> torch.Tensor:
    """Reflect pads on (freq, time) of (B, C, F, T); an axis no longer than
    its largest pad is zero-extended on the right first and the extension
    dropped after (SEANet's small-input fixup)."""
    extra_t = max(time) - x.shape[3] + 1 if x.shape[3] <= max(time) else 0
    extra_f = max(freq) - x.shape[2] + 1 if x.shape[2] <= max(freq) else 0
    x = F.pad(x, (0, extra_t, 0, extra_f))
    y = F.pad(x, (time[0], time[1], freq[0], freq[1]), mode="reflect")
    return y[:, :, : y.shape[2] - extra_f, : y.shape[3] - extra_t]


def _norm2d(y: torch.Tensor, sd, name: str, cfg: SEANet2d) -> torch.Tensor:
    """GroupNorm(1, C): statistics over each sample's channels, freq and time."""
    if cfg.norm != "time_group_norm":
        return y
    mean = y.mean(dim=(1, 2, 3), keepdim=True)
    var = (y - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    yn = (y - mean) / torch.sqrt(var + 1e-5)
    return yn * sd[f"{name}.weight"].float()[None, :, None, None] + sd[f"{name}.bias"].float()[None, :, None, None]


def _apply_conv2d(x, sd, prefix: str, s: dict, cfg: SEANet2d, p: Precision) -> torch.Tensor:
    """SConv2d: each axis padded by (k - 1) d - (s - 1), the odd sample on the
    left; time also by the extra samples that fill the last window, on the left."""
    (kf, kt), (sf, st), (df, dt) = s["k"], s["stride"], s["dilation"]
    w, b = p.cast(sd[f"{prefix}.conv.conv.weight"]), sd[f"{prefix}.conv.conv.bias"].float()
    pf, pt = (kf - 1) * df - (sf - 1), (kt - 1) * dt - (st - 1)
    n_frames = (x.shape[-1] - kt + pt) / st + 1
    extra = (math.ceil(n_frames) - 1) * st + (kt - pt) - x.shape[-1]
    x = _reflect2d(x, (pt - pt // 2 + extra, pt // 2), (pf - pf // 2, pf // 2))
    y = F.conv2d(p.cast(x), w, b, stride=(sf, st), dilation=(df, dt), groups=s["groups"])
    return _norm2d(y, sd, f"{prefix}.conv.norm", cfg)


def _apply_convtr2d(x, sd, prefix: str, s: dict, cfg: SEANet2d, p: Precision) -> torch.Tensor:
    """SConvTranspose2d: the norm over the whole output, then k - s trimmed from
    each axis (the odd sample on the left), less ``out_padding`` kept."""
    (kf, kt), (sf, st) = s["k"], s["stride"]
    w, b = p.cast(sd[f"{prefix}.convtr.convtr.weight"]), sd[f"{prefix}.convtr.convtr.bias"].float()
    y = F.conv_transpose2d(p.cast(x), w, b, stride=(sf, st), groups=s["groups"])
    y = _norm2d(y, sd, f"{prefix}.convtr.norm", cfg)
    (fo_l, fo_r), (to_l, to_r) = s["out_padding"]
    pf, pt = kf - sf, kt - st
    f_l, f_r = max(pf - pf // 2 - fo_l, 0), max(pf // 2 - fo_r, 0)
    t_l, t_r = max(pt - pt // 2 - to_l, 0), max(pt // 2 - to_r, 0)
    return y[:, :, f_l: y.shape[2] - f_r, t_l: y.shape[3] - t_r]


def run_stack(x: torch.Tensor, sd, side: str, cfg: SEANet2d, layers: List[Layer], p: Precision) -> torch.Tensor:
    # float32 means float32: no TF32 in cuDNN's convs or cuBLAS's matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i, (kind, s) in enumerate(layers):
        prefix = f"{side}.model.{i}"
        if kind == "conv2d":
            x = _apply_conv2d(x, sd, prefix, s, cfg, p)
        elif kind == "convtr2d":
            x = _apply_convtr2d(x, sd, prefix, s, cfg, p)
        elif kind == "conv":
            x = ref._apply_conv(x, sd, prefix, s, cfg.as_1d(), p)
        elif kind == "elu":
            x = F.elu(x, alpha=cfg.alpha)
        elif kind == "lstm":
            x = ref._apply_lstm(x, sd, prefix, s, p)
        elif kind == "squeeze":
            assert x.shape[2] == 1, x.shape
            x = x[:, :, 0]
        elif kind == "unsqueeze":
            x = x[:, :, None]
        elif kind == "resblock2d":
            y = x
            for j, (_, s2) in enumerate(s["block"]):
                y = _apply_conv2d(F.elu(y, alpha=cfg.alpha), sd, f"{prefix}.block.{2 * j + 1}", s2, cfg, p)
            short = x if s["shortcut"] is None else _apply_conv2d(x, sd, f"{prefix}.shortcut", s["shortcut"][1],
                                                                  cfg, p)
            x = short + y
        else:
            raise ValueError(kind)
    return x


def _window(codec: FreqCodec, device) -> torch.Tensor:
    return torch.hann_window(codec.n_fft, periodic=True, dtype=torch.float32, device=device)


def features(codec: FreqCodec, x: torch.Tensor) -> torch.Tensor:
    """(B, T) waveform -> (B, 3, F, T') mag_phase features: log |X| (|X|
    clamped at 1e-6) and X / |X| as (re, im), of the center reflect-padded
    Hann STFT."""
    spec = torch.stft(x.float(), codec.n_fft, codec.stft_hop, codec.n_fft, _window(codec, x.device), center=True,
                      pad_mode="reflect", normalized=False, onesided=True, return_complex=True)
    mag = spec.abs().clamp_min(1e-6)
    return torch.stack([mag.log(), spec.real / mag, spec.imag / mag], dim=1)


def waveform(codec: FreqCodec, out: torch.Tensor) -> torch.Tensor:
    """(B, 3, F, T') decoder output -> (B, (T' - 1) stft_hop) waveform: the
    center iSTFT of softplus(out[:, 0]) (out[:, 1] + i out[:, 2])."""
    spec = F.softplus(out[:, 0].float()) * torch.complex(out[:, 1].float(), out[:, 2].float())
    return torch.istft(spec, codec.n_fft, codec.stft_hop, codec.n_fft, _window(codec, out.device), center=True,
                       normalized=False, onesided=True, return_complex=False)


def encode_latents(codec: FreqCodec, sd, wav: torch.Tensor, p: Precision = Precision()):
    """(B, T) float waveform -> (latents (B, T', D), scale (B, 1) or None)."""
    x = wav.float()
    scale = None
    if codec.audio_normalize:
        scale = 1e-8 + x.square().mean(dim=-1, keepdim=True).sqrt()
        x = x / scale
    z = run_stack(features(codec, x), sd, "encoder", codec.encoder, encoder_layers(codec.encoder), p)
    return z.transpose(1, 2), scale


def decode(codec: FreqCodec, sd, quantized: torch.Tensor, scale: Optional[torch.Tensor],
           p: Precision = Precision()) -> torch.Tensor:
    """(B, T', D) -> (B, samples) waveform, times the encoder's scale."""
    out = run_stack(quantized.float().transpose(1, 2), sd, "decoder", codec.decoder, decoder_layers(codec.decoder), p)
    y = waveform(codec, out)
    return y if scale is None else y * scale


def serve(codec: FreqCodec, sd, wav: torch.Tensor, ilens: torch.Tensor, n_q: int, p: Precision):
    """What a serving request returns, computed at precision p: (indices
    (n_q, B, T') int64, PCM16 (B, T) int16)."""
    z, scale = encode_latents(codec, sd, wav, p)
    idx = ref.rvq_encode(codec, sd, z, n_q, p)
    recon = decode(codec, sd, ref.rvq_decode(sd, idx, p), scale, p)[:, : wav.shape[-1]]
    pcm = torch.round(ref.pcm16_float(recon, ilens)).clamp(-32768, 32767).to(torch.int16)
    return idx, pcm
