"""Plain PyTorch EnCodec of a FunCodec config: SEANet encoder, greedy
residual VQ, SEANet decoder.

It reads a state dict under FunCodec's parameter names
(``encoder.model.{i}.conv.conv.weight``, ``...block.{j}...``,
``...lstm.weight_ih_l0``, ``decoder.model.{i}.convtr.convtr.weight``,
``quantizer.rq.model.embed``) and computes in float32 with TF32 off. It
imports nothing of the program under test: the layer list follows the
published SEANet (Tagliasacchi et al., arXiv:2009.02095; EnCodec,
arXiv:2210.13438) as FunCodec's ``encodec_seanet_{encoder,decoder}``
builds it.

``Precision`` lets the same code run as the benchmark's control: every
conv, transposed conv, LSTM and codebook search takes its weights and its
input through ``Precision.cast`` (fp8 e4m3 with a per-tensor scale for the
control, identity for the reference).

Covered: 1D SEANet with norm ``time_group_norm`` or ``none``, non-causal
or causal streamable convs, reflect or zero pads, an LSTM bottleneck,
ELU(alpha) activations, audio normalisation, no segmenting. Anything else
raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Layer = Tuple[str, dict]

# the group norms' per-channel gain 1 + U(-NORM_GAIN, NORM_GAIN) and shift
# U(-NORM_SHIFT, NORM_SHIFT) (torch initialises them to 1 and 0, where any
# error in the affine would read nothing)
NORM_GAIN, NORM_SHIFT = 0.5, 0.1


@dataclasses.dataclass(frozen=True)
class SEANet:
    """The SEANet fields a FunCodec ``encoder_conf`` / ``decoder_conf`` may set
    (defaults as FunCodec's encodec_seanet_{encoder,decoder})."""

    channels: int = 1
    dimension: int = 128
    n_filters: int = 32
    n_residual_layers: int = 1
    ratios: Tuple[int, ...] = (8, 5, 4, 2)
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

    @staticmethod
    def from_conf(conf: dict, dimension: int) -> "SEANet":
        conf = dict(conf)
        known = {f.name for f in dataclasses.fields(SEANet)}
        kw = {"dimension": dimension}
        if "activation_params" in conf:
            kw["alpha"] = float(dict(conf.pop("activation_params")).get("alpha", 1.0))
        if conf.pop("activation", "ELU") != "ELU":
            raise ValueError("the reference covers ELU activations")
        if conf.pop("seq_model", "lstm") != "lstm" or not conf.pop("res_seq", True):
            raise ValueError("the reference covers a residual LSTM bottleneck")
        if "seq_layer_num" in conf:
            kw["lstm"] = int(conf.pop("seq_layer_num"))
        for k, v in conf.items():
            if k not in known:
                raise ValueError(f"the reference does not cover SEANet key {k!r}")
            kw[k] = tuple(v) if isinstance(v, list) else v
        cfg = SEANet(**kw)
        if cfg.norm not in ("time_group_norm", "none"):
            raise ValueError(f"the reference covers norms time_group_norm and none, not {cfg.norm}")
        return cfg


def _conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1, tr: bool = False) -> Layer:
    return ("convtr" if tr else "conv", dict(cin=cin, cout=cout, k=k, stride=stride, dilation=dilation))


def _resblock(cfg: SEANet, dim: int, dilation: int) -> Layer:
    hidden = dim // cfg.compress
    return ("resblock", dict(
        block=[_conv(dim, hidden, cfg.residual_kernel_size, dilation=dilation), _conv(hidden, dim, 1)],
        shortcut=None if cfg.true_skip else _conv(dim, dim, 1),
    ))


def encoder_layers(cfg: SEANet) -> List[Layer]:
    """The encoder's nn.Sequential, index for index."""
    out: List[Layer] = [_conv(cfg.channels, cfg.n_filters, cfg.kernel_size)]
    mult = 1
    for ratio in reversed(cfg.ratios):
        for j in range(cfg.n_residual_layers):
            out.append(_resblock(cfg, mult * cfg.n_filters, cfg.dilation_base ** j))
        out.append(("elu", {}))
        out.append(_conv(mult * cfg.n_filters, 2 * mult * cfg.n_filters, 2 * ratio, stride=ratio))
        mult *= 2
    out += [("lstm", dict(dim=mult * cfg.n_filters, layers=cfg.lstm)), ("elu", {}),
            _conv(mult * cfg.n_filters, cfg.dimension, cfg.last_kernel_size)]
    return out


def decoder_layers(cfg: SEANet) -> List[Layer]:
    """The decoder's nn.Sequential, index for index."""
    mult = 2 ** len(cfg.ratios)
    out: List[Layer] = [_conv(cfg.dimension, mult * cfg.n_filters, cfg.kernel_size),
                        ("lstm", dict(dim=mult * cfg.n_filters, layers=cfg.lstm))]
    for ratio in cfg.ratios:
        c = mult * cfg.n_filters
        out.append(("elu", {}))
        out.append(_conv(c, c // 2, 2 * ratio, stride=ratio, tr=True))
        for j in range(cfg.n_residual_layers):
            out.append(_resblock(cfg, c // 2, cfg.dilation_base ** j))
        mult //= 2
    out += [("elu", {}), _conv(cfg.n_filters, cfg.channels, cfg.last_kernel_size)]
    return out


@dataclasses.dataclass(frozen=True)
class Codec:
    """The EnCodec of one FunCodec config dict."""

    encoder: SEANet
    decoder: SEANet
    n_q: int
    bins: int
    dim: int
    hop: int
    audio_normalize: bool

    @staticmethod
    def from_config(config: dict) -> "Codec":
        mc = config.get("model_conf", {})
        if config.get("model", "encodec") != "encodec" or mc.get("segment_dur") is not None:
            raise ValueError("the reference covers the unsegmented encodec model")
        odim = mc.get("odim", 128)
        qc = config.get("quantizer_conf", {})
        if qc.get("codec_dim") not in (None, odim) or qc.get("codec_range") is not None:
            raise ValueError("the reference covers a quantizer without projections")
        dec_conf = dict(config.get("decoder_conf", {}))
        return Codec(
            encoder=SEANet.from_conf(config.get("encoder_conf", {}), odim),
            decoder=SEANet.from_conf(dec_conf, odim),
            n_q=qc.get("num_quantizers", 32), bins=qc.get("codebook_size", 1024), dim=odim,
            hop=qc.get("encoder_hop_length", 320), audio_normalize=mc.get("audio_normalize", True),
        )

    def param_specs(self) -> List[Tuple[str, Tuple[int, ...], str, float]]:
        """(name, shape, law, bound) of every tensor of the model's state dict:
        law "uniform" draws U(-bound, bound), "one_plus_uniform" 1 +
        U(-bound, bound), "ones" and "zeros" are constant, "copy:<name>"
        repeats another tensor (the EMA sums start at the codebooks). Convs,
        LSTM and codebooks take torch's default initialisers' bounds; group
        norms a gain of 1 +- NORM_GAIN and a shift of +- NORM_SHIFT per
        channel, so that a kernel that drops, swaps or misreads either
        changes what is served."""
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


def _conv_specs(prefix: str, kind: str, s: dict, cfg: SEANet):
    inner = "convtr.convtr" if kind == "convtr" else "conv.conv"
    w_shape = (s["cin"], s["cout"], s["k"]) if kind == "convtr" else (s["cout"], s["cin"], s["k"])
    bound = 1.0 / math.sqrt(w_shape[1] * s["k"])
    out = [(f"{prefix}.{inner}.weight", w_shape, "uniform", bound), (f"{prefix}.{inner}.bias", (s["cout"],), "uniform", bound)]
    if cfg.norm == "time_group_norm":
        norm = f"{prefix}.{inner.split('.')[0]}.norm"
        out += [(f"{norm}.weight", (s["cout"],), "one_plus_uniform", NORM_GAIN),
                (f"{norm}.bias", (s["cout"],), "uniform", NORM_SHIFT)]
    return out


def _layer_specs(prefix: str, kind: str, s: dict, cfg: SEANet):
    if kind in ("conv", "convtr"):
        return _conv_specs(prefix, kind, s, cfg)
    if kind == "resblock":
        out = []
        for j, (k2, s2) in enumerate(s["block"]):
            out += _conv_specs(f"{prefix}.block.{2 * j + 1}", k2, s2, cfg)
        if s["shortcut"] is not None:
            out += _conv_specs(f"{prefix}.shortcut", *s["shortcut"], cfg)
        return out
    if kind == "lstm":
        d, bound = s["dim"], 1.0 / math.sqrt(s["dim"])
        out = []
        for l in range(s["layers"]):
            out += [(f"{prefix}.lstm.weight_ih_l{l}", (4 * d, d), "uniform", bound),
                    (f"{prefix}.lstm.weight_hh_l{l}", (4 * d, d), "uniform", bound),
                    (f"{prefix}.lstm.bias_ih_l{l}", (4 * d,), "uniform", bound),
                    (f"{prefix}.lstm.bias_hh_l{l}", (4 * d,), "uniform", bound)]
        return out
    return []


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


class Precision:
    """float32 as it is (the reference)."""

    name = "float32"

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.float()


class Fp8(Precision):
    """fp8 e4m3 with a per-tensor scale (amax to 448), the rounding a
    bf16 -> fp8 change would bring; the arithmetic stays float32."""

    name = "fp8_e4m3"

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        scale = t.abs().amax().clamp_min(1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _pad(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    if mode == "reflect":
        extra = max(left, right) - x.shape[-1] + 1 if x.shape[-1] <= max(left, right) else 0
        if extra:
            x = F.pad(x, (0, extra))
        y = F.pad(x, (left, right), mode="reflect")
        return y[..., : y.shape[-1] - extra]
    if mode in ("zero", "constant"):
        return F.pad(x, (left, right))
    raise ValueError(f"the reference covers reflect and zero pads, not {mode}")


def _group_norm(y: torch.Tensor, sd: Dict[str, torch.Tensor], name: str, cfg: SEANet) -> torch.Tensor:
    if cfg.norm != "time_group_norm":
        return y
    mean = y.mean(dim=(1, 2), keepdim=True)
    var = (y - mean).square().mean(dim=(1, 2), keepdim=True)
    yn = (y - mean) / torch.sqrt(var + 1e-5)
    return yn * sd[f"{name}.weight"].float()[None, :, None] + sd[f"{name}.bias"].float()[None, :, None]


def _apply_conv(x, sd, prefix: str, s: dict, cfg: SEANet, p: Precision) -> torch.Tensor:
    k, st, d = s["k"], s["stride"], s["dilation"]
    w, b = p.cast(sd[f"{prefix}.conv.conv.weight"]), sd[f"{prefix}.conv.conv.bias"].float()
    total = (k - 1) * d - (st - 1)
    n_frames = (x.shape[-1] - k + total) / st + 1
    extra = (math.ceil(n_frames) - 1) * st + (k - total) - x.shape[-1]
    right = 0 if cfg.causal else total // 2
    x = _pad(x, total - right, right + extra, cfg.pad_mode)
    y = F.conv1d(p.cast(x), w, b, stride=st, dilation=d)
    return _group_norm(y, sd, f"{prefix}.conv.norm", cfg)


def _apply_convtr(x, sd, prefix: str, s: dict, cfg: SEANet, p: Precision) -> torch.Tensor:
    k, st = s["k"], s["stride"]
    w, b = p.cast(sd[f"{prefix}.convtr.convtr.weight"]), sd[f"{prefix}.convtr.convtr.bias"].float()
    y = F.conv_transpose1d(p.cast(x), w, b, stride=st)
    y = _group_norm(y, sd, f"{prefix}.convtr.norm", cfg)
    total = k - st
    right = total if cfg.causal else total // 2
    return y[..., total - right: y.shape[-1] - right]


def _apply_lstm(x, sd, prefix: str, s: dict, p: Precision) -> torch.Tensor:
    """torch's stacked LSTM (gates i, f, g, o) with the residual skip. cuDNN
    is off, so the steps run torch's own cell in float32 matmuls; the
    control rounds the weights and each layer's input sequence."""
    d = s["dim"]
    h_in = x.permute(2, 0, 1)  # (T, B, C)
    seq = h_in
    with torch.backends.cudnn.flags(enabled=False), torch.no_grad():
        for l in range(s["layers"]):
            one = torch.nn.LSTM(d, d, 1, device=x.device)
            for name, t in one.named_parameters():  # weight_ih_l0, ..., bias_hh_l0
                src = sd[f"{prefix}.lstm.{name[:-1]}{l}"]
                t.copy_(p.cast(src) if name.startswith("weight") else src.float())
            seq = one(p.cast(seq))[0]
    return (seq + h_in).permute(1, 2, 0)


def run_stack(x: torch.Tensor, sd, side: str, cfg: SEANet, layers: List[Layer], p: Precision) -> torch.Tensor:
    for i, (kind, s) in enumerate(layers):
        prefix = f"{side}.model.{i}"
        if kind == "conv":
            x = _apply_conv(x, sd, prefix, s, cfg, p)
        elif kind == "convtr":
            x = _apply_convtr(x, sd, prefix, s, cfg, p)
        elif kind == "elu":
            x = F.elu(x, alpha=cfg.alpha)
        elif kind == "lstm":
            x = _apply_lstm(x, sd, prefix, s, p)
        elif kind == "resblock":
            y = x
            for j, (_, s2) in enumerate(s["block"]):
                y = _apply_conv(F.elu(y, alpha=cfg.alpha), sd, f"{prefix}.block.{2 * j + 1}", s2, cfg, p)
            short = x if s["shortcut"] is None else _apply_conv(x, sd, f"{prefix}.shortcut", s["shortcut"][1], cfg, p)
            x = short + y
        else:
            raise ValueError(kind)
    return x


def encode_latents(codec: Codec, sd, wav: torch.Tensor, p: Precision = Precision()):
    """(B, T) float waveform -> (latents (B, T', D), scale (B, 1))."""
    x = wav.float()
    scale = None
    if codec.audio_normalize:
        scale = 1e-8 + x.square().mean(dim=-1, keepdim=True).sqrt()
        x = x / scale
    z = run_stack(x[:, None, :], sd, "encoder", codec.encoder, encoder_layers(codec.encoder), p)
    return z.transpose(1, 2), scale


def scores(residual: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """2 r.e - ||e||^2 for every codeword: (N, D), (bins, D) -> (N, bins);
    the nearest codeword scores highest."""
    return 2.0 * residual @ embed.T - embed.square().sum(dim=-1)[None, :]


def rvq_encode(codec: Codec, sd, z: torch.Tensor, n_q: int, p: Precision = Precision()) -> torch.Tensor:
    """Greedy residual search: (B, T', D) -> indices (n_q, B, T')."""
    embed = sd["quantizer.rq.model.embed"].float()
    B, T, D = z.shape
    r = z.reshape(B * T, D).float()
    idx = []
    for q in range(n_q):
        e = p.cast(embed[q])
        i = scores(p.cast(r), e).argmax(dim=-1)
        r = r - e[i]
        idx.append(i)
    return torch.stack(idx).reshape(n_q, B, T)


def rvq_decode(sd, indices: torch.Tensor, p: Precision = Precision()) -> torch.Tensor:
    """indices (n_q, B, T') -> (B, T', D), the sum of the chosen codewords."""
    embed = sd["quantizer.rq.model.embed"].float()
    out = 0.0
    for q in range(indices.shape[0]):
        out = out + p.cast(embed[q])[indices[q].long()]
    return out


def decode(codec: Codec, sd, quantized: torch.Tensor, scale: Optional[torch.Tensor], p: Precision = Precision()):
    """(B, T', D) -> (B, T' * hop) waveform, times the encoder's scale."""
    y = run_stack(quantized.float().transpose(1, 2), sd, "decoder", codec.decoder, decoder_layers(codec.decoder), p)
    y = y[:, 0, :]
    return y if scale is None else y * scale


def pcm16_float(recon: torch.Tensor, ilens: torch.Tensor) -> torch.Tensor:
    """The served PCM16 of a reconstruction before rounding: each row scaled
    down to a peak of 0.99 over its valid samples, times 32767."""
    mask = torch.arange(recon.shape[1], device=recon.device)[None, :] < ilens[:, None]
    peak = (recon.abs() * mask).amax(dim=1, keepdim=True)
    scale = torch.where(peak > 0.99, 0.99 / peak.clamp_min(1e-12), torch.ones_like(peak))
    return recon * scale * 32767.0


def serve(codec: Codec, sd, wav: torch.Tensor, ilens: torch.Tensor, n_q: int, p: Precision):
    """What a serving request returns, computed at precision p: (indices
    (n_q, B, T') int64, PCM16 (B, T) int16)."""
    z, scale = encode_latents(codec, sd, wav, p)
    idx = rvq_encode(codec, sd, z, n_q, p)
    recon = decode(codec, sd, rvq_decode(sd, idx, p), scale, p)
    pcm = torch.round(pcm16_float(recon, ilens)).clamp(-32768, 32767).to(torch.int16)
    return idx, pcm
