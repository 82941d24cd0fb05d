"""HiFiGAN and SoundStream discriminator families (port of funcodec_tpu/models/discriminators_extra.py).

Behavioral reference: funcodec/models/discriminator/hifigan.py
(HiFiGANPeriodDiscriminator :307-444, HiFiGANMultiPeriodDiscriminator
:444-503, HiFiGANScaleDiscriminator :503-672, HiFiGANMultiScaleDiscriminator
:672-756, HiFiGANMultiScaleMultiPeriodDiscriminator :756-845) and
funcodec/models/discriminator/sound_stream.py (ConvDiscriminator :12-58,
MultiScaleDiscriminator :60-98, ModReLU :100-112, ComplexConv2d :114-147,
ComplexSTFTDiscriminator :149-232).

Parameters carry the reference's state_dict names: ``convs.{i}.0`` and
``output_conv`` (period), ``layers.{i}.0`` and ``layers.{n}`` (scale),
``discriminators.{i}`` (the multi-period / multi-scale containers),
``msd`` / ``mpd``, and SoundStream's ``discriminators.{d}.init_conv``,
``conv_layers.{i}.0``, ``final_conv.{0,2}``. The complex-STFT
discriminator's convs are real/imaginary pairs, named after the JAX
package's tree: ``init_conv.{re,im}``, ``units.{i}.c1.{re,im}``,
``units.{i}.b`` (ModReLU's bias), ``units.{i}.c2.{re,im}``,
``final_conv.{re,im}``. Weights and biases are drawn U(+-1/sqrt(fan_in))
from a ``torch.Generator``, as the JAX package draws them.

Quirks kept from the reference, as the JAX package keeps them:

- HiFiGANScaleDiscriminator.apply_weight_norm tests isinstance Conv2d on its
  Conv1d stack (hifigan.py:652-659), so scale discriminators run without
  weight norm; period discriminators (Conv2d) have it.
- Each SoundStream scale pools the original signal by its relative factor
  (sound_stream.py:88-91): scales (1, 0.5, 0.25) see 1x, 2x and 2x.
- The complex-STFT discriminator runs its convs in the STFT's fp32 whatever
  the input's type (the weights are cast to the features' type, as JAX
  casts its kernels), returns complex fmaps and |logits|.

Layout is torch's: waveforms (B, T); 1D features (B, C, T); the period
discriminator's (B, C, T / P, P); the complex-STFT's (B, C, F, T').
Every sub-discriminator returns (logits, [fmaps]).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from funcodec_tpu_torch.ops.conv import add_weight_norm, layer_weight
from funcodec_tpu_torch.ops.stft import stft


def _uniform_init(layer: nn.Module, fan_in: int, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)


class Conv1d(nn.Conv1d):
    """nn.Conv1d whose weight (weight-norm fused, when it holds weight_g /
    weight_v) and bias are cast to the input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv1d(x, layer_weight(self).to(x.dtype), bias, self.stride, self.padding, self.dilation,
                        self.groups)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with Conv1d's casts and weight norm."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, layer_weight(self).to(x.dtype), bias, self.stride, self.padding, self.dilation,
                        self.groups)


def make_conv1d(cin: int, cout: int, k: int, *, stride: int = 1, padding: int = 0, groups: int = 1,
                device=None, generator: torch.Generator) -> Conv1d:
    layer = Conv1d(cin, cout, k, stride=stride, padding=padding, groups=groups, device=device)
    _uniform_init(layer, (cin // groups) * k, generator)
    return layer


def make_conv2d(cin: int, cout: int, k: Tuple[int, int], *, stride=(1, 1), padding=(0, 0),
                weight_norm: bool = False, device=None, generator: torch.Generator) -> Conv2d:
    layer = Conv2d(cin, cout, tuple(k), stride=tuple(stride), padding=tuple(padding), device=device)
    _uniform_init(layer, cin * k[0] * k[1], generator)
    if weight_norm:
        add_weight_norm(layer)
    return layer


def _slope(params: Optional[Dict[str, Any]]) -> float:
    return (params or {"negative_slope": 0.1})["negative_slope"]


# ---------------------------------------------------------------------------
# HiFiGAN period discriminator (hifigan.py:307-444)
# ---------------------------------------------------------------------------


class HiFiGANPeriodDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 1, period: int = 3,
                 kernel_sizes: Sequence[int] = (5, 3), channels: int = 32,
                 downsample_scales: Sequence[int] = (3, 3, 3, 3, 1), max_downsample_channels: int = 1024,
                 nonlinear_activation_params: Optional[Dict[str, Any]] = None, use_weight_norm: bool = True,
                 *, device=None, generator: torch.Generator, **_unused):
        super().__init__()
        self.period = period
        self.slope = _slope(nonlinear_activation_params)
        convs = []
        in_chs, out_chs = in_channels, channels
        for scale in downsample_scales:
            conv = make_conv2d(in_chs, out_chs, (kernel_sizes[0], 1), stride=(scale, 1),
                               padding=((kernel_sizes[0] - 1) // 2, 0), weight_norm=use_weight_norm,
                               device=device, generator=generator)
            convs.append(nn.Sequential(conv, nn.LeakyReLU(self.slope)))
            in_chs = out_chs
            out_chs = min(out_chs * 4, max_downsample_channels)
        self.convs = nn.ModuleList(convs)
        self.output_conv = make_conv2d(in_chs, out_channels, (kernel_sizes[1] - 1, 1),
                                       padding=((kernel_sizes[1] - 1) // 2, 0), weight_norm=use_weight_norm,
                                       device=device, generator=generator)

    def forward(self, x: torch.Tensor):
        """x (B, T) -> (logits (B, T'), [fmaps (B, C, T / P, P)])."""
        b, t = x.shape
        if t % self.period != 0:
            n_pad = self.period - t % self.period
            x = F.pad(x[:, None], (0, n_pad), mode="reflect")[:, 0]
            t += n_pad
        z = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for layer in self.convs:
            z = layer(z)
            fmap.append(z)
        return self.output_conv(z).reshape(b, -1), fmap


class HiFiGANMultiPeriodDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 1, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 discriminator_params: Optional[Dict[str, Any]] = None, *, device=None,
                 generator: torch.Generator, **_unused):
        super().__init__()
        dp = dict(discriminator_params or {})
        dp["in_channels"] = in_channels
        self.discriminators = nn.ModuleList(
            HiFiGANPeriodDiscriminator(**{**dp, "period": p}, device=device, generator=generator) for p in periods)

    def forward(self, x: torch.Tensor):
        return [d(x) for d in self.discriminators]


# ---------------------------------------------------------------------------
# HiFiGAN scale discriminator (hifigan.py:503-756)
# ---------------------------------------------------------------------------


class HiFiGANScaleDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 1, kernel_sizes: Sequence[int] = (15, 41, 5, 3),
                 channels: int = 128, max_downsample_channels: int = 1024, max_groups: int = 16,
                 downsample_scales: Sequence[int] = (2, 2, 4, 4, 1),
                 nonlinear_activation_params: Optional[Dict[str, Any]] = None, *, device=None,
                 generator: torch.Generator, **_unused):
        super().__init__()
        slope = _slope(nonlinear_activation_params)
        kw = dict(device=device, generator=generator)
        # weight norm is a no-op here (the reference checks Conv2d on Conv1d layers)
        convs = [make_conv1d(in_channels, channels, kernel_sizes[0], padding=(kernel_sizes[0] - 1) // 2, **kw)]
        in_chs = out_chs = channels
        groups = 4
        for scale in downsample_scales:
            convs.append(make_conv1d(in_chs, out_chs, kernel_sizes[1], stride=scale,
                                     padding=(kernel_sizes[1] - 1) // 2, groups=groups, **kw))
            in_chs = out_chs
            out_chs = min(in_chs * 2, max_downsample_channels)
            groups = min(groups * 4, max_groups)
        out_chs = min(in_chs * 2, max_downsample_channels)
        convs.append(make_conv1d(in_chs, out_chs, kernel_sizes[2], padding=(kernel_sizes[2] - 1) // 2, **kw))
        layers = [nn.Sequential(c, nn.LeakyReLU(slope)) for c in convs]
        layers.append(make_conv1d(out_chs, out_channels, kernel_sizes[3], padding=(kernel_sizes[3] - 1) // 2, **kw))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor):
        """x (B, T) -> (logits (B, 1, T'), [fmaps (B, C, T_i)])."""
        z = x[:, None]
        fmap = []
        for layer in self.layers[:-1]:
            z = layer(z)
            fmap.append(z)
        return self.layers[-1](z), fmap


class HiFiGANMultiScaleDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 1, scales: int = 3,
                 downsample_pooling_params: Optional[Dict[str, Any]] = None,
                 discriminator_params: Optional[Dict[str, Any]] = None, *, device=None,
                 generator: torch.Generator, **_unused):
        super().__init__()
        dp = dict(discriminator_params or {})
        dp["in_channels"] = in_channels
        self.discriminators = nn.ModuleList(
            HiFiGANScaleDiscriminator(**dp, device=device, generator=generator) for _ in range(scales))
        pp = downsample_pooling_params or {"kernel_size": 4, "stride": 2, "padding": 2}
        self.pool = (pp["kernel_size"], pp["stride"], pp["padding"])

    def forward(self, x: torch.Tensor):
        outs = []
        for d in self.discriminators:
            outs.append(d(x))
            x = F.avg_pool1d(x[:, None], *self.pool)[:, 0]
        return outs


class HiFiGANMultiScaleMultiPeriodDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 1, scales: int = 3, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 scale_discriminator_params=None, period_discriminator_params=None,
                 scale_downsample_pooling_params=None, *, device=None, generator: torch.Generator, **_unused):
        super().__init__()
        self.msd = HiFiGANMultiScaleDiscriminator(
            in_channels=in_channels, scales=scales, downsample_pooling_params=scale_downsample_pooling_params,
            discriminator_params=scale_discriminator_params, device=device, generator=generator)
        self.mpd = HiFiGANMultiPeriodDiscriminator(
            in_channels=in_channels, periods=periods, discriminator_params=period_discriminator_params,
            device=device, generator=generator)

    def forward(self, x: torch.Tensor):
        return self.msd(x) + self.mpd(x)


# ---------------------------------------------------------------------------
# SoundStream discriminators (sound_stream.py)
# ---------------------------------------------------------------------------


class ConvDiscriminator(nn.Module):
    """Waveform conv discriminator (sound_stream.py:12-58)."""

    def __init__(self, in_channels: int = 1, channels: int = 16, layers: int = 4, groups: int = 4,
                 chan_max: int = 1024, *, device=None, generator: torch.Generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.init_conv = make_conv1d(in_channels, channels, 7, **kw)
        convs = []
        curr = channels
        for _ in range(layers):
            out = min(curr * 4, chan_max)
            convs.append(nn.Sequential(make_conv1d(curr, out, 8, stride=4, padding=4, groups=groups, **kw),
                                       nn.LeakyReLU(0.1)))
            curr = out
        self.conv_layers = nn.ModuleList(convs)
        self.final_conv = nn.Sequential(make_conv1d(curr, curr, 3, **kw), nn.LeakyReLU(0.1),
                                        make_conv1d(curr, 1, 1, **kw))

    def forward(self, x: torch.Tensor):
        z = self.init_conv(x[:, None])
        fmap = []
        for layer in self.conv_layers:
            z = layer(z)
            fmap.append(z)
        return self.final_conv(z), fmap


class MultiScaleDiscriminator(nn.Module):
    """SoundStream multi-scale waveform discriminator (sound_stream.py:60-98)."""

    def __init__(self, in_channels: int = 1, disc_multi_scales: Sequence[float] = (1, 0.5, 0.25),
                 discriminator_params: Optional[Dict[str, Any]] = None, *, device=None,
                 generator: torch.Generator, **_unused):
        super().__init__()
        dp = discriminator_params or dict(channels=16, layers=4, groups=4, chan_max=1024)
        self.discriminators = nn.ModuleList(
            ConvDiscriminator(in_channels=in_channels, **dp, device=device, generator=generator)
            for _ in disc_multi_scales)
        factors = [int(s1 / s2) for s1, s2 in zip(disc_multi_scales[:-1], disc_multi_scales[1:])]
        self.pools = [None] + [(2 * f, f, f) for f in factors]

    def forward(self, x: torch.Tensor):
        # each scale pools the original signal by its relative factor (the reference's quirk)
        return [d(x if pool is None else F.avg_pool1d(x[:, None], *pool)[:, 0])
                for d, pool in zip(self.discriminators, self.pools)]


class ComplexConv2d(nn.Module):
    """A complex conv as a real/imaginary pair of real convs: (re + i im) *
    (w_re + i w_im), each part's bias added inside its conv, as torch's
    complex bias (re bias + i im bias) is."""

    def __init__(self, cin: int, cout: int, k: Tuple[int, int], *, stride=(1, 1), padding=(0, 0), device=None,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(stride=stride, padding=padding, device=device, generator=generator)
        self.re = make_conv2d(cin, cout, k, **kw)
        self.im = make_conv2d(cin, cout, k, **kw)

    def forward(self, re: torch.Tensor, im: torch.Tensor):
        both = torch.cat([re, im])  # each real conv on both parts at once
        w_re, w_im = self.re(both).chunk(2), self.im(both).chunk(2)
        return w_re[0] - w_im[1], w_im[0] + w_re[1]


def _modrelu(b: torch.Tensor, re: torch.Tensor, im: torch.Tensor):
    mag = torch.sqrt(re.square() + im.square() + 1e-12)
    scale = F.relu(mag + b) / mag
    return re * scale, im * scale


class _ComplexUnit(nn.Module):
    def __init__(self, c1: ComplexConv2d, c2: ComplexConv2d, device):
        super().__init__()
        self.c1 = c1
        self.b = nn.Parameter(torch.zeros((), device=device))  # ModReLU's bias
        self.c2 = c2

    def forward(self, re, im):
        re, im = _modrelu(self.b, *self.c1(re, im))
        return self.c2(re, im)


class ComplexSTFTDiscriminator(nn.Module):
    """Complex STFT discriminator (sound_stream.py:149-232): complex convs as
    real/imaginary pairs, ModReLU, |logits| (logits_abs=True)."""

    def __init__(self, in_channels: int = 1, channels: int = 32,
                 strides=((1, 2), (2, 2), (1, 2), (2, 2), (1, 2), (2, 2)), chan_mults=(1, 2, 4, 4, 8, 8),
                 n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024, stft_normalized: bool = False,
                 *, device=None, generator: torch.Generator, **_unused):
        super().__init__()
        self.n_fft, self.hop, self.win = n_fft, hop_length, win_length
        self.normalized = stft_normalized
        kw = dict(device=device, generator=generator)
        self.init_conv = ComplexConv2d(in_channels, channels, (7, 7), padding=(3, 3), **kw)
        layer_channels = (channels,) + tuple(m * channels for m in chan_mults)
        units = []
        for stride, (cin, cout) in zip(strides, zip(layer_channels[:-1], layer_channels[1:])):
            ks = tuple(s + 2 for s in stride)
            units.append(_ComplexUnit(ComplexConv2d(cin, cin, (3, 3), padding=(1, 1), **kw),
                                      ComplexConv2d(cin, cout, ks, stride=tuple(stride),
                                                    padding=tuple(k // 2 for k in ks), **kw), device))
        self.units = nn.ModuleList(units)
        self.final_conv = ComplexConv2d(layer_channels[-1], 1, (16, 1), **kw)

    def forward(self, x: torch.Tensor):
        """x (B, T) -> (|logits| (B, 1, F', T''), [complex fmaps (B, C, F_i, T_i)])."""
        spec = stft(x, self.n_fft, self.hop, self.win, center=True, normalized=self.normalized)  # (B, F, T') complex64
        re, im = self.init_conv(spec.real[:, None], spec.imag[:, None])
        fmap = [torch.complex(re, im)]
        for unit in self.units:
            re, im = unit(re, im)
            fmap.append(torch.complex(re, im))
        lr, li = self.final_conv(re, im)
        return torch.sqrt(lr.square() + li.square() + 1e-12), fmap


EXTRA_DISC_REGISTRY = {
    "hifigan_period_discriminator": HiFiGANPeriodDiscriminator,
    "hifigan_scale_discriminator": HiFiGANScaleDiscriminator,
    "hifigan_multi_period_discriminator": HiFiGANMultiPeriodDiscriminator,
    "hifigan_multi_scale_discriminator": HiFiGANMultiScaleDiscriminator,
    "hifigan_multi_scale_multi_period_discriminator": HiFiGANMultiScaleMultiPeriodDiscriminator,
    "soundstream_multi_scale_discriminator": MultiScaleDiscriminator,
    "soundstream_complex_stft_discriminator": ComplexSTFTDiscriminator,
}
