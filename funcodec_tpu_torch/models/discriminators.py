"""The MS-STFT discriminator (port of funcodec_tpu/models/discriminators.py).

``DiscriminatorSTFT`` is the plain conv tower of one STFT scale: the
complex spectrogram's real and imaginary parts as two channels, a first 2D
conv without norm, weight-normed dilated convs strided in frequency, a
square conv and ``conv_post``, each conv but the last followed by a leaky
ReLU of slope 0.2. ``MultiScaleSTFTDiscriminator`` runs three of them and
average-pools each one's logits; ``MultipleDiscriminator`` flattens the
outputs of the discriminators its config names.

Layout is torch's NCHW with H the STFT frame and W the frequency bin:
features (B, C, T', F), logits (B, 1, t, f). The JAX package keeps the same
tensors channels-last, (B, T', F, C). Weights are torch's (Cout, Cin, kt,
kf) under ``discriminators.{i}.discriminators.{j}.convs.{k}.conv`` and
``.conv_post.conv`` (``weight`` for the first conv, ``weight_g``/``weight_v``
after it), the layout of the reference's ModuleLists of NormConv2d modules.

The JAX package's blocked-F tower (``BLOCKED_F``: groups of frequency bins
folded into channels, so that the TPU's 128-lane matrix unit is filled) is
not ported: its logits and losses equal the plain tower's, which cuDNN runs
here. The HiFiGAN and SoundStream discriminators live in
models/discriminators_extra.py; the registry takes any mix.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from funcodec_tpu_torch.models.discriminators_extra import EXTRA_DISC_REGISTRY
from funcodec_tpu_torch.ops.conv import add_weight_norm, layer_weight
from funcodec_tpu_torch.ops.stft import stft


@dataclasses.dataclass(frozen=True)
class PlainConv2dSpec:
    """torch nn.Conv2d with explicit symmetric padding (+ optional weight norm)."""

    in_channels: int
    out_channels: int
    kernel_size: Tuple[int, int]
    stride: Tuple[int, int] = (1, 1)
    dilation: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    norm: str = "none"  # none | weight_norm


def init_plain_conv2d(spec: PlainConv2dSpec, *, device, generator: torch.Generator) -> nn.Conv2d:
    """An nn.Conv2d of `spec`, weight and bias drawn U(+-1/sqrt(fan_in)) from
    `generator`; with weight_norm it holds weight_v and weight_g instead of weight."""
    kh, kw = spec.kernel_size
    layer = nn.Conv2d(spec.in_channels, spec.out_channels, (kh, kw), stride=spec.stride,
                      dilation=spec.dilation, padding=spec.padding, device=device)
    bound = 1.0 / math.sqrt(spec.in_channels * kh * kw)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    if spec.norm == "weight_norm":
        add_weight_norm(layer)
    elif spec.norm != "none":
        raise ValueError(f"conv2d norm {spec.norm!r}")
    return layer


class NormConv2d(nn.Module):
    """Holds one conv at ``.conv``, as the reference's NormConv2d does."""

    def __init__(self, spec: PlainConv2dSpec, *, device, generator: torch.Generator):
        super().__init__()
        self.spec = spec
        self.conv = init_plain_conv2d(spec, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_plain_conv2d(self.spec, self.conv, x)


def apply_plain_conv2d(spec: PlainConv2dSpec, layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """x (B, Cin, H, W) -> (B, Cout, H', W'), the weight and bias in x's type."""
    return F.conv2d(x, layer_weight(layer).to(x.dtype), layer.bias.to(x.dtype), stride=spec.stride,
                    padding=spec.padding, dilation=spec.dilation)


def avg_pool2d_4s2p1(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(4, stride=2, padding=1, count_include_pad=False) on (B, C, H, W)."""
    return F.avg_pool2d(x, 4, stride=2, padding=1, count_include_pad=False)


def _get_2d_padding(kernel_size, dilation=(1, 1)):
    return (
        ((kernel_size[0] - 1) * dilation[0]) // 2,
        ((kernel_size[1] - 1) * dilation[1]) // 2,
    )


class DiscriminatorSTFT(nn.Module):
    """One STFT-scale sub-discriminator: the plain conv tower."""

    def __init__(
        self,
        filters: int,
        in_channels: int = 1,
        out_channels: int = 1,
        n_fft: int = 1024,
        hop_length: int = 256,
        win_length: int = 1024,
        max_filters: int = 1024,
        filters_scale: int = 1,
        kernel_size: Tuple[int, int] = (3, 9),
        dilations: Sequence[int] = (1, 2, 4),
        stride: Tuple[int, int] = (1, 2),
        normalized: bool = True,
        norm: str = "weight_norm",
        activation_slope: float = 0.2,
        *,
        device=None,
        generator: torch.Generator,
    ):
        super().__init__()
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length
        self.normalized = normalized
        self.slope = activation_slope
        kernel_size, stride = tuple(kernel_size), tuple(stride)
        # the first conv has no norm (the reference omits the norm argument)
        specs: List[PlainConv2dSpec] = [
            PlainConv2dSpec(2 * in_channels, filters, kernel_size, padding=_get_2d_padding(kernel_size))
        ]
        in_chs = min(filters_scale * filters, max_filters)
        for i, dilation in enumerate(dilations):
            out_chs = min((filters_scale ** (i + 1)) * filters, max_filters)
            specs.append(PlainConv2dSpec(
                in_chs, out_chs, kernel_size, stride=stride, dilation=(dilation, 1),
                padding=_get_2d_padding(kernel_size, (dilation, 1)), norm=norm))
            in_chs = out_chs
        out_chs = min((filters_scale ** (len(dilations) + 1)) * filters, max_filters)
        square = (kernel_size[0], kernel_size[0])
        specs.append(PlainConv2dSpec(in_chs, out_chs, square, padding=_get_2d_padding(square), norm=norm))
        self.conv_specs = specs
        self.post_spec = PlainConv2dSpec(out_chs, out_channels, square, padding=_get_2d_padding(square), norm=norm)
        self.convs = nn.ModuleList(NormConv2d(s, device=device, generator=generator) for s in specs)
        self.conv_post = NormConv2d(self.post_spec, device=device, generator=generator)

    def forward(self, x: torch.Tensor):
        """x (B, T) waveform -> (logits (B, 1, t, f), [fmaps (B, C, t, f)]).

        The STFT is fp32; the tower runs in x's type."""
        z = stft(x, self.n_fft, self.hop_length, self.win_length, center=False, normalized=self.normalized)
        z = torch.view_as_real(z).permute(0, 3, 2, 1).to(x.dtype)  # (B, 2 [re, im], T', F)
        fmap = []
        for conv in self.convs:
            z = F.leaky_relu(conv(z), self.slope)
            fmap.append(z)
        return self.conv_post(z), fmap


class MultiScaleSTFTDiscriminator(nn.Module):
    """The 3-scale MS-STFT discriminator; each scale's logits average-pooled."""

    def __init__(
        self,
        filters: int = 32,
        in_channels: int = 1,
        out_channels: int = 1,
        n_ffts: Sequence[int] = (1024, 2048, 512),
        hop_lengths: Sequence[int] = (256, 512, 128),
        win_lengths: Sequence[int] = (1024, 2048, 512),
        *,
        device=None,
        generator: torch.Generator,
        **kwargs,
    ):
        super().__init__()
        assert len(n_ffts) == len(hop_lengths) == len(win_lengths)
        self.discriminators = nn.ModuleList(
            DiscriminatorSTFT(filters, in_channels=in_channels, out_channels=out_channels, n_fft=n_ffts[i],
                              win_length=win_lengths[i], hop_length=hop_lengths[i], device=device,
                              generator=generator, **kwargs)
            for i in range(len(n_ffts))
        )

    def forward(self, x: torch.Tensor):
        """x (B, T) -> [(pooled logits, fmaps)] per scale."""
        outs = []
        for d in self.discriminators:
            logits, fmap = d(x)
            outs.append((avg_pool2d_4s2p1(logits), fmap))
        return outs


class MultipleDiscriminator(nn.Module):
    """Name-registry container flattening all sub-discriminator outputs;
    the sub-discriminators sit at ``discriminators.{i}``."""

    @staticmethod
    def registry():
        return {
            "encodec_multi_scale_stft_discriminator": MultiScaleSTFTDiscriminator,
            **EXTRA_DISC_REGISTRY,
        }

    def __init__(self, input_size: int = 1, disc_conf_list: Sequence[Dict[str, Any]] = (), *, device=None,
                 generator: torch.Generator):
        super().__init__()
        registry = self.registry()
        discs = []
        for conf in disc_conf_list:
            conf = dict(conf)
            name = conf.pop("name")
            if name not in registry:
                raise ValueError(f"unknown discriminator {name!r}")
            conf.setdefault("in_channels", input_size)
            discs.append(registry[name](**conf, device=device, generator=generator))
        self.discriminators = nn.ModuleList(discs)

    def forward(self, x: torch.Tensor):
        outs = []
        for d in self.discriminators:
            ret = d(x)
            if isinstance(ret, tuple):
                outs.append(ret)
            else:
                outs.extend(ret)
        return outs
