"""HiFiGAN generator, a vocoder (port of funcodec_tpu/models/hifigan_gen.py).

Behavioral reference: funcodec/models/discriminator/hifigan.py:23-105
(ResidualBlock: LeakyReLU -> dilated conv [-> LeakyReLU -> conv] + skip) and
:108-247 (HiFiGANGenerator: input conv, per stage LeakyReLU ->
ConvTranspose1d upsampling, num_blocks residual stacks averaged per stage,
LeakyReLU -> conv -> tanh head, optional global conditioning 1x1 conv,
weight norm everywhere, N(0, 0.01) init). No shipped codec config uses it
(SEANet is the production decoder).

Layout is the reference's: c (B, in_channels, T) [+ g (B, global_channels,
1)] -> (B, out_channels, T * prod(upsample_scales)). Parameters carry the
names funcodec_tpu/compat/torch_import.import_hifigan_generator reads:
``input_conv``, ``upsamples.{i}.1``, ``blocks.{k}.convs{1,2}.{j}.1``,
``output_conv.1``, ``global_conv``; with weight norm each holds
``weight_g`` / ``weight_v``. Weights are drawn N(0, 0.01) from a
``torch.Generator`` and biases start at 0, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from funcodec_tpu_torch.models.discriminators_extra import Conv1d
from funcodec_tpu_torch.ops.conv import add_weight_norm, layer_weight


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    in_channels: int = 80
    out_channels: int = 1
    channels: int = 512
    global_channels: int = -1
    kernel_size: int = 7
    upsample_scales: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    use_additional_convs: bool = True
    bias: bool = True
    negative_slope: float = 0.1
    use_weight_norm: bool = True

    def __post_init__(self):
        assert self.kernel_size % 2 == 1
        assert len(self.upsample_scales) == len(self.upsample_kernel_sizes)
        for k, s in zip(self.upsample_kernel_sizes, self.upsample_scales):
            assert k == 2 * s, "HiFiGAN requires K == 2*scale (hifigan.py:172)"

    @property
    def upsample_factor(self) -> int:
        f = self.out_channels
        for s in self.upsample_scales:
            f *= s
        return f


class ConvTranspose1d(nn.ConvTranspose1d):
    """nn.ConvTranspose1d with the weight (weight-norm fused) and bias cast to
    the input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose1d(x, layer_weight(self).to(x.dtype), bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


def _init(layer: nn.Module, wn: bool, generator: torch.Generator) -> nn.Module:
    """N(0, 0.01) weight, zero bias (hifigan.py:252-262), then weight norm."""
    with torch.no_grad():
        layer.weight.normal_(0.0, 0.01, generator=generator)
        if layer.bias is not None:
            layer.bias.zero_()
    if wn:
        add_weight_norm(layer)
    return layer


def _conv_same(cin: int, cout: int, k: int, dilation: int, cfg: HiFiGANConfig, device, generator,
               bias: bool = True) -> Conv1d:
    """A torch Conv1d with "same" padding (K - 1) // 2 * dilation."""
    layer = Conv1d(cin, cout, k, padding=(k - 1) // 2 * dilation, dilation=dilation, bias=bias, device=device)
    return _init(layer, cfg.use_weight_norm, generator)


class ResidualBlock(nn.Module):
    """``convs1.{j}`` / ``convs2.{j}``: (LeakyReLU, conv) pairs; x + each stack."""

    def __init__(self, channels: int, kernel_size: int, dilations, cfg: HiFiGANConfig, *, device, generator):
        super().__init__()
        self.use_additional_convs = cfg.use_additional_convs
        lrelu = lambda: nn.LeakyReLU(cfg.negative_slope)  # noqa: E731
        self.convs1 = nn.ModuleList(
            nn.Sequential(lrelu(), _conv_same(channels, channels, kernel_size, d, cfg, device, generator, cfg.bias))
            for d in dilations)
        if cfg.use_additional_convs:
            self.convs2 = nn.ModuleList(
                nn.Sequential(lrelu(), _conv_same(channels, channels, kernel_size, 1, cfg, device, generator, cfg.bias))
                for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j, conv1 in enumerate(self.convs1):
            xt = conv1(x)
            if self.use_additional_convs:
                xt = self.convs2[j](xt)
            x = xt + x
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig(), *, device=None, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        self.input_conv = _conv_same(cfg.in_channels, cfg.channels, cfg.kernel_size, 1, cfg, **kw)
        ups, blocks = [], []
        for i, (s, k) in enumerate(zip(cfg.upsample_scales, cfg.upsample_kernel_sizes)):
            cin, cout = cfg.channels // 2**i, cfg.channels // 2 ** (i + 1)
            # K = 2s, padding ceil(s / 2), output_padding s % 2: exact T -> T * s
            convtr = ConvTranspose1d(cin, cout, k, stride=s, padding=s // 2 + s % 2, output_padding=s % 2,
                                     device=device)
            ups.append(nn.Sequential(nn.LeakyReLU(cfg.negative_slope), _init(convtr, cfg.use_weight_norm, generator)))
            for kb, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations):
                blocks.append(ResidualBlock(cout, kb, dils, cfg, **kw))
        self.upsamples = nn.ModuleList(ups)
        self.blocks = nn.ModuleList(blocks)
        cout = cfg.channels // 2 ** len(cfg.upsample_scales)
        # the head's LeakyReLU has torch's default slope 0.01 (hifigan.py:202)
        self.output_conv = nn.Sequential(nn.LeakyReLU(0.01),
                                         _conv_same(cout, cfg.out_channels, cfg.kernel_size, 1, cfg, **kw), nn.Tanh())
        if cfg.global_channels > 0:
            self.global_conv = _conv_same(cfg.global_channels, cfg.channels, 1, 1, cfg, **kw)

    def forward(self, c: torch.Tensor, g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """c (B, in_channels, T) [+ g (B, global_channels, 1)] -> (B, out_channels, T * prod(s))."""
        x = self.input_conv(c)
        if g is not None:
            x = x + self.global_conv(g)
        nb = len(self.cfg.resblock_kernel_sizes)
        for i, up in enumerate(self.upsamples):
            x = up(x)
            cs = sum(self.blocks[i * nb + j](x) for j in range(nb))
            x = cs / nb
        return self.output_conv(x)
