"""2D (frequency x time) SEANet encoder/decoder for FreqCodec (port of
funcodec_tpu/models/seanet2d.py).

The layer lists are the JAX package's, item for item, so the modules carry
the reference names (``encoder.model.{i}.conv.conv.weight``,
``encoder.model.{i}.block.{j}...``). Inside the stack the layout is
torch's (B, C, F, T): the encoder takes spectrogram features (B, C, F, T),
downsamples freq and time with strided grouped 2D convs, drops the freq
axis once it is 1 ("squeeze"), and runs the sequence model and the last
conv in 1D, returning latents (B, T', D). The decoder mirrors it and
returns (B, C, F, T). The JAX package keeps (B, F, T, C); the FreqCodec
model builds its features in this layout directly.

The fused 1D kernels reach the 1D tail only: the ELU + last encoder conv
and the first decoder conv through ``FUSED_STRIDE1``. The 2D residual
blocks are never fused (models/seanet.py takes only SConv1d layers), as the
JAX package refuses them (``_try_fused_resblock``: ``x.ndim != 3``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from funcodec_tpu_torch.models.seanet import Layer, _build_stack
from funcodec_tpu_torch.ops.conv import ConvSpec


def _freeze_ratios(ratios) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(f), int(t)) for f, t in ratios)


@dataclasses.dataclass(frozen=True)
class SEANetConfig2d:
    """`ratios` are (freq, time) pairs in decoder order; the encoder applies
    them reversed."""

    input_size: int = 1
    dimension: int = 128
    n_filters: int = 32
    n_residual_layers: int = 1
    ratios: Tuple[Tuple[int, int], ...] = ((4, 1), (4, 1), (4, 2), (4, 1))
    activation: str = "ELU"
    activation_params: Tuple[Tuple[str, Any], ...] = (("alpha", 1.0),)
    norm: str = "weight_norm"
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_base: int = 2
    causal: bool = False
    pad_mode: str = "reflect"
    true_skip: bool = False
    compress: int = 2
    seq_model: str = "lstm"
    seq_layer_num: int = 2
    res_seq: bool = True
    trim_right_ratio: float = 1.0
    last_out_padding: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 1), (0, 0))
    conv_group_ratio: int = -1
    tr_conv_group_ratio: int = -1

    @property
    def act_kwargs(self) -> Dict[str, Any]:
        return dict(self.activation_params)

    @property
    def hop_length(self) -> int:
        return int(np.prod([t for _f, t in self.ratios]))

    @classmethod
    def from_conf(cls, conf: Dict[str, Any], **overrides) -> "SEANetConfig2d":
        """From a FunCodec ``encoder_conf`` / ``decoder_conf`` dict: ``channels``
        is input_size, ``norm_params`` is dropped (GroupNorm's one group is
        the default), unknown keys are ignored; `overrides` win."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in conf.items():
            if k == "norm_params":
                continue
            if k == "channels":
                k = "input_size"
            if k not in names:
                continue
            if k == "ratios":
                v = _freeze_ratios(v)
            elif k == "last_out_padding":
                v = tuple(tuple(p) for p in v)
            elif k == "activation_params" and isinstance(v, dict):
                v = tuple(sorted(v.items()))
            elif isinstance(v, list):
                v = tuple(v)
            kw[k] = v
        kw.update(overrides)
        return cls(**kw)


def _act2d(cfg: SEANetConfig2d, channels: int) -> Layer:
    if cfg.activation.lower() == "snake":
        return ("snake", channels)
    return ("act", (cfg.activation, cfg.act_kwargs))


def _groups(n: int, ratio: int) -> int:
    """conv_group_ratio r > 0 gives n // 2 // r groups (0, which no conv
    accepts, below n = 2r); r <= 0 gives one."""
    return n // 2 // ratio if ratio > 0 else 1


def _conv2d(cfg: SEANetConfig2d, cin: int, cout: int, k, **kw) -> Layer:
    return ("conv", ConvSpec(cin, cout, k, causal=cfg.causal, norm=cfg.norm, **kw))


def _resblock2d(cfg: SEANetConfig2d, dim: int, time_dilation: int) -> Layer:
    """SEANetResnetBlock2d: [act, conv (k, k) dilated (1, d), act, conv (1, 1)]
    + a (1, 1) shortcut conv unless true_skip; grouped by conv_group_ratio."""
    hidden = dim // cfg.compress
    k = cfg.residual_kernel_size
    io = [(dim, hidden, (k, k), (1, time_dilation)), (hidden, dim, (1, 1), (1, 1))]
    block: List[Layer] = []
    for in_chs, out_chs, ks, dil in io:
        block.append(_act2d(cfg, in_chs))
        block.append(_conv2d(cfg, in_chs, out_chs, ks, dilation=dil, pad_mode=cfg.pad_mode,
                             groups=_groups(min(in_chs, out_chs), cfg.conv_group_ratio)))
    shortcut = None if cfg.true_skip else _conv2d(
        cfg, dim, dim, (1, 1), groups=_groups(dim, cfg.conv_group_ratio), pad_mode=cfg.pad_mode)[1]
    return ("resblock", (tuple(block), shortcut))


def _seq_layer(cfg: SEANetConfig2d, dim: int) -> List[Layer]:
    if cfg.seq_model == "lstm":
        return [("lstm", (dim, cfg.seq_layer_num, cfg.res_seq))]
    if cfg.seq_model == "transformer":
        return [("tfm", (dim, cfg.seq_layer_num, cfg.causal, cfg.res_seq))]
    return []


def build_encoder2d_layers(cfg: SEANetConfig2d) -> List[Layer]:
    """SEANetEncoder2d's flat layer list (reference seanet_encoder.py:293-350)."""
    nf = cfg.n_filters
    layers: List[Layer] = [_conv2d(cfg, cfg.input_size, nf, (cfg.kernel_size, cfg.kernel_size),
                                   pad_mode=cfg.pad_mode)]
    mult = 1
    for freq_ratio, time_ratio in reversed(cfg.ratios):
        for j in range(cfg.n_residual_layers):
            layers.append(_resblock2d(cfg, mult * nf, cfg.dilation_base**j))
        layers.append(_act2d(cfg, mult * nf))
        layers.append(_conv2d(cfg, mult * nf, mult * nf * 2, (freq_ratio * 2, time_ratio * 2),
                              stride=(freq_ratio, time_ratio), groups=_groups(mult * nf, cfg.conv_group_ratio),
                              pad_mode=cfg.pad_mode))
        mult *= 2
    layers.append(("squeeze", None))
    layers += _seq_layer(cfg, mult * nf)
    layers.append(_act2d(cfg, mult * nf))
    layers.append(_conv2d(cfg, mult * nf, cfg.dimension, cfg.last_kernel_size, pad_mode=cfg.pad_mode))
    return layers


def build_decoder2d_layers(cfg: SEANetConfig2d) -> List[Layer]:
    """SEANetDecoder2d's flat layer list (reference seanet_decoder.py:290-352);
    the last transposed conv keeps ``last_out_padding``."""
    nf = cfg.n_filters
    mult = int(2 ** len(cfg.ratios))
    layers: List[Layer] = [_conv2d(cfg, cfg.dimension, mult * nf, cfg.kernel_size, pad_mode=cfg.pad_mode)]
    layers += _seq_layer(cfg, mult * nf)
    layers.append(("unsqueeze", None))
    for i, (freq_ratio, time_ratio) in enumerate(cfg.ratios):
        layers.append(_act2d(cfg, mult * nf))
        last = i == len(cfg.ratios) - 1
        layers.append(_conv2d(cfg, mult * nf, mult * nf // 2, (freq_ratio * 2, time_ratio * 2),
                              stride=(freq_ratio, time_ratio), groups=_groups(mult * nf, cfg.tr_conv_group_ratio),
                              transposed=True, trim_right_ratio=cfg.trim_right_ratio,
                              out_padding=cfg.last_out_padding if last else ((0, 0), (0, 0))))
        for j in range(cfg.n_residual_layers):
            layers.append(_resblock2d(cfg, mult * nf // 2, cfg.dilation_base**j))
        mult //= 2
    layers.append(_act2d(cfg, nf))
    layers.append(_conv2d(cfg, nf, cfg.input_size, (cfg.last_kernel_size, cfg.last_kernel_size),
                          pad_mode=cfg.pad_mode))
    return layers


class SEANetEncoder2d(nn.Module):
    """Spectrogram features (B, C_in, F, T) -> latents (B, T', dimension)."""

    def __init__(self, cfg: SEANetConfig2d, *, device=None, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.layers = build_encoder2d_layers(cfg)
        self.model = _build_stack(self.layers, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x).transpose(1, 2)


class SEANetDecoder2d(nn.Module):
    """Latents (B, T', dimension) -> spectrogram features (B, C_out, F, T)."""

    def __init__(self, cfg: SEANetConfig2d, *, device=None, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.layers = build_decoder2d_layers(cfg)
        self.model = _build_stack(self.layers, device, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.model(z.transpose(1, 2))
