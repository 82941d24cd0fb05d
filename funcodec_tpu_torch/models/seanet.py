"""SEANet encoder/decoder stacks, 1D (port of funcodec_tpu/models/seanet.py).

The layer stack is the same flat list of (kind, spec) descriptors as in the
JAX package, in the order of the reference's ``nn.Sequential``; each
descriptor becomes one module of ``self.model``, so parameters carry the
reference names (``encoder.model.{i}.conv.conv.weight``,
``encoder.model.{i}.block.{j}...``, ``encoder.model.{i}.lstm.weight_ih_l0``).

Inside the stack the layout is torch's (B, C, T). The public contract is the
JAX one: the encoder maps a waveform (B, T) to latents (B, T', D) and the
decoder maps (B, T', D) to (B, T, channels).

Fused kernels (ops/conv.py flags): with ``FUSED_RESBLOCK`` each residual
block first tries ops/resblock_kernel.fused_resblock_tgn; with
``FUSED_STRIDE1`` a ``LayerStack`` runs an ELU(alpha=1) right before a
stride-1 conv with K > 1 as one fused kernel (the JAX package's
``_elu_conv_fusible`` peephole). The JAX peephole's ``C >= 128``, no-packing
gate on the resblock was a TPU (v5e) lane-width tuning and is not carried
over: every qualifying block fuses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from funcodec_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerEncoder,
    causal_mask,
    make_pad_mask_bool,
)
from funcodec_tpu_torch.ops import activations as act_ops
from funcodec_tpu_torch.ops import conv as conv_ops
from funcodec_tpu_torch.ops.conv import ConvSpec, SConv1d, make_conv
from funcodec_tpu_torch.ops.resblock_kernel import fused_resblock_tgn
from funcodec_tpu_torch.ops.rnn import SLSTM

Layer = Tuple[str, Any]  # kind in {conv, act, snake, lstm, tfm, resblock}


@dataclasses.dataclass(frozen=True)
class SEANetConfig:
    """Shared config for the SEANet encoder/decoder (1D).

    `ratios` are given decoder-order (coarse->fine), e.g. (8, 5, 4, 2); the
    encoder applies them reversed.
    """

    input_size: int = 1  # audio channels (encoder in / decoder out)
    dimension: int = 128  # latent dim
    n_filters: int = 32
    n_residual_layers: int = 1
    ratios: Tuple[int, ...] = (8, 5, 4, 2)
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
    seq_model: str = "lstm"  # lstm | transformer | none
    seq_layer_num: int = 2
    res_seq: bool = True
    double_filters: bool = True  # encoder: double channels per stage
    half_filters: bool = True  # decoder: halve channels per stage
    add_snake_activation: bool = False
    trim_right_ratio: float = 1.0  # decoder transposed convs
    final_activation: Optional[str] = None

    @property
    def act_kwargs(self) -> Dict[str, Any]:
        return dict(self.activation_params)


def _act_layer(cfg: SEANetConfig, channels: int, name: Optional[str] = None) -> Layer:
    name = name or cfg.activation
    if name.lower() == "snake":
        return ("snake", channels)
    return ("act", (name, cfg.act_kwargs))


def _conv(cfg: SEANetConfig, cin: int, cout: int, k: int, **kw) -> Layer:
    return (
        "conv",
        ConvSpec(cin, cout, k, causal=cfg.causal, norm=cfg.norm, pad_mode=cfg.pad_mode, **kw),
    )


def _resblock_layers(cfg: SEANetConfig, dim: int, dilation: int) -> Layer:
    """SEANetResnetBlock: [act, conv(k, dil), act, conv(1)] + shortcut
    (1x1 conv unless true_skip); hidden = dim // compress."""
    hidden = dim // cfg.compress
    block: List[Layer] = []
    io = [(dim, hidden, cfg.residual_kernel_size, dilation), (hidden, dim, 1, 1)]
    for in_chs, out_chs, k, d in io:
        block.append(_act_layer(cfg, in_chs))
        block.append(_conv(cfg, in_chs, out_chs, k, dilation=d))
    shortcut = None if cfg.true_skip else _conv(cfg, dim, dim, 1)[1]
    return ("resblock", (tuple(block), shortcut))


def seq_tfm_cfg(spec) -> TransformerConfig:
    """The SEANet bottleneck transformer (the reference's normed_modules
    TransformerEncoder: 4 heads, FFN 2048, no input layer, no positional
    encoding; transformer norm names)."""
    dim, num_blocks = spec[0], spec[1]
    return TransformerConfig(input_size=dim, attention_dim=dim, attention_heads=4, linear_units=2048,
                             num_blocks=num_blocks, input_layer="none", pos_enc_type="none",
                             block_names="transformer")


class SeqTransformer(TransformerEncoder):
    """The "tfm" layer: (B, C, T) -> (B, C, T), optionally causal, with an
    optional residual skip."""

    def __init__(self, spec, *, device, generator: torch.Generator):
        super().__init__(seq_tfm_cfg(spec), device=device, generator=generator)
        self.causal, self.skip = spec[2], spec[3]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)
        B, T = h.shape[0], h.shape[1]
        lengths = torch.full((B,), T, device=h.device)
        mask = causal_mask(lengths, T) if self.causal else make_pad_mask_bool(lengths, T)[:, None, :]
        y = super().forward(h, mask)
        return (h + y if self.skip else y).transpose(1, 2)


def _seq_layer(cfg: SEANetConfig, dim: int) -> List[Layer]:
    if cfg.seq_model == "lstm":
        return [("lstm", (dim, cfg.seq_layer_num, cfg.res_seq))]
    if cfg.seq_model == "transformer":
        return [("tfm", (dim, cfg.seq_layer_num, cfg.causal, cfg.res_seq))]
    return []


def build_encoder_layers(cfg: SEANetConfig) -> List[Layer]:
    """Flat layer list for SEANetEncoder."""
    layers: List[Layer] = []
    mult = 1
    layers.append(_conv(cfg, cfg.input_size, mult * cfg.n_filters, cfg.kernel_size))
    if cfg.add_snake_activation:
        layers.append(_act_layer(cfg, mult * cfg.n_filters, "snake"))
        layers.append(
            _conv(cfg, mult * cfg.n_filters, mult * cfg.n_filters, cfg.kernel_size)
        )
    for ratio in reversed(cfg.ratios):
        for j in range(cfg.n_residual_layers):
            layers.append(
                _resblock_layers(cfg, mult * cfg.n_filters, cfg.dilation_base**j)
            )
        layers.append(_act_layer(cfg, mult * cfg.n_filters))
        out_ch = mult * cfg.n_filters * (2 if cfg.double_filters else 1)
        layers.append(
            _conv(cfg, mult * cfg.n_filters, out_ch, ratio * 2, stride=ratio)
        )
        if cfg.double_filters:
            mult *= 2
    layers += _seq_layer(cfg, mult * cfg.n_filters)
    layers.append(_act_layer(cfg, mult * cfg.n_filters))
    layers.append(_conv(cfg, mult * cfg.n_filters, cfg.dimension, cfg.last_kernel_size))
    return layers


def build_decoder_layers(cfg: SEANetConfig) -> List[Layer]:
    """Flat layer list for SEANetDecoder."""
    layers: List[Layer] = []
    mult = int(2 ** len(cfg.ratios)) if cfg.half_filters else 1
    layers.append(_conv(cfg, cfg.dimension, mult * cfg.n_filters, cfg.kernel_size))
    layers += _seq_layer(cfg, mult * cfg.n_filters)
    for ratio in cfg.ratios:
        out_ch = mult * cfg.n_filters // 2 if cfg.half_filters else mult * cfg.n_filters
        layers.append(_act_layer(cfg, mult * cfg.n_filters))
        layers.append(
            (
                "conv",
                ConvSpec(
                    mult * cfg.n_filters,
                    out_ch,
                    kernel_size=ratio * 2,
                    stride=ratio,
                    causal=cfg.causal,
                    norm=cfg.norm,
                    transposed=True,
                    trim_right_ratio=cfg.trim_right_ratio,
                ),
            )
        )
        for j in range(cfg.n_residual_layers):
            layers.append(_resblock_layers(cfg, out_ch, cfg.dilation_base**j))
        if cfg.half_filters:
            mult //= 2
    layers.append(
        _act_layer(cfg, cfg.n_filters, "snake" if cfg.add_snake_activation else None)
    )
    layers.append(_conv(cfg, cfg.n_filters, cfg.input_size, cfg.last_kernel_size))
    if cfg.final_activation is not None:
        layers.append(("act", (cfg.final_activation, {})))
    return layers


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class Activation(nn.Module):
    """A parameter-free activation resolved by its torch name."""

    def __init__(self, name: str, kwargs: Dict[str, Any]):
        super().__init__()
        self.name, self.kwargs = name, dict(kwargs)
        self.fn = act_ops.get_activation_fn(name, **self.kwargs)

    @property
    def is_elu1(self) -> bool:
        """ELU with alpha 1, the activation the fused kernels apply."""
        return self.name.upper() == "ELU" and self.kwargs.get("alpha", 1.0) == 1.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def _elu_conv_fusible(layer: nn.Module, nxt: Optional[nn.Module]) -> bool:
    """ELU(alpha=1) directly before a stride-1, groups-1, K > 1 conv."""
    if not conv_ops.FUSED_STRIDE1 or not isinstance(layer, Activation) or not layer.is_elu1:
        return False
    if not isinstance(nxt, SConv1d):
        return False
    spec = nxt.spec
    return spec.stride == 1 and spec.groups == 1 and spec.kernel_size > 1


class LayerStack(nn.Sequential):
    """nn.Sequential (same indices, so the same state_dict names) whose
    forward takes the ELU + conv peephole when FUSED_STRIDE1 is on."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self)
        i = 0
        while i < len(layers):
            nxt = layers[i + 1] if i + 1 < len(layers) else None
            if _elu_conv_fusible(layers[i], nxt):
                x = nxt.forward_elu(x)
                i += 2
            else:
                x = layers[i](x)
                i += 1
        return x


class Snake(nn.Module):
    def __init__(self, channels: int, *, device):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return act_ops.snake(x, self.alpha.to(x.dtype))


class SEANetResnetBlock(nn.Module):
    """``.block`` (act, conv, act, conv) plus ``.shortcut``; names as the reference."""

    def __init__(self, spec, *, device, generator: torch.Generator):
        super().__init__()
        block, shortcut = spec
        self.block = LayerStack(
            *[make_layer(k, s, device=device, generator=generator) for k, s in block]
        )
        if shortcut is None:
            self.shortcut = nn.Identity()
        else:
            self.shortcut = make_layer("conv", shortcut, device=device, generator=generator)

    def _fused(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The whole-block kernel for the canonical [ELU, conv(k, d), ELU,
        conv(1)] + 1x1-shortcut block, or None."""
        layers = list(self.block)
        if len(layers) != 4 or not isinstance(self.shortcut, SConv1d):
            return None
        act0, conv1, act1, conv2 = layers
        if not all(isinstance(a, Activation) and a.is_elu1 for a in (act0, act1)):
            return None
        if not isinstance(conv1, SConv1d) or not isinstance(conv2, SConv1d):
            return None
        return fused_resblock_tgn(x, conv1, conv2, self.shortcut)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if conv_ops.FUSED_RESBLOCK:
            y = self._fused(x)
            if y is not None:
                return y
        return self.shortcut(x) + self.block(x)


def make_layer(kind: str, spec, *, device, generator: torch.Generator) -> nn.Module:
    if kind == "conv":
        return make_conv(spec, device=device, generator=generator)
    if kind == "act":
        name, kwargs = spec
        return Activation(name, kwargs)
    if kind == "snake":
        return Snake(spec, device=device)
    if kind == "lstm":
        dim, num_layers, skip = spec
        return SLSTM(dim, num_layers, skip, device=device, generator=generator)
    if kind == "resblock":
        return SEANetResnetBlock(spec, device=device, generator=generator)
    if kind == "tfm":
        return SeqTransformer(spec, device=device, generator=generator)
    raise ValueError(kind)


def _build_stack(layers: List[Layer], device, generator) -> LayerStack:
    return LayerStack(
        *[make_layer(k, s, device=device, generator=generator) for k, s in layers]
    )


class SEANetEncoder(nn.Module):
    """Waveform (B, T) or (B, T, channels) -> latents (B, T', dimension)."""

    def __init__(self, cfg: SEANetConfig, *, device=None, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.layers = build_encoder_layers(cfg)
        self.model = _build_stack(self.layers, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None, :] if x.dim() == 2 else x.transpose(1, 2)
        return self.model(x).transpose(1, 2)


class SEANetDecoder(nn.Module):
    """Latents (B, T', dimension) -> waveform (B, T, channels)."""

    def __init__(self, cfg: SEANetConfig, *, device=None, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.layers = build_decoder_layers(cfg)
        self.model = _build_stack(self.layers, device, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.model(z.transpose(1, 2)).transpose(1, 2)
