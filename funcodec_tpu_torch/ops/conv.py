"""Streamable 1D convolutions for SEANet stacks (port of funcodec_tpu/ops/conv.py).

Plain functions on tensors (``apply_sconv1d``, ``apply_sconv_transpose1d``)
plus the ``nn.Module``s that own the weights under the reference FunCodec
state_dict names: ``SConv1d.conv.conv.weight``, ``SConv1d.conv.norm.weight``,
``SConvTranspose1d.convtr.convtr.weight``, ...

Layout is torch's (B, C, T). Weights are torch's own: (Cout, Cin/g, K) for
a forward conv, (Cin, Cout/g, K) for a transposed one, so a released
checkpoint loads with plain ``load_state_dict``.

Only the 1D subset with norms ``none``, ``weight_norm`` and
``time_group_norm`` is ported; ``layer_norm`` and the 2D streamable convs
come with slice C of ROADMAP.md. A weight-normed layer holds the reference
``weight_g``/``weight_v`` and computes its weight with ``weight_norm_fuse``,
the one fusion the discriminator's 2D convs share.

``FUSED_STRIDE1`` routes each stride-1 conv with K > 1 (and, through
``apply_sconv1d_act``, an ELU right before it) to the fused pad + conv
kernel of ops/conv_kernel.py; ``FUSED_RESBLOCK`` routes each qualifying
SEANet residual block to ops/resblock_kernel.py (models/seanet.py). Both are
off by default, as their JAX counterparts ``PALLAS_STRIDE1`` and
``PALLAS_RESBLOCK`` are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from funcodec_tpu_torch.ops.conv_kernel import fused_conv1d_s1
from funcodec_tpu_torch.ops.pad import (
    conv_padding_total,
    extra_padding_for_conv1d,
    pad1d_time,
    split_padding,
    unpad1d_time,
)

CONV_NORMS = ("none", "weight_norm", "time_group_norm", "layer_norm")
PORTED_NORMS = ("none", "weight_norm", "time_group_norm")

# The fused stride-1 conv kernel (csrc/conv1d_s1.cu): one read of x and one
# write of y per layer, the pad and a preceding ELU done on load.
FUSED_STRIDE1 = False

# The whole-resblock kernel (csrc/resblock_tgn.cu): three streaming passes
# over x replace the unfused ELU / conv / time_group_norm chain.
FUSED_RESBLOCK = False


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Static configuration of one streamable 1D conv layer."""

    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    dilation: int = 1
    groups: int = 1
    bias: bool = True
    causal: bool = False
    norm: str = "none"
    pad_mode: str = "reflect"
    # transposed-conv only:
    transposed: bool = False
    trim_right_ratio: float = 1.0

    def __post_init__(self):
        assert self.norm in CONV_NORMS, self.norm


def check_norm_ported(norm: str) -> None:
    if norm not in PORTED_NORMS:
        raise NotImplementedError(
            f"conv norm {norm!r} is not ported yet (ROADMAP.md slice C, item 16)"
        )


def weight_norm_fuse(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight of a weight-normed conv: g * v / ||v||, the norm over every
    axis but the first (torch weight_norm dim=0: per output channel of a
    forward conv, per input channel of a transposed one) in fp32 and kept
    from 0 by 1e-12, the result in v's type (funcodec_tpu ops/conv.fused_kernel)."""
    dims = tuple(range(1, v.dim()))
    norm = v.float().square().sum(dim=dims, keepdim=True).sqrt()
    return (v.float() * (g.float().reshape(norm.shape) / norm.clamp_min(1e-12))).to(v.dtype)


def apply_post_norm(
    spec: ConvSpec,
    y: torch.Tensor,
    norm_scale: Optional[torch.Tensor],
    norm_bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """time_group_norm is GroupNorm(1, C) over channels and time per sample,
    with its statistics in fp32 and the result cast back to y's dtype."""
    check_norm_ported(spec.norm)
    if spec.norm == "time_group_norm":
        yn = F.group_norm(
            y.float(), 1, norm_scale.float(), norm_bias.float(), eps=1e-5
        )
        return yn.to(y.dtype)
    return y


def apply_sconv1d(
    spec: ConvSpec,
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    norm_scale: Optional[torch.Tensor] = None,
    norm_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SConv1d on (B, C, T): streamable pad, conv, bias, post-norm."""
    assert not spec.transposed
    k, s, d = spec.kernel_size, spec.stride, spec.dilation
    padding_total = conv_padding_total(k, s, d)
    extra = extra_padding_for_conv1d(x.shape[-1], k, s, padding_total)
    left, right = split_padding(padding_total, spec.causal)
    if FUSED_STRIDE1 and s == 1 and spec.groups == 1 and k > 1:
        y = fused_conv1d_s1(x, weight, bias, left, right + extra, d, spec.pad_mode)  # extra == 0
        if y is not None:
            return apply_post_norm(spec, y, norm_scale, norm_bias)
    x = pad1d_time(x, (left, right + extra), mode=spec.pad_mode)
    y = F.conv1d(
        x,
        weight.to(x.dtype),
        None if bias is None else bias.to(x.dtype),
        stride=s,
        dilation=d,
        groups=spec.groups,
    )
    return apply_post_norm(spec, y, norm_scale, norm_bias)


def apply_sconv1d_act(
    spec: ConvSpec,
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    norm_scale: Optional[torch.Tensor] = None,
    norm_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """ELU(alpha=1) -> SConv1d, in one fused kernel when the layer qualifies
    (the SEANet act + conv peephole); otherwise the ELU, then apply_sconv1d."""
    k, s, d = spec.kernel_size, spec.stride, spec.dilation
    if FUSED_STRIDE1 and not spec.transposed and s == 1 and spec.groups == 1 and k > 1:
        left, right = split_padding(conv_padding_total(k, s, d), spec.causal)
        y = fused_conv1d_s1(x, weight, bias, left, right, d, spec.pad_mode, act="elu")
        if y is not None:
            return apply_post_norm(spec, y, norm_scale, norm_bias)
    return apply_sconv1d(spec, F.elu(x), weight, bias, norm_scale, norm_bias)


def apply_sconv_transpose1d(
    spec: ConvSpec,
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    norm_scale: Optional[torch.Tensor] = None,
    norm_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SConvTranspose1d on (B, C, T): output length (T-1)*s + K, then the
    fixed padding K - s is trimmed per causal / trim_right_ratio."""
    assert spec.transposed
    k, s = spec.kernel_size, spec.stride
    padding_total = k - s
    y = F.conv_transpose1d(
        x,
        weight.to(x.dtype),
        None if bias is None else bias.to(x.dtype),
        stride=s,
        groups=spec.groups,
    )
    y = apply_post_norm(spec, y, norm_scale, norm_bias)
    if spec.causal:
        padding_right = math.ceil(padding_total * spec.trim_right_ratio)
        padding_left = padding_total - padding_right
    else:
        padding_right = padding_total // 2
        padding_left = padding_total - padding_right
    return unpad1d_time(y, (padding_left, padding_right))


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def add_weight_norm(layer: nn.Module) -> None:
    """Replace a conv layer's ``weight`` by ``weight_v`` (the same values)
    and ``weight_g`` (their norm per dim-0 slice), as torch weight_norm does."""
    w = layer.weight.detach()
    del layer.weight
    layer.weight_v = nn.Parameter(w.clone())
    layer.weight_g = nn.Parameter(w.square().sum(dim=tuple(range(1, w.dim())), keepdim=True).sqrt())


def layer_weight(layer: nn.Module) -> torch.Tensor:
    """A conv layer's weight: its ``weight``, or the weight-norm fusion."""
    if hasattr(layer, "weight_v"):
        return weight_norm_fuse(layer.weight_v, layer.weight_g)
    return layer.weight


class _NormConv(nn.Module):
    """A conv and its post-norm, named like the reference NormConv1d
    (``.conv``, ``.norm``) or NormConvTranspose1d (``.convtr``, ``.norm``).

    Init is torch's Conv default (kaiming_uniform(a=sqrt(5)): U(+-1/sqrt(fan_in))
    for weight and bias), drawn from the explicit `generator`. With
    ``weight_norm`` the inner layer holds ``weight_v`` (that draw) and
    ``weight_g`` (its norm, shaped (dim 0, 1, 1)) in place of ``weight``.
    """

    def __init__(self, spec: ConvSpec, *, device, generator: torch.Generator):
        super().__init__()
        check_norm_ported(spec.norm)
        self.transposed = spec.transposed
        cls = nn.ConvTranspose1d if spec.transposed else nn.Conv1d
        layer = cls(
            spec.in_channels,
            spec.out_channels,
            spec.kernel_size,
            stride=spec.stride,
            dilation=spec.dilation,
            groups=spec.groups,
            bias=spec.bias,
            device=device,
        )
        # torch's fan_in: weight.size(1) * K for both conv kinds
        bound = 1.0 / math.sqrt(layer.weight.shape[1] * spec.kernel_size)
        _uniform_(layer.weight, bound, generator)
        if layer.bias is not None:
            _uniform_(layer.bias, bound, generator)
        if spec.norm == "weight_norm":
            add_weight_norm(layer)
        setattr(self, "convtr" if spec.transposed else "conv", layer)
        if spec.norm == "time_group_norm":
            self.norm = nn.GroupNorm(1, spec.out_channels, eps=1e-5, device=device)
        else:
            self.norm = nn.Identity()

    @property
    def layer(self) -> nn.Module:
        return self.convtr if self.transposed else self.conv

    def weight(self) -> torch.Tensor:
        return layer_weight(self.layer)

    def norm_params(self) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        if isinstance(self.norm, nn.GroupNorm):
            return self.norm.weight, self.norm.bias
        return None, None


class SConv1d(nn.Module):
    """Streamable conv1d; weights at ``.conv.conv`` / ``.conv.norm``."""

    def __init__(self, spec: ConvSpec, *, device, generator: torch.Generator):
        super().__init__()
        assert not spec.transposed
        self.spec = spec
        self.conv = _NormConv(spec, device=device, generator=generator)

    def params(self) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(weight, bias, norm_scale, norm_bias); the last three may be None."""
        c = self.conv
        return (c.weight(), c.layer.bias, *c.norm_params())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_sconv1d(self.spec, x, *self.params())

    def forward_elu(self, x: torch.Tensor) -> torch.Tensor:
        """self(ELU(x)), through the fused kernel where it qualifies."""
        return apply_sconv1d_act(self.spec, x, *self.params())


class SConvTranspose1d(nn.Module):
    """Streamable transposed conv1d; weights at ``.convtr.convtr`` / ``.convtr.norm``."""

    def __init__(self, spec: ConvSpec, *, device, generator: torch.Generator):
        super().__init__()
        assert spec.transposed
        self.spec = spec
        self.convtr = _NormConv(spec, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.convtr
        return apply_sconv_transpose1d(
            self.spec, x, c.weight(), c.layer.bias, *c.norm_params()
        )


def make_conv(spec: ConvSpec, *, device, generator: torch.Generator) -> nn.Module:
    cls = SConvTranspose1d if spec.transposed else SConv1d
    return cls(spec, device=device, generator=generator)
