"""Streamable 1D and 2D convolutions for SEANet stacks (port of funcodec_tpu/ops/conv.py).

Plain functions on tensors (``apply_sconv1d``, ``apply_sconv_transpose1d``,
``apply_sconv2d``, ``apply_sconv_transpose2d``) plus the ``nn.Module``s
that own the weights under the reference FunCodec state_dict names:
``SConv1d.conv.conv.weight``, ``SConv1d.conv.norm.weight``,
``SConvTranspose1d.convtr.convtr.weight``, and the same under ``SConv2d``
and ``SConvTranspose2d``.

Layout is torch's (B, C, T) for 1D and (B, C, F, T) for 2D (freq, time).
Weights are torch's own: (Cout, Cin/g, K...) for a forward conv,
(Cin, Cout/g, K...) for a transposed one, so a released checkpoint loads
with plain ``load_state_dict``.

Norms: ``none``, ``weight_norm``, ``time_group_norm`` (GroupNorm(1, C) over
C and every spatial axis) and ``layer_norm`` (a LayerNorm over the channels
at each position). A weight-normed layer holds the reference
``weight_g``/``weight_v`` and computes its weight with ``weight_norm_fuse``,
the one fusion the discriminator's 2D convs share. The 2D convs run on
cuDNN (``F.conv2d`` / ``F.conv_transpose2d``; the grouped transposed ones
on a card as below): their JAX counterparts are XLA convs, outside any
Pallas kernel.

``FUSED_STRIDE1`` routes each stride-1 conv with K > 1 (and, through
``apply_sconv1d_act``, an ELU right before it) to the fused pad + conv
kernel of ops/conv_kernel.py; ``FUSED_RESBLOCK`` routes each qualifying
SEANet residual block to ops/resblock_kernel.py (models/seanet.py). Both are
off by default, as their JAX counterparts ``PALLAS_STRIDE1`` and
``PALLAS_RESBLOCK`` are. On a card, a call that no kernel takes (fp32, or
widths the kernels are not built for) is declined and runs the plain path.

A ``time_group_norm`` takes the hand-written kernels of ops/tgn_kernel.py
by what its input shows, with no flag (the JAX norm has no Pallas kernel to
mirror): a CUDA tensor whose result autograd does not need (serving,
inference, validation; grad mode off, or neither y nor the norm's affine
requires grad). A transposed 1D conv's trim is then written by the kernel,
which returns the kept window contiguous. Where grad is needed (training),
and for every CPU tensor, the norm stays ATen's fp32 ``F.group_norm`` chain.

A grouped transposed 2D conv takes the hand-written kernel of
ops/convtr2d_kernel.py the same way, with no flag: a bf16 x on a card,
groups > 1, and a result that autograd does not need; the kernel writes the
untrimmed output, and the norm and the trim after it are unchanged.
Training, the CPU, fp32 and groups = 1 keep ``F.conv_transpose2d``.

Two counters say what a run's path took, as the kernels' ``LAUNCHES`` do
(a run sets the values to 0 and reads them back): ``CONV2D_CALLS``, the 2D
convs by kind (the transposed ones on either route), and ``TGN_CALLS``, the
time_group_norms by route (``kernel``: ops/tgn_kernel.py; ``aten``:
``F.group_norm``) and rank (1D or 2D); the norms inside the fused resblock
kernel are not among them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from funcodec_tpu_torch.ops.conv_kernel import fused_conv1d_s1
from funcodec_tpu_torch.ops.convtr2d_kernel import convtr2d
from funcodec_tpu_torch.ops.pad import (
    conv_padding_total,
    extra_padding_for_conv1d,
    pad1d_time,
    pad2d_freq_time,
    split_padding,
    unpad1d_time,
    unpad2d_freq_time,
)
from funcodec_tpu_torch.ops.tgn_kernel import time_group_norm

CONV_NORMS = ("none", "weight_norm", "time_group_norm", "layer_norm")

# The fused stride-1 conv kernel (csrc/conv1d_s1.cu): one read of x and one
# write of y per layer, the pad and a preceding ELU done on load.
FUSED_STRIDE1 = False

# The whole-resblock kernel (csrc/resblock_tgn.cu): three streaming passes
# over x replace the unfused ELU / conv / time_group_norm chain.
FUSED_RESBLOCK = False

# Calls since the last reset: 2D convs by kind, time_group_norms by route and rank.
CONV2D_CALLS = {"grouped": 0, "ungrouped": 0, "transposed": 0}
TGN_CALLS = {"kernel_1d": 0, "kernel_2d": 0, "aten_1d": 0, "aten_2d": 0}


def as_pair(x) -> Tuple[int, int]:
    """A (freq, time) pair from a pair or one int for both."""
    if isinstance(x, (tuple, list)):
        return (int(x[0]), int(x[1]))
    return (int(x), int(x))


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Static configuration of one streamable conv layer: 1D with int
    kernel_size / stride / dilation, 2D with (freq, time) pairs."""

    in_channels: int
    out_channels: int
    kernel_size: Union[int, Tuple[int, int]]
    stride: Union[int, Tuple[int, int]] = 1
    dilation: Union[int, Tuple[int, int]] = 1
    groups: int = 1
    bias: bool = True
    causal: bool = False
    norm: str = "none"
    pad_mode: str = "reflect"
    # transposed-conv only:
    transposed: bool = False
    trim_right_ratio: float = 1.0
    # SConvTranspose2d only: ((freq_l, freq_r), (time_l, time_r)) output padding kept
    out_padding: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0))

    def __post_init__(self):
        assert self.norm in CONV_NORMS, self.norm

    @property
    def ndim(self) -> int:
        return 2 if isinstance(self.kernel_size, (tuple, list)) else 1


def weight_norm_fuse(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight of a weight-normed conv: g * v / ||v||, the norm over every
    axis but the first (torch weight_norm dim=0: per output channel of a
    forward conv, per input channel of a transposed one) in fp32 and kept
    from 0 by 1e-12, the result in v's type (funcodec_tpu ops/conv.fused_kernel)."""
    dims = tuple(range(1, v.dim()))
    norm = v.float().square().sum(dim=dims, keepdim=True).sqrt()
    return (v.float() * (g.float().reshape(norm.shape) / norm.clamp_min(1e-12))).to(v.dtype)


def _no_grad_needed(*tensors: Optional[torch.Tensor]) -> bool:
    """Autograd does not need a result computed from these: grad mode is
    off, or none of them (None skipped) requires grad."""
    return not (torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors))


def _tgn_on_card(spec: ConvSpec, y: torch.Tensor, norm_scale, norm_bias) -> bool:
    """A time_group_norm that the kernels of ops/tgn_kernel.py compute: y on
    a card and a result that autograd does not need."""
    if spec.norm != "time_group_norm" or y.device.type != "cuda":
        return False
    return _no_grad_needed(y, norm_scale, norm_bias)


def _convtr2d_on_card(spec: ConvSpec, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> bool:
    """A grouped transposed 2D conv that the kernel of ops/convtr2d_kernel.py
    computes: a bf16 x on a card, groups > 1 and a result that autograd does
    not need. The kernel raises on a geometry it does not take."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or spec.groups == 1:
        return False
    return _no_grad_needed(x, weight, bias)


def _count_norm(route: str, y: torch.Tensor) -> None:
    TGN_CALLS[f"{route}_{y.dim() - 2}d"] += 1


def apply_post_norm(
    spec: ConvSpec,
    y: torch.Tensor,
    norm_scale: Optional[torch.Tensor],
    norm_bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """time_group_norm is GroupNorm(1, C) over the channels and every
    spatial axis per sample; layer_norm a LayerNorm over the channels (dim 1)
    at each position. The result is in y's dtype. On a card, where autograd
    does not need the result, time_group_norm runs the kernels of
    ops/tgn_kernel.py (fp64 statistics, one fp32 fma an element); otherwise,
    and for layer_norm, the statistics are ATen's in fp32 on an fp32 copy."""
    if _tgn_on_card(spec, y, norm_scale, norm_bias):
        _count_norm("kernel", y)
        return time_group_norm(y, norm_scale, norm_bias)
    if spec.norm == "time_group_norm":
        _count_norm("aten", y)
        yn = F.group_norm(
            y.float(), 1, norm_scale.float(), norm_bias.float(), eps=1e-5
        )
        return yn.to(y.dtype)
    if spec.norm == "layer_norm":
        yn = F.layer_norm(y.float().movedim(1, -1), (y.shape[1],), norm_scale.float(), norm_bias.float(), eps=1e-5)
        return yn.movedim(-1, 1).to(y.dtype)
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
    """SConvTranspose1d on (B, C, T): output length (T-1)*s + K, normed,
    then the fixed padding K - s is trimmed per causal / trim_right_ratio
    (by the norm kernel where ops/tgn_kernel.py takes it; a view otherwise)."""
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
    if spec.causal:
        padding_right = math.ceil(padding_total * spec.trim_right_ratio)
        padding_left = padding_total - padding_right
    else:
        padding_right = padding_total // 2
        padding_left = padding_total - padding_right
    if _tgn_on_card(spec, y, norm_scale, norm_bias):
        # statistics over the whole output, only the kept window written (contiguous)
        _count_norm("kernel", y)
        return time_group_norm(y, norm_scale, norm_bias, (padding_left, padding_right))
    y = apply_post_norm(spec, y, norm_scale, norm_bias)
    return unpad1d_time(y, (padding_left, padding_right))


def apply_sconv2d(
    spec: ConvSpec,
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    norm_scale: Optional[torch.Tensor] = None,
    norm_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SConv2d on (B, C, F, T). The freq axis is always padded non-causally
    (the odd sample on the left). The time axis takes the extra padding
    that fills the last window on the right when causal, but on the LEFT
    when not (unlike SConv1d), as the reference does."""
    assert not spec.transposed
    (kf, kt), (sf, st), (df, dt) = as_pair(spec.kernel_size), as_pair(spec.stride), as_pair(spec.dilation)
    pt_f = conv_padding_total(kf, sf, df)
    pt_t = conv_padding_total(kt, st, dt)
    extra_t = extra_padding_for_conv1d(x.shape[-1], kt, st, pt_t)
    freq_after = pt_f // 2
    if spec.causal:
        time_before, time_after = pt_t, extra_t
    else:
        time_after = pt_t // 2
        time_before = pt_t - time_after + extra_t
    x = pad2d_freq_time(x, (time_before, time_after), (pt_f - freq_after, freq_after), mode=spec.pad_mode)
    CONV2D_CALLS["grouped" if spec.groups > 1 else "ungrouped"] += 1
    y = F.conv2d(
        x,
        weight.to(x.dtype),
        None if bias is None else bias.to(x.dtype),
        stride=(sf, st),
        dilation=(df, dt),
        groups=spec.groups,
    )
    return apply_post_norm(spec, y, norm_scale, norm_bias)


def apply_sconv_transpose2d(
    spec: ConvSpec,
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    norm_scale: Optional[torch.Tensor] = None,
    norm_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SConvTranspose2d on (B, C, F, T): output (F-1)*sf + kf by (T-1)*st + kt,
    then the fixed paddings kf - sf and kt - st are trimmed (freq
    non-causally, time per causal / trim_right_ratio), less the
    ``out_padding`` kept on each side."""
    assert spec.transposed
    (kf, kt), (sf, st) = as_pair(spec.kernel_size), as_pair(spec.stride)
    pt_f, pt_t = kf - sf, kt - st
    CONV2D_CALLS["transposed"] += 1
    if _convtr2d_on_card(spec, x, weight, bias):
        y = convtr2d(x, weight, bias, (sf, st), spec.groups)
    else:
        y = F.conv_transpose2d(
            x,
            weight.to(x.dtype),
            None if bias is None else bias.to(x.dtype),
            stride=(sf, st),
            groups=spec.groups,
        )
    y = apply_post_norm(spec, y, norm_scale, norm_bias)
    (f_out_l, f_out_r), (t_out_l, t_out_r) = spec.out_padding
    pad_f_right = pt_f // 2
    pad_f_left = pt_f - pad_f_right
    if spec.causal:
        pad_t_right = math.ceil(pt_t * spec.trim_right_ratio)
    else:
        pad_t_right = pt_t // 2
    pad_t_left = pt_t - pad_t_right
    return unpad2d_freq_time(
        y,
        (max(pad_t_left - t_out_l, 0), max(pad_t_right - t_out_r, 0)),
        (max(pad_f_left - f_out_l, 0), max(pad_f_right - f_out_r, 0)),
    )


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


_CONV_CLASSES = {(1, False): nn.Conv1d, (1, True): nn.ConvTranspose1d,
                 (2, False): nn.Conv2d, (2, True): nn.ConvTranspose2d}


class _NormConv(nn.Module):
    """A conv and its post-norm, named like the reference NormConv1d/2d
    (``.conv``, ``.norm``) or NormConvTranspose1d/2d (``.convtr``, ``.norm``).

    Init is torch's Conv default (kaiming_uniform(a=sqrt(5)): U(+-1/sqrt(fan_in))
    for weight and bias), drawn from the explicit `generator`. With
    ``weight_norm`` the inner layer holds ``weight_v`` (that draw) and
    ``weight_g`` (its norm, shaped (dim 0, 1, ...)) in place of ``weight``.
    time_group_norm keeps an ``nn.GroupNorm(1, C)``, layer_norm an
    ``nn.LayerNorm(C)``, each at ``.norm``.
    """

    def __init__(self, spec: ConvSpec, *, device, generator: torch.Generator):
        super().__init__()
        self.transposed = spec.transposed
        cls = _CONV_CLASSES[(spec.ndim, spec.transposed)]
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
        # torch's fan_in: weight.size(1) * prod(K) for both conv kinds
        bound = 1.0 / math.sqrt(layer.weight[0].numel())
        _uniform_(layer.weight, bound, generator)
        if layer.bias is not None:
            _uniform_(layer.bias, bound, generator)
        if spec.norm == "weight_norm":
            add_weight_norm(layer)
        setattr(self, "convtr" if spec.transposed else "conv", layer)
        if spec.norm == "time_group_norm":
            self.norm = nn.GroupNorm(1, spec.out_channels, eps=1e-5, device=device)
        elif spec.norm == "layer_norm":
            self.norm = nn.LayerNorm(spec.out_channels, eps=1e-5, device=device)
        else:
            self.norm = nn.Identity()

    @property
    def layer(self) -> nn.Module:
        return self.convtr if self.transposed else self.conv

    def weight(self) -> torch.Tensor:
        return layer_weight(self.layer)

    def norm_params(self) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        if isinstance(self.norm, (nn.GroupNorm, nn.LayerNorm)):
            return self.norm.weight, self.norm.bias
        return None, None


class SConv1d(nn.Module):
    """Streamable conv1d; weights at ``.conv.conv`` / ``.conv.norm``."""

    def __init__(self, spec: ConvSpec, *, device, generator: torch.Generator):
        super().__init__()
        assert not spec.transposed and spec.ndim == 1
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


class SConv2d(nn.Module):
    """Streamable conv2d on (B, C, F, T); weights at ``.conv.conv`` / ``.conv.norm``.
    Not an SConv1d: the fused 1D kernels never take it."""

    def __init__(self, spec: ConvSpec, *, device, generator: torch.Generator):
        super().__init__()
        assert not spec.transposed and spec.ndim == 2
        self.spec = spec
        self.conv = _NormConv(spec, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        return apply_sconv2d(self.spec, x, c.weight(), c.layer.bias, *c.norm_params())


class SConvTranspose2d(nn.Module):
    """Streamable transposed conv2d; weights at ``.convtr.convtr`` / ``.convtr.norm``."""

    def __init__(self, spec: ConvSpec, *, device, generator: torch.Generator):
        super().__init__()
        assert spec.transposed and spec.ndim == 2
        self.spec = spec
        self.convtr = _NormConv(spec, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.convtr
        return apply_sconv_transpose2d(self.spec, x, c.weight(), c.layer.bias, *c.norm_params())


_SCONV_CLASSES = {(1, False): SConv1d, (1, True): SConvTranspose1d,
                  (2, False): SConv2d, (2, True): SConvTranspose2d}


def make_conv(spec: ConvSpec, *, device, generator: torch.Generator) -> nn.Module:
    return _SCONV_CLASSES[(spec.ndim, spec.transposed)](spec, device=device, generator=generator)
