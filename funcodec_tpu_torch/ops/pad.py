"""Streamable-convolution padding arithmetic (port of funcodec_tpu/ops/pad.py).

The integer helpers are identical to the JAX ones. The tensor helpers work
on torch's (B, C, T) layout: time is the LAST axis here, where the JAX
package keeps it on axis 1 of (B, T, C).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def conv_padding_total(kernel_size: int, stride: int, dilation: int = 1) -> int:
    """Total padding so an input of length T maps to ceil(T/stride) frames."""
    return (kernel_size - 1) * dilation - (stride - 1)


def extra_padding_for_conv1d(
    length: int, kernel_size: int, stride: int, padding_total: int = 0
) -> int:
    """Extra right-padding so the last conv window is full."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return ideal_length - length


def split_padding(padding_total: int, causal: bool) -> Tuple[int, int]:
    """(left, right) split of `padding_total`: causal puts it all on the left,
    non-causal puts the odd sample on the left."""
    if causal:
        return padding_total, 0
    padding_right = padding_total // 2
    return padding_total - padding_right, padding_right


def pad1d_time(
    x: torch.Tensor,
    paddings: Tuple[int, int],
    mode: str = "zero",
    value: float = 0.0,
) -> torch.Tensor:
    """Pad the last (time) axis.

    ``reflect`` reproduces the small-input fixup of the JAX version: if
    T <= max(pad), zero-extend on the right before reflecting, then drop the
    extension afterwards.
    """
    padding_left, padding_right = paddings
    assert padding_left >= 0 and padding_right >= 0, paddings
    if mode == "reflect":
        length = x.shape[-1]
        max_pad = max(padding_left, padding_right)
        extra_pad = 0
        if length <= max_pad:
            extra_pad = max_pad - length + 1
            x = F.pad(x, (0, extra_pad))
        padded = F.pad(x, (padding_left, padding_right), mode="reflect")
        return padded[..., : padded.shape[-1] - extra_pad]
    if mode == "zero":
        return F.pad(x, (padding_left, padding_right))
    if mode == "constant":
        return F.pad(x, (padding_left, padding_right), value=value)
    if mode == "replicate":
        return F.pad(x, (padding_left, padding_right), mode="replicate")
    raise ValueError(f"unknown pad mode {mode}")


def unpad1d_time(x: torch.Tensor, paddings: Tuple[int, int]) -> torch.Tensor:
    """Remove (left, right) padding from the last (time) axis."""
    padding_left, padding_right = paddings
    assert padding_left >= 0 and padding_right >= 0, paddings
    assert (padding_left + padding_right) <= x.shape[-1]
    return x[..., padding_left : x.shape[-1] - padding_right]
