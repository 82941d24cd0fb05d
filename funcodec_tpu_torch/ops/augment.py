"""Feature augmentation and normalization: SpecAug masks without time warp,
MaskAlongAxisVariableMaxWidth, utterance MVN (port of
funcodec_tpu/ops/augment.py).

Behavioral reference: funcodec/models/specaug/specaug.py:13-100,
funcodec/layers/mask_along_axis.py (:206), funcodec/layers/utterance_mvn.py.

Spans are drawn from an explicit ``torch.Generator`` (on the tensor's
device), with jax.random.randint's ranges; each masking function also takes
the spans themselves (``widths``, ``starts``, each (B, num_mask)), so that a
caller can replay another package's draw.

Under data parallelism (``group``, a ``parallel.dist.DataGroup``) x is this
rank's block of the batch's rows; the spans are drawn (or given) at the
global batch's shape and each rank keeps its rows, so the ranks mask what
one process masks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from funcodec_tpu_torch.parallel.dist import DataGroup, draw_rows, local_rows

Spans = Tuple[torch.Tensor, torch.Tensor]  # (widths, starts), each (B, num_mask)


def _spans(widths, starts, B: int, num_mask: int, width_range: Tuple[int, int], L: int,
           generator: Optional[torch.Generator], device, group: Optional[DataGroup]):
    """(widths, starts) of this rank's rows: given at the global shape, or
    drawn there (widths in [lo, hi), then starts in [0, max(L - 1, 1)))."""

    def draw(low, high):
        return draw_rows(lambda n: torch.randint(low, high, (n, num_mask), generator=generator, device=device),
                         B, group)

    widths = draw(*width_range) if widths is None else local_rows(widths, group)
    starts = draw(0, max(L - 1, 1)) if starts is None else local_rows(starts, group)
    return widths, starts


def _apply_spans(x: torch.Tensor, axis: int, widths: torch.Tensor, starts: torch.Tensor):
    """x with every position of `axis` inside a span zeroed; (out, mask (B, L))."""
    B, L = x.shape[0], x.shape[axis]
    widths, starts = widths.to(x.device), starts.to(x.device)
    pos = torch.arange(L, device=x.device)[None, None, :]
    in_span = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    mask = in_span.any(dim=1)
    shape = [B, 1, 1]
    shape[axis] = L
    return torch.where(mask.reshape(shape), torch.zeros((), dtype=x.dtype, device=x.device), x), mask


def mask_along_axis(
    x: torch.Tensor,  # (B, T, D)
    generator: Optional[torch.Generator],
    axis: int,  # 1 = time, 2 = freq / feature
    width_range: Tuple[int, int],
    num_mask: int,
    widths: Optional[torch.Tensor] = None,
    starts: Optional[torch.Tensor] = None,
    group: Optional[DataGroup] = None,
) -> torch.Tensor:
    """Zero `num_mask` spans along `axis` per batch row: widths in
    [lo, max(hi, lo + 1)), starts in [0, max(L - 1, 1))."""
    B, L = x.shape[0], x.shape[axis]
    widths, starts = _spans(widths, starts, B, num_mask, (width_range[0], max(width_range[1], width_range[0] + 1)),
                            L, generator, x.device, group)
    return _apply_spans(x, axis, widths, starts)[0]


def mask_along_axis_variable_max_width(
    x: torch.Tensor,  # (B, T, D)
    generator: Optional[torch.Generator],
    mask_width_ratio_range: Tuple[float, float] = (0.0, 0.05),
    num_mask: int = 2,
    axis: int = 1,
    return_mask: bool = False,
    widths: Optional[torch.Tensor] = None,
    starts: Optional[torch.Tensor] = None,
    group: Optional[DataGroup] = None,
):
    """MaskAlongAxisVariableMaxWidth: widths drawn up to ratio * L. Returns
    (masked, mask (B, L, 1)) when return_mask."""
    B, L = x.shape[0], x.shape[axis]
    lo = int(mask_width_ratio_range[0] * L)
    hi = max(int(mask_width_ratio_range[1] * L), lo + 1)
    widths, starts = _spans(widths, starts, B, num_mask, (lo, hi), L, generator, x.device, group)
    out, mask = _apply_spans(x, axis, widths, starts)
    return (out, mask[..., None]) if return_mask else out


def spec_aug(
    x: torch.Tensor,  # (B, T, D)
    generator: Optional[torch.Generator],
    apply_freq_mask: bool = True,
    freq_mask_width_range: Tuple[int, int] = (0, 20),
    num_freq_mask: int = 2,
    apply_time_mask: bool = True,
    time_mask_width_range: Optional[Tuple[int, int]] = None,
    time_mask_width_ratio_range: Optional[Tuple[float, float]] = None,
    num_time_mask: int = 2,
    freq_spans: Optional[Spans] = None,
    time_spans: Optional[Spans] = None,
    group: Optional[DataGroup] = None,
) -> torch.Tensor:
    """SpecAug without time warp: feature masks, then time masks."""
    if apply_freq_mask:
        x = mask_along_axis(x, generator, axis=2, width_range=freq_mask_width_range, num_mask=num_freq_mask,
                            group=group, **_given(freq_spans))
    if apply_time_mask:
        if time_mask_width_ratio_range is not None:
            x = mask_along_axis_variable_max_width(x, generator, time_mask_width_ratio_range, num_time_mask, axis=1,
                                                   group=group, **_given(time_spans))
        else:
            x = mask_along_axis(x, generator, axis=1, width_range=time_mask_width_range or (0, 100),
                                num_mask=num_time_mask, group=group, **_given(time_spans))
    return x


def _given(spans: Optional[Spans]) -> dict:
    return {} if spans is None else dict(widths=spans[0], starts=spans[1])


def utterance_mvn(
    x: torch.Tensor,  # (B, T, D)
    lengths: Optional[torch.Tensor] = None,
    norm_means: bool = True,
    norm_vars: bool = False,
    eps: float = 1.0e-20,
) -> torch.Tensor:
    """Per-utterance mean (and variance) normalization over the valid frames."""
    if lengths is None:
        mean = x.mean(dim=1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
    else:
        valid = (torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None])[..., None]
        denom = valid.sum(dim=1, keepdim=True).clamp_min(1)
        mean = (x * valid).sum(dim=1, keepdim=True) / denom
        var = (((x - mean) * valid) ** 2).sum(dim=1, keepdim=True) / denom
    if norm_means:
        x = x - mean
    if norm_vars:
        x = x / torch.sqrt(var.clamp_min(eps))
    return x
