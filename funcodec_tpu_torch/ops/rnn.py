"""Residual multi-layer LSTM for the SEANet bottleneck (port of funcodec_tpu/ops/rnn.py).

``nn.LSTM`` keeps torch's gate order [input, forget, cell, output] and its
(4H, in) weight layout; the JAX package stores the transposes (in, 4H)
(see funcodec_tpu/compat/torch_import.import_lstm). ``apply_slstm_streaming``
threads explicit (h, c) carries between chunks (models/streaming.py).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn


def _slstm(lstm: nn.LSTM, x: torch.Tensor, state, skip: bool):
    """(B, C, T) through the LSTM from `state` (None: zeros), with the
    residual skip; returns (y (B, C, T), the final (h, c))."""
    xt = x.permute(2, 0, 1)  # (T, B, C), nn.LSTM's default layout
    y, state = lstm(xt.to(lstm.weight_ih_l0.dtype), state)
    y = y.to(x.dtype)
    if skip:
        y = y + xt
    return y.permute(1, 2, 0), state


def apply_slstm(lstm: nn.LSTM, x: torch.Tensor, skip: bool = True) -> torch.Tensor:
    """Stacked LSTM with a residual skip on (B, C, T).

    nn.LSTM needs its input in the weights' dtype: an fp32 input to bf16
    weights (the decode-from-tokens path of a bf16 model) runs the LSTM in
    bf16 and returns x's dtype.
    """
    return _slstm(lstm, x, None, skip)[0]


def apply_slstm_streaming(
    lstm: nn.LSTM, x: torch.Tensor, carries: List[Tuple[torch.Tensor, torch.Tensor]], skip: bool = True
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """apply_slstm with explicit per-layer (h, c) carries, each (B, H), for
    chunked streaming: chunks fed through it with threaded carries give the
    whole-utterance apply_slstm. Returns (y (B, C, T), the new carries)."""
    dtype = lstm.weight_ih_l0.dtype
    state = tuple(torch.stack(s).to(dtype) for s in zip(*carries))
    y, (hn, cn) = _slstm(lstm, x, state, skip)
    return y, list(zip(hn.unbind(0), cn.unbind(0)))


class SLSTM(nn.Module):
    """Weights at ``.lstm.weight_ih_l{k}`` etc., as the reference SLSTM.

    Init is torch's LSTM default, U(+-1/sqrt(H)) for every tensor, drawn from
    the explicit `generator`.
    """

    def __init__(
        self, dim: int, num_layers: int, skip: bool, *, device, generator: torch.Generator
    ):
        super().__init__()
        self.skip = skip
        self.lstm = nn.LSTM(dim, dim, num_layers, device=device)
        bound = 1.0 / math.sqrt(dim)
        with torch.no_grad():
            for p in self.lstm.parameters():
                p.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_slstm(self.lstm, x, skip=self.skip)
