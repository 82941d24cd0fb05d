"""Residual multi-layer LSTM for the SEANet bottleneck (port of funcodec_tpu/ops/rnn.py).

``nn.LSTM`` keeps torch's gate order [input, forget, cell, output] and its
(4H, in) weight layout; the JAX package stores the transposes (in, 4H)
(see funcodec_tpu/compat/torch_import.import_lstm).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


def apply_slstm(lstm: nn.LSTM, x: torch.Tensor, skip: bool = True) -> torch.Tensor:
    """Stacked LSTM with a residual skip on (B, C, T).

    nn.LSTM needs its input in the weights' dtype: an fp32 input to bf16
    weights (the decode-from-tokens path of a bf16 model) runs the LSTM in
    bf16 and returns x's dtype.
    """
    xt = x.permute(2, 0, 1)  # (T, B, C), nn.LSTM's default layout
    y, _ = lstm(xt.to(lstm.weight_ih_l0.dtype))
    y = y.to(x.dtype)
    if skip:
        y = y + xt
    return y.permute(1, 2, 0)


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
