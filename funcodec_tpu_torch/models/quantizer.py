"""Task-facing quantizer around the RVQ core (port of funcodec_tpu/models/quantizer.py).

``Quantizer`` is the reference CostumeQuantizer: optional in/out linear
projections (``quantizer.input_proj``, ``quantizer.output_proj``), an
optional tanh range clamp, and the stacked codebooks at
``quantizer.rq.model.*``. ``train_forward`` is the EMA training forward
(quant/rvq.py rvq_train_forward); it returns the new codebook state
without writing the buffers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from funcodec_tpu_torch.parallel.dist import DataGroup
from funcodec_tpu_torch.quant.rvq import (
    RVQConfig,
    RVQState,
    RVQTensors,
    rvq_decode,
    rvq_encode,
    rvq_inference,
    rvq_train_forward,
)


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    """funcodec_tpu's QuantizerConfig (the CostumeQuantizer arguments)."""

    input_size: int = 128
    codebook_size: int = 1024
    num_quantizers: int = 32
    ema_decay: float = 0.99
    kmeans_init: bool = True
    sampling_rate: int = 16_000
    quantize_dropout: bool = False
    rand_num_quant: Optional[Tuple[int, ...]] = None
    encoder_hop_length: int = 320
    q0_ds_ratio: int = 1
    codec_dim: Optional[int] = None
    codec_range: Optional[float] = None
    expiry_mode: str = "reference"

    @property
    def effective_dim(self) -> int:
        return self.codec_dim if self.codec_dim is not None else self.input_size

    def rvq(self) -> RVQConfig:
        return RVQConfig(
            dim=self.effective_dim,
            codebook_size=self.codebook_size,
            num_quantizers=self.num_quantizers,
            decay=self.ema_decay,
            kmeans_init=self.kmeans_init,
            quantize_dropout=self.quantize_dropout,
            rand_num_quant=tuple(self.rand_num_quant) if self.rand_num_quant else None,
            q0_ds_ratio=self.q0_ds_ratio,
            sampling_rate=self.sampling_rate,
            encoder_hop_length=self.encoder_hop_length,
            expiry_mode=self.expiry_mode,
        )


class _ResidualVQ(nn.Module):
    """Holds the codebooks at ``.model``, as the reference's ``rq``."""

    def __init__(self, cfg: RVQConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.model = RVQState(cfg, device=device, generator=generator)


class Quantizer(nn.Module):
    """The quantizer; all modes take and return (B, T, C)."""

    def __init__(self, cfg: QuantizerConfig, *, device=None, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.rvq_cfg = cfg.rvq()
        if cfg.codec_dim is not None and cfg.codec_dim != cfg.input_size:
            self.input_proj = nn.Linear(cfg.input_size, cfg.codec_dim, device=device)
            self.output_proj = nn.Linear(cfg.codec_dim, cfg.input_size, device=device)
            with torch.no_grad():
                for lin, fan_in in ((self.input_proj, cfg.input_size),
                                    (self.output_proj, cfg.codec_dim)):
                    bound = 1.0 / math.sqrt(fan_in)
                    lin.weight.uniform_(-bound, bound, generator=generator)
                    lin.bias.zero_()
        else:
            self.input_proj = self.output_proj = None
        self.rq = _ResidualVQ(self.rvq_cfg, device=device, generator=generator)

    @property
    def state(self) -> RVQState:
        return self.rq.model

    def _pre(self, x: torch.Tensor) -> torch.Tensor:
        if self.input_proj is not None:
            x = self.input_proj(x)
        if self.cfg.codec_range is not None:
            x = torch.tanh(x) * self.cfg.codec_range
        return x

    def _post(self, x: torch.Tensor) -> torch.Tensor:
        if self.output_proj is not None:
            x = self.output_proj(x.to(self.output_proj.weight.dtype))
        return x

    def n_q_for_bandwidth(self, bandwidth: Optional[float]) -> int:
        return self.rvq_cfg.num_quantizers_for_bandwidth(bandwidth)

    def train_forward(self, x: torch.Tensor, generator: torch.Generator, state: Optional[RVQTensors] = None,
                      bandwidth: Optional[float] = None, group: Optional[DataGroup] = None):
        """(quantized, indices (n_q, B, T), commit loss, sub_quants, new state)
        from `state` (the buffers when None). The commit loss is the mean
        over all n_q layers, a dropped layer counting 0. With a data `group`
        the codebook statistics are the global batch's (quant/rvq.py)."""
        n_q = self.n_q_for_bandwidth(bandwidth)
        state = self.state.tensors() if state is None else state
        quantized, indices, commits, sub_quants, new_state = rvq_train_forward(
            self.rvq_cfg, state, self._pre(x), generator, n_q=n_q, group=group)
        return self._post(quantized), indices, commits.mean(), sub_quants, new_state

    def inference(self, x: torch.Tensor, bandwidth: Optional[float] = None):
        """(quantized, indices (n_q, B, T), sub_quants (n_q, B, T, C))."""
        n_q = self.n_q_for_bandwidth(bandwidth)
        x = self._pre(x)
        quantized, indices, sub_quants = rvq_inference(self.rvq_cfg, self.state, x, n_q=n_q)
        return self._post(quantized), indices, sub_quants

    def encode(self, x: torch.Tensor, bandwidth: Optional[float] = None) -> torch.Tensor:
        """(B, T, C) -> indices (n_q, B, T); always the fp32 scan, as in JAX."""
        n_q = self.n_q_for_bandwidth(bandwidth)
        return rvq_encode(self.rvq_cfg, self.state, self._pre(x), n_q=n_q)

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        """indices (n_q', B, T) -> (B, T, C)."""
        return self._post(rvq_decode(self.rvq_cfg, self.state, indices))
