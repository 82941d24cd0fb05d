"""Task-facing quantizers around the RVQ core (port of funcodec_tpu/models/quantizer.py).

``Quantizer`` is the reference CostumeQuantizer: optional in/out linear
projections (``quantizer.input_proj``, ``quantizer.output_proj``), an
optional tanh range clamp, and the stacked codebooks at
``quantizer.rq.model.*``. ``train_forward`` is the EMA training forward
(quant/rvq.py rvq_train_forward); it returns the new codebook state
without writing the buffers.

``ResidualQuantizer`` is the lucidrains-surface ``residual_quantizer`` on the
same core, and ``IdentityQuantizer`` the debug pass-through
``identity_quantizer`` (no codebooks).
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


def dropout_depths(num_quantizers: int, cutoff_index: int, multiple_of: int) -> Tuple[int, ...]:
    """The quantize-dropout depths of lucidrains' ResidualVQ as a multiset:
    it draws c = randrange(cutoff_index, n_q) and keeps round_up(c + 1,
    multiple_of) layers (at most n_q); one entry per c, duplicates kept, so
    a uniform draw over the entries (rvq_train_forward's) has randrange's
    probabilities."""
    m = max(1, multiple_of)
    depths = sorted(min(-(-(c + 1) // m) * m, num_quantizers)
                    for c in range(max(1, cutoff_index), num_quantizers))
    return tuple(depths) if depths else (num_quantizers,)


class ResidualQuantizer(Quantizer):
    """The lucidrains-surface residual VQ (residual_quantizer.py:5-49) on the
    same RVQ core and codebook buffers as ``Quantizer``.

    Its call is ``x -> (quantized, indices (B, T, n_q), commit_loss, new
    state)``. ``commitment_weight`` scales the commit loss; quantize dropout
    draws a depth of ``dropout_depths``; the dead-code expiry is the
    working "effective" mode (lucidrains' threshold_ema_dead_code = 2
    fires); sync_kmeans / sync_codebook have nothing to do (the codebook
    statistics are the global batch's under data parallelism anyway). As in
    the JAX package, the gradients are the ddp_core_vq ones (each layer's
    own straight-through estimator), not the vendored module's, and every
    mode ignores the bandwidth (all quantizers).
    """

    def __init__(
        self,
        input_size: int = 512,
        codebook_size: int = 1024,
        num_quantizers: int = 8,
        commitment_weight: float = 1.0,
        ema_decay: float = 0.95,
        quantize_dropout_multiple_of: int = 1,
        quantize_dropout_cutoff_index: int = 1,
        kmeans_init: bool = False,
        sync_kmeans: bool = True,
        sync_codebook: bool = False,
        quantize_dropout: bool = False,
        *,
        device=None,
        generator: torch.Generator,
    ):
        rand_num_quant = (dropout_depths(num_quantizers, quantize_dropout_cutoff_index, quantize_dropout_multiple_of)
                          if quantize_dropout else None)
        cfg = QuantizerConfig(input_size=input_size, codebook_size=codebook_size, num_quantizers=num_quantizers,
                              ema_decay=ema_decay, kmeans_init=kmeans_init, quantize_dropout=quantize_dropout,
                              rand_num_quant=rand_num_quant, expiry_mode="effective")
        super().__init__(cfg, device=device, generator=generator)
        self.commitment_weight = float(commitment_weight)
        self.code_dim = input_size

    def output_size(self) -> int:
        return self.code_dim

    def n_q_for_bandwidth(self, bandwidth: Optional[float]) -> int:
        return self.cfg.num_quantizers

    def forward(self, x: torch.Tensor, generator: torch.Generator, state: Optional[RVQTensors] = None,
                group: Optional[DataGroup] = None):
        """The training forward, lucidrains' contract: (quantized, indices
        (B, T, n_q) with -1 for dropped layers, weighted commit loss, new
        state)."""
        quantized, indices, commit, _, new_state = self.train_forward(x, generator, state, group=group)
        return quantized, indices.permute(1, 2, 0), commit, new_state

    def train_forward(self, x: torch.Tensor, generator: torch.Generator, state: Optional[RVQTensors] = None,
                      bandwidth: Optional[float] = None, group: Optional[DataGroup] = None):
        q, idx, commit, sub_quants, new_state = super().train_forward(x, generator, state, group=group)
        return q, idx, self.commitment_weight * commit, sub_quants, new_state


class IdentityQuantizer(nn.Module):
    """The debug pass-through quantizer (identity_quantizer.py:5-23): the
    latents go through unchanged, the indices are zeros (1, B, T), the
    commit loss 0. It holds no codebooks: its state is an RVQ state of zero
    quantizers (``quantizer.rq.model.*`` buffers with no rows), and it has
    no ``rvq_cfg``, so the train step reports no codebook health. Decoding
    tokens raises."""

    def __init__(self, cfg: Optional[QuantizerConfig] = None, input_size: int = 128, *, device=None):
        super().__init__()
        self.cfg = cfg or QuantizerConfig(input_size=input_size, num_quantizers=1)
        empty = dataclasses.replace(self.cfg.rvq(), num_quantizers=0, kmeans_init=True)
        self.rq = _ResidualVQ(empty, device=device, generator=None)

    @property
    def state(self) -> RVQState:
        return self.rq.model

    def n_q_for_bandwidth(self, bandwidth: Optional[float]) -> int:
        return 1

    def _zeros(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros(1, x.shape[0], x.shape[1], dtype=torch.int32, device=x.device)

    def train_forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                      state: Optional[RVQTensors] = None, bandwidth: Optional[float] = None,
                      group: Optional[DataGroup] = None):
        state = self.state.tensors() if state is None else state
        return x, self._zeros(x), torch.zeros((), device=x.device), x[None], state

    def inference(self, x: torch.Tensor, bandwidth: Optional[float] = None):
        return x, self._zeros(x), x[None]

    def encode(self, x: torch.Tensor, bandwidth: Optional[float] = None) -> torch.Tensor:
        return self._zeros(x)

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("IdentityQuantizer has no codebooks to decode")
