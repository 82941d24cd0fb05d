"""Residual vector quantization, inference subset (port of funcodec_tpu/quant/rvq.py).

The codebooks are buffers of an ``RVQState`` module, stacked over the
quantizers like the reference's DistributedResidualVectorQuantization
(``quantizer.rq.model.{inited,cluster_size,embed,embed_avg}``). The EMA
training forward is ROADMAP.md slice B.

The fp32 path is the bit-exact scan: plain torch ops, fp32, first-max ties.
With ``FUSED_RVQ`` on, ``rvq_inference`` runs the codebook search in the
hand-written CUDA kernel (quant/rvq_kernel.py), with the numerics of the JAX
package's Pallas kernel (bf16 operands, fp32 accumulation).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn

# Route eval-mode codebook searches through the fused kernel
# (quant/rvq_kernel.py); the counterpart of funcodec_tpu's rvq.PALLAS_RVQ.
# Opt-in: the bf16 search can flip near-tie tokens against the fp32 scan.
FUSED_RVQ = False


@dataclasses.dataclass(frozen=True)
class RVQConfig:
    """Static RVQ configuration: the inference fields of the JAX RVQConfig
    (the EMA, dropout and expiry fields come with the training forward)."""

    dim: int = 128
    codebook_size: int = 1024
    num_quantizers: int = 32
    kmeans_init: bool = True
    sampling_rate: int = 16_000
    encoder_hop_length: int = 320

    def bandwidth_per_quantizer(self) -> float:
        """bps per quantizer: log2(bins) * sr / hop."""
        return math.log2(self.codebook_size) * self.sampling_rate / self.encoder_hop_length

    def num_quantizers_for_bandwidth(self, bandwidth: Optional[float]) -> int:
        """n_q = max(1, floor(bw / bw_per_q)); all quantizers for None or <= 0."""
        if bandwidth is not None and bandwidth > 0.0:
            return int(max(1, math.floor(bandwidth / self.bandwidth_per_quantizer())))
        return self.num_quantizers


class RVQState(nn.Module):
    """Stacked codebook buffers for all quantizers.

    Initialized like funcodec_tpu's init_rvq_state: with kmeans_init the
    codebooks are zero (and `inited` 0) until a checkpoint is loaded;
    otherwise torch's kaiming_uniform on (bins, dim), drawn from `generator`.
    """

    def __init__(self, cfg: RVQConfig, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        n_q, bins, dim = cfg.num_quantizers, cfg.codebook_size, cfg.dim
        if cfg.kmeans_init:
            embed = torch.zeros(n_q, bins, dim, device=device)
            inited = torch.zeros(n_q, device=device)
        else:
            if generator is None:
                raise ValueError("uniform codebook init needs a torch.Generator")
            gain = math.sqrt(2.0 / (1.0 + 5.0))
            bound = gain * math.sqrt(3.0 / dim)
            embed = torch.empty(n_q, bins, dim, device=device)
            embed.uniform_(-bound, bound, generator=generator)
            inited = torch.ones(n_q, device=device)
        self.register_buffer("inited", inited)
        self.register_buffer("cluster_size", torch.zeros(n_q, bins, device=device))
        self.register_buffer("embed", embed)
        self.register_buffer("embed_avg", embed.clone())


def nearest_codebook_indices(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """argmax of -(||x||^2 - 2 x.e + ||e||^2) over the codebook, in fp32.

    x: (N, D), embed: (bins, D) -> (N,) int32. torch.argmax returns the first
    maximal index, as jnp.argmax does.
    """
    x32 = x.float()
    e32 = embed.float()
    dist = -(
        (x32 * x32).sum(dim=1, keepdim=True)
        - 2.0 * (x32 @ e32.T)
        + (e32 * e32).sum(dim=1)[None, :]
    )
    return dist.argmax(dim=-1).to(torch.int32)


def rvq_encode(
    cfg: RVQConfig, state: RVQState, x: torch.Tensor, n_q: Optional[int] = None
) -> torch.Tensor:
    """Greedy residual encode, fp32. x: (B, T, D) -> indices (n_q, B, T) int32."""
    _, indices, _ = _scan(state.embed[: n_q or cfg.num_quantizers], x)
    return indices


def rvq_decode(cfg: RVQConfig, state: RVQState, indices: torch.Tensor) -> torch.Tensor:
    """indices (n_q', B, T) -> (B, T, D) sum of codebook vectors."""
    return gather_codewords(state.embed, indices).sum(dim=0)


def gather_codewords(embed: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Per-quantizer codewords: embed (>=n_q, bins, D), indices (n_q, B, T)
    -> (n_q, B, T, D)."""
    n_q = indices.shape[0]
    q = torch.arange(n_q, device=indices.device).view(n_q, 1, 1)
    return embed[:n_q][q, indices.long()]


def _scan(embed: torch.Tensor, x: torch.Tensor):
    """The bit-exact fp32 scan over embed (n_q, bins, D).

    Returns (sum of codewords (B, T, D) fp32, indices (n_q, B, T) int32,
    codewords (n_q, B, T, D) fp32)."""
    B, T, D = x.shape
    residual = x.reshape(B * T, D).float()
    idxs, quants = [], []
    for embed_q in embed:
        idx = nearest_codebook_indices(residual, embed_q)
        quantized = embed_q[idx.long()]
        residual = residual - quantized
        idxs.append(idx)
        quants.append(quantized)
    quants = torch.stack(quants)
    n_q = quants.shape[0]
    return (
        quants.sum(dim=0).reshape(B, T, D),
        torch.stack(idxs).reshape(n_q, B, T),
        quants.reshape(n_q, B, T, D),
    )


def rvq_inference(
    cfg: RVQConfig, state: RVQState, x: torch.Tensor, n_q: Optional[int] = None
):
    """Eval-mode forward: quantize with no state updates and no dropout.

    Returns (quantized_out (B,T,D), indices (n_q,B,T) int32,
    sub_quants (n_q,B,T,D)), all but the indices in x's dtype.
    """
    n_q = n_q or cfg.num_quantizers
    if FUSED_RVQ:
        from funcodec_tpu_torch.quant.rvq_kernel import rvq_encode_fused

        indices, quantized = rvq_encode_fused(x, state.embed, n_q)
        # per-layer codewords gathered from the fp32 codebooks, as the JAX
        # branch does
        subq = gather_codewords(state.embed, indices)
        return quantized.to(x.dtype), indices, subq.to(x.dtype)
    quantized, indices, quants = _scan(state.embed[:n_q], x)
    return quantized.to(x.dtype), indices, quants.to(x.dtype)
