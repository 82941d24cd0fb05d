"""Residual vector quantization with EMA codebooks (port of funcodec_tpu/quant/rvq.py).

The codebooks are buffers of an ``RVQState`` module, stacked over the
quantizers like the reference's DistributedResidualVectorQuantization
(``quantizer.rq.model.{inited,cluster_size,embed,embed_avg}``).

The training forward (``rvq_train_forward``: k-means init, EMA updates,
dead-code expiry, quantizer dropout) is functional, as in the JAX package:
it reads the four buffers as ``RVQTensors`` and returns new ones, computed
out of place; the train step commits them (``RVQState.commit``) only after
its finite-gradient gate. Random draws come from an explicit
``torch.Generator``, so they differ from jax.random's.

Under data parallelism (a ``parallel.dist.DataGroup``; None is one process)
each rank holds an equal block of the batch's rows, and the codebook
statistics are global, as GSPMD makes JAX's ``jnp.sum(onehot, axis=0)``:
the per-code counts and sums of the EMA, of each Lloyd iteration and of
the k-means counts are summed over the ranks before they are used; the
k-means seeds and the expiry rows are drawn over the global rows from the
generator every rank seeds alike and assembled from the ranks that own
them (``parallel.dist.gather_rows``); the dropout depth is one draw of that
generator. Every rank so computes the same codebooks, bit for bit. The
counts and sums are accumulated in float64 and rounded to fp32 once, so a
split of the rows over ranks rounds as one process does (accumulated in
fp32, the reduction order alone moved the EMA sums past JAX's
data-parallel tolerance within three steps at four ranks). The
commitment losses stay per-rank means, which the equal blocks make
average to the global ones.

The fp32 path is the bit-exact scan: plain torch ops, fp32, first-max ties.
With ``FUSED_RVQ`` on, ``rvq_inference`` runs the codebook search in the
hand-written CUDA kernel (quant/rvq_kernel.py), with the numerics of the JAX
package's Pallas kernel (bf16 operands, fp32 accumulation).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from funcodec_tpu_torch.parallel.dist import DataGroup, gather_rows, owned_rows, sum_over_ranks, world_of

# Route eval-mode codebook searches through the fused kernel
# (quant/rvq_kernel.py); the counterpart of funcodec_tpu's rvq.PALLAS_RVQ.
# Opt-in: the bf16 search can flip near-tie tokens against the fp32 scan.
FUSED_RVQ = False

# Testing hook: run the per-layer scan (the k-means-init-capable "slow" path)
# even when every codebook is initialized, so tests can hold the fast path,
# which does the EMA and expiry for all layers at once, against it.
FORCE_SLOW_SCAN = False


@dataclasses.dataclass(frozen=True)
class RVQConfig:
    """Static RVQ configuration (funcodec_tpu's RVQConfig)."""

    dim: int = 128
    codebook_size: int = 1024
    num_quantizers: int = 32
    decay: float = 0.99
    epsilon: float = 1e-5
    threshold_ema_dead_code: float = 2.0
    kmeans_init: bool = True
    kmeans_iters: int = 50
    quantize_dropout: bool = False
    rand_num_quant: Optional[Tuple[int, ...]] = None
    q0_ds_ratio: int = 1
    sampling_rate: int = 16_000
    encoder_hop_length: int = 320
    commitment_weight: float = 1.0
    expiry_mode: str = "reference"  # reference (inert) | effective | none

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

    def tensors(self) -> "RVQTensors":
        return RVQTensors(self.inited, self.cluster_size, self.embed, self.embed_avg)

    @torch.no_grad()
    def commit(self, new: "RVQTensors") -> None:
        """Copy a training forward's new state into the buffers."""
        for name, value in zip(RVQTensors._fields, new):
            getattr(self, name).copy_(value)


class RVQTensors(NamedTuple):
    """The four codebook buffers as plain tensors: what the training forward
    reads and returns."""

    inited: torch.Tensor  # (n_q,) {0, 1}
    cluster_size: torch.Tensor  # (n_q, bins)
    embed: torch.Tensor  # (n_q, bins, dim)
    embed_avg: torch.Tensor  # (n_q, bins, dim)


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


# ---------------------------------------------------------------------------
# training forward (EMA codebook learning, quantizer dropout, k-means init)
# ---------------------------------------------------------------------------


def _sample_vectors(generator: torch.Generator, samples: torch.Tensor, num: int,
                    group: Optional[DataGroup] = None) -> torch.Tensor:
    """`num` rows of the global samples (this rank's block: samples (N, D)):
    a random permutation's first rows when world * N >= num, else rows
    drawn with replacement."""
    n, dev = samples.shape[0] * world_of(group), generator.device
    if n >= num:
        idx = torch.randperm(n, generator=generator, device=dev)[:num]
    else:
        idx = torch.randint(0, n, (num,), generator=generator, device=dev)
    return gather_rows(samples, idx, group)


def _code_stats(idx: torch.Tensor, samples: torch.Tensor, k: int, group: Optional[DataGroup]) -> torch.Tensor:
    """(k, D + 1) fp32: each of the k codes' sum of the samples (N, D) that
    `idx` (N,) assigns it and, last, their count, over the ranks (one
    all_reduce). Accumulated in float64 and rounded once, so the sums of
    any split of the rows over ranks round alike."""
    onehot = F.one_hot(idx.long(), k).double()
    stats = torch.cat([onehot.T @ samples.double(), onehot.sum(dim=0)[:, None]], dim=1)
    return sum_over_ranks(stats, group).float()


def lloyd(samples: torch.Tensor, means: torch.Tensor, num_iters: int, group: Optional[DataGroup] = None):
    """The k-means iterations from `means` (k, D) over the global samples
    (this rank's block: samples (N, D)), fp32: each mean moves to the
    average of its nearest samples, or stays where no sample is nearest.
    Returns (means, counts (k,))."""
    k = means.shape[0]
    for _ in range(num_iters):
        stats = _code_stats(nearest_codebook_indices(samples, means), samples, k, group)
        bins = stats[:, -1]
        new_means = stats[:, :-1] / bins.clamp_min(1.0)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    idx = nearest_codebook_indices(samples, means)
    return means, sum_over_ranks(F.one_hot(idx.long(), k).to(samples.dtype).sum(dim=0), group)


def kmeans(generator: torch.Generator, samples: torch.Tensor, num_clusters: int, num_iters: int,
           group: Optional[DataGroup] = None):
    """k-means of the global samples (this rank's block: samples (N, D))
    fp32: `num_clusters` rows drawn as the first means, then ``lloyd``.
    Returns (means (k, D), counts (k,))."""
    return lloyd(samples, _sample_vectors(generator, samples, num_clusters, group), num_iters, group)


def _nearest_time_resize(x: torch.Tensor, new_t: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') along time of (B, T, D): row floor(i * T / new_t)."""
    t = x.shape[1]
    idx = torch.floor(torch.arange(new_t, dtype=torch.float32, device=x.device) * (t / new_t)).long()
    return x[:, idx, :]


def _ema(cfg: RVQConfig, cluster: torch.Tensor, avg: torch.Tensor, counts: torch.Tensor,
         embed_sum: torch.Tensor):
    """The EMA step of the cluster sizes and sums, then the Laplace-smoothed
    codebook; over a trailing bins axis (and a leading layer axis or not)."""
    bins, decay, eps = cfg.codebook_size, cfg.decay, cfg.epsilon
    new_cluster = cluster * decay + counts * (1.0 - decay)
    new_avg = avg * decay + embed_sum * (1.0 - decay)
    total = new_cluster.sum(dim=-1, keepdim=True)
    smoothed = (new_cluster + eps) / (total + bins * eps) * total
    return new_cluster, new_avg / smoothed[..., None], new_avg


def _expire(cfg: RVQConfig, cluster, embed, avg, fresh):
    """Effective expiry: codes whose EMA size fell below the threshold
    restart at fresh batch rows, with that size."""
    expired = cluster < cfg.threshold_ema_dead_code
    embed = torch.where(expired[..., None], fresh, embed)
    avg = torch.where(expired[..., None], fresh, avg)
    cluster = torch.where(expired, torch.full_like(cluster, cfg.threshold_ema_dead_code), cluster)
    return cluster, embed, avg


@torch.no_grad()
def _train_one_quantizer(
    cfg: RVQConfig,
    residual: torch.Tensor,  # (N, D) layer input, fp32
    inited_q: torch.Tensor,  # scalar
    cluster_size_q: torch.Tensor,  # (bins,)
    embed_q: torch.Tensor,  # (bins, D)
    embed_avg_q: torch.Tensor,  # (bins, D)
    active: bool,
    generator: torch.Generator,
    fresh_idx: Optional[torch.Tensor] = None,  # (bins,) global rows for effective expiry
    group: Optional[DataGroup] = None,
):
    """One codebook's forward and EMA step.

    Returns (quantized (N, D), indices (N,) int32, inited, cluster_size,
    embed, embed_avg), no gradient anywhere. An inactive layer (dropout)
    keeps its buffers; an active one not yet initialized is k-means
    initialized on this batch first."""
    bins = cfg.codebook_size
    xs = residual.detach().float()
    if cfg.kmeans_init and active and float(inited_q) < 0.5:
        means, counts = kmeans(generator, xs, bins, cfg.kmeans_iters, group)
        embed_q, embed_avg_q, cluster_size_q = means, means, counts
        inited_q = torch.ones_like(inited_q)
    idx = nearest_codebook_indices(xs, embed_q)
    quantized = embed_q[idx.long()]
    if not active:
        return quantized, idx, inited_q, cluster_size_q, embed_q, embed_avg_q
    stats = _code_stats(idx, xs, bins, group)
    cluster, embed, avg = _ema(cfg, cluster_size_q, embed_avg_q, stats[:, -1], stats[:, :-1])
    if cfg.expiry_mode == "effective":
        fresh = (gather_rows(xs, fresh_idx, group) if fresh_idx is not None
                 else _sample_vectors(generator, xs, bins, group))
        cluster, embed, avg = _expire(cfg, cluster, embed, avg, fresh)
    return quantized, idx, inited_q, cluster, embed, avg


def _fresh_rows(cfg: RVQConfig, generator: torch.Generator, n_scan: int, N: int, device) -> Optional[torch.Tensor]:
    """(n_scan, bins) rows of the global batch (N rows) for effective expiry,
    drawn once for all layers: windows at random offsets of one shared
    permutation (distinct rows within a layer), or rows with replacement
    when N < bins."""
    if cfg.expiry_mode != "effective":
        return None
    bins, dev = cfg.codebook_size, generator.device
    if N >= bins:
        perm = torch.randperm(N, generator=generator, device=dev)
        offs = torch.randint(0, N, (n_scan,), generator=generator, device=dev)
        rows = perm[(offs[:, None] + torch.arange(bins, device=dev)[None, :]) % N]
    else:
        rows = torch.randint(0, N, (n_scan, bins), generator=generator, device=dev)
    return rows.to(device)


def _slow_scan(cfg, state: RVQTensors, flat_sg, start, n_on, generator, fresh, group):
    """The per-layer scan over the active layers, k-means init mid-chain."""
    residual, outs = flat_sg, []
    for i in range(n_on):
        l = start + i
        out = _train_one_quantizer(cfg, residual, state.inited[l], state.cluster_size[l], state.embed[l],
                                   state.embed_avg[l], True, generator, None if fresh is None else fresh[i],
                                   group)
        residual = residual - out[0]
        outs.append(out)
    qs, idxs, inited, cluster, embed, avg = (torch.stack(t) for t in zip(*outs))
    return idxs, qs, RVQTensors(inited, cluster, embed, avg)


@torch.no_grad()
def _fast_scan(cfg, state: RVQTensors, flat_sg, start, n_on, fresh, group):
    """The search over the active layers (distance, argmax, gather,
    subtract), then the EMA and expiry of all of them at once."""
    embed_slice = state.embed[start: start + n_on]
    residual, idxs, qs = flat_sg, [], []
    for embed_q in embed_slice:
        idx = nearest_codebook_indices(residual, embed_q)
        q = embed_q[idx.long()]
        residual = residual - q
        idxs.append(idx)
        qs.append(q)
    idxs, qs = torch.stack(idxs), torch.stack(qs)
    N, D = flat_sg.shape
    r_stack = flat_sg[None] - (torch.cumsum(qs, dim=0) - qs)  # each layer's input
    onehot = F.one_hot(idxs.long(), cfg.codebook_size).double()  # (n, N, bins)
    r_aug = torch.cat([r_stack, torch.ones(n_on, N, 1, device=flat_sg.device)], dim=-1).double()
    # [..., :D] per-code sums, [..., D] counts, over the ranks; float64, rounded once (_code_stats)
    sums = sum_over_ranks(torch.bmm(onehot.transpose(1, 2), r_aug), group).float()
    sl = slice(start, start + n_on)
    cluster, embed, avg = _ema(cfg, state.cluster_size[sl], state.embed_avg[sl], sums[..., D], sums[..., :D])
    if fresh is not None:
        local, mine = owned_rows(fresh[:n_on], N, group)
        picked = torch.gather(r_stack, 1, local[:, :, None].expand(-1, -1, D))
        if group is not None:
            picked = sum_over_ranks(torch.where(mine[..., None], picked, torch.zeros_like(picked)), group)
        cluster, embed, avg = _expire(cfg, cluster, embed, avg, picked)
    return idxs, qs, RVQTensors(state.inited[sl], cluster, embed, avg)


def _with_rows(state: RVQTensors, start: int, rows: RVQTensors) -> RVQTensors:
    """state with layers start.. replaced by rows, out of place."""
    out = []
    for old, new in zip(state, rows):
        t = old.clone()
        t[start: start + new.shape[0]] = new
        out.append(t)
    return RVQTensors(*out)


def rvq_train_forward(
    cfg: RVQConfig,
    state: RVQTensors,
    x: torch.Tensor,  # (B, T, D)
    generator: torch.Generator,
    n_q: Optional[int] = None,
    group: Optional[DataGroup] = None,
):
    """The RVQ training forward (funcodec_tpu quant/rvq.py rvq_train_forward).

    Gradients follow the reference: each layer has its own straight-through
    estimator, so residuals past layer 0 carry no gradient and only layer
    0's commit loss reaches the encoder; the summed output passes an
    identity gradient to `x`. With quantizer dropout one depth of
    ``rand_num_quant`` is drawn; the layers past it are skipped: index -1,
    commit 0, sub_quants -1.0, buffers unchanged. The per-layer scan runs
    while some codebook awaits its k-means init (or with FORCE_SLOW_SCAN),
    the fast path otherwise.

    Returns (quantized_out (B, T, D) in x's type, indices (n_q, B, T) int32,
    commit_losses (n_q,), sub_quants (n_q, B, T, D) fp32, new state). The
    new state is computed out of place; `state` is not written. With a
    `group`, x is this rank's equal block of the batch and the statistics
    and draws are the global batch's (module docstring).
    """
    n_q = n_q or cfg.num_quantizers
    B, T, D = x.shape
    x32 = x.float()
    flat = x32.reshape(B * T, D)
    if cfg.quantize_dropout and cfg.rand_num_quant:
        options = cfg.rand_num_quant
        pick = torch.randint(len(options), (1,), generator=generator, device=generator.device)
        cutoff = int(options[int(pick)])
    else:
        cutoff = n_q
    w = cfg.commitment_weight

    start, q0 = 0, None
    if cfg.q0_ds_ratio > 1:
        # quantizer 0 on a nearest-resized T // 2 input (the reference fixes
        # the factor at 2), its outputs resized back to T
        t_ds = T // 2
        x_ds = _nearest_time_resize(x32, t_ds).reshape(B * t_ds, D)
        q, idx0, i0, c0, e0, a0 = _train_one_quantizer(
            cfg, x_ds, state.inited[0], state.cluster_size[0], state.embed[0], state.embed_avg[0], True, generator,
            group=group)
        q_ste = x_ds + (q - x_ds).detach()
        commit0 = ((q - x_ds) ** 2).mean() * w
        q0_up = _nearest_time_resize(q_ste.reshape(B, t_ds, D), T)
        idx0_up = _nearest_time_resize(idx0.reshape(B, t_ds, 1).float(), T)[..., 0].to(torch.int32)
        flat = (x32 - q0_up).reshape(B * T, D)
        q0 = (idx0_up, commit0, q0_up, RVQTensors(torch.maximum(i0, state.inited[0])[None], c0[None], e0[None],
                                                  a0[None]))
        start = 1

    n_scan = n_q - start
    N = flat.shape[0]
    n_on = max(0, min(cutoff, n_q) - start)  # the active layers of the scan
    flat_sg = flat.detach()
    fresh = _fresh_rows(cfg, generator, n_scan, N * world_of(group), x.device) if n_scan else None
    inited_slice = state.inited[start:n_q]
    slow = FORCE_SLOW_SCAN or (cfg.kmeans_init and bool((inited_slice <= 0.5).any()))
    if n_on == 0:
        idxs = qs = rows = None
    elif slow:
        idxs, qs, rows = _slow_scan(cfg, state, flat_sg, start, n_on, generator, fresh, group)
    else:
        idxs, qs, rows = _fast_scan(cfg, state, flat_sg, start, n_on, fresh, group)

    off = n_scan - n_on
    dev = x.device
    if n_on:
        # the differentiable part: the summed STE and the commit losses
        with torch.no_grad():
            r_stack = flat_sg[None] - (torch.cumsum(qs, dim=0) - qs)
            sum_q = qs.sum(dim=0)
        quantized_out = flat + (sum_q - flat).detach()
        diff0 = qs[0] - flat
        commit_rest = ((qs[1:] - r_stack[1:]) ** 2).mean(dim=(1, 2)) * w
        commits = torch.cat([((diff0 * diff0).mean() * w)[None], commit_rest, torch.zeros(off, device=dev)])
        indices = torch.cat([idxs, torch.full((off, N), -1, dtype=torch.int32, device=dev)])
        sub_quants = torch.cat([qs, torch.full((off, N, D), -1.0, device=dev)])
        new_state = _with_rows(state, start, rows)
    else:
        quantized_out = torch.zeros_like(flat)
        commits = torch.zeros(n_scan, device=dev)
        indices = torch.full((n_scan, N), -1, dtype=torch.int32, device=dev)
        sub_quants = torch.full((n_scan, N, D), -1.0, device=dev)
        new_state = state
    quantized_out = quantized_out.reshape(B, T, D)
    indices = indices.reshape(n_scan, B, T)
    sub_quants = sub_quants.reshape(n_scan, B, T, D)

    if q0 is not None:
        idx0_up, commit0, q0_up, rows0 = q0
        quantized_out = quantized_out + q0_up
        indices = torch.cat([idx0_up[None], indices])
        commits = torch.cat([commit0[None], commits])
        sub_quants = torch.cat([q0_up.detach()[None], sub_quants])
        new_state = _with_rows(new_state, 0, rows0)
    return quantized_out.to(x.dtype), indices, commits, sub_quants, new_state


def codebook_health(cfg: RVQConfig, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dead_codes, usage_perplexity): codes whose EMA size is below the
    expiry threshold, summed over layers; and exp(entropy) of each layer's
    EMA size distribution, averaged over layers, over codebook_size (1.0 is
    uniform use, near 0 a collapse)."""
    cs = state.cluster_size.float()
    dead = (cs < cfg.threshold_ema_dead_code).float().sum()
    p = cs / cs.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    entropy = -torch.where(p > 0, p * torch.log(p.clamp_min(1e-12)), torch.zeros_like(p)).sum(dim=-1)
    return dead, torch.exp(entropy).mean() / cfg.codebook_size
