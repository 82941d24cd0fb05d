"""The one traffic generator: every mix is a JSON file of parameters.

Sizes are a fixed multiset, the quantiles of the mix's length law, and the
seed only orders them and picks the audio. So every seed
does the same work, and runs differ by content and order, not by amount.

The batching copies the codec CLI's (``cli/codec_inference``
``_iter_batches`` / ``_bucket_length`` / ``_wrap_pad``): length-sorted
utterances, cut into batches, each wrap-padded to a multiple of
``bucket_frames`` frames.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np
import torch


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one stream of a run's seed (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def quantiles(law: dict, n: int) -> np.ndarray:
    """The n mid-quantiles ((i + 0.5) / n) of a length law, clipped to
    [min, max]: ``fixed`` at ``value``, ``lognormal`` with ``mean`` (of the
    law) and ``sigma`` (of its log), or ``uniform`` on [min, max]."""
    u = (np.arange(n) + 0.5) / n
    if law["law"] == "fixed":
        x = np.full(n, float(law["value"]))
    elif law["law"] == "uniform":
        x = law["min"] + u * (law["max"] - law["min"])
    elif law["law"] == "lognormal":
        mu = math.log(law["mean"]) - 0.5 * law["sigma"] ** 2
        z = np.array([NormalDist().inv_cdf(p) for p in u])
        x = np.exp(mu + law["sigma"] * z)
    else:
        raise ValueError(f"unknown law {law['law']!r}")
    return np.clip(x, law.get("min", 0.0), law.get("max", np.inf))


def bucket_length(t: int, hop: int, quantum: int) -> int:
    """T rounded up so that its frame count is a multiple of `quantum`."""
    frames = -(-t // hop)
    return -(-frames // quantum) * quantum * hop


def wrap_pad(arrs: List[np.ndarray], target: int) -> np.ndarray:
    return np.stack([np.pad(a, (0, target - a.shape[0]), mode="wrap") if a.shape[0] < target else a for a in arrs])


def sorted_batches(lengths: np.ndarray, batch: int, hop: int, quantum: int) -> List[Tuple[int, int, int]]:
    """(first, end, padded length) of each batch of the sorted lengths."""
    out = []
    for i in range(0, len(lengths), batch):
        out.append((i, min(i + batch, len(lengths)), bucket_length(int(lengths[min(i + batch, len(lengths)) - 1]),
                                                                   hop, quantum)))
    return out


def pcm_pool(seconds: float, sr: int, seed: int, device) -> np.ndarray:
    """int16 PCM made once in set-up, on the device: noise under a slow
    random loudness envelope (0.02-0.3 rms in 0.25 s steps)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    n = int(seconds * sr)
    steps = -(-n // (sr // 4))
    env = torch.empty(steps, device=device).uniform_(0.02, 0.3, generator=gen)
    env = env.repeat_interleave(sr // 4)[:n]
    x = torch.randn(n, device=device, generator=gen) * env
    return (x.clamp(-1, 32767 / 32768) * 32768).round().to(torch.int16).cpu().numpy()


def cut(pool: np.ndarray, length: int, r: np.random.Generator) -> np.ndarray:
    off = int(r.integers(0, pool.shape[0] - length + 1))
    return pool[off: off + length]
