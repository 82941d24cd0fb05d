"""Epoch-seeded batch samplers (port of funcodec_tpu/data/sampler.py).

Host-side numpy, as in the JAX package, so that both packages build the
same batches from the same ids, lengths and seed.

Behavioral reference: funcodec/samplers/build_batch_sampler.py:78-168
(unsorted / sorted / length samplers) and
funcodec/iterators/sequence_iter_factory.py:27-143 (batches regenerated
deterministically from seed+epoch, enabling exact resume).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def unsorted_batches(
    uttids: Sequence[str],
    batch_size: int,
    drop_last: bool = True,
) -> List[List[str]]:
    batches = [
        list(uttids[i : i + batch_size])
        for i in range(0, len(uttids), batch_size)
    ]
    if drop_last and batches and len(batches[-1]) < batch_size:
        batches.pop()
    return batches


def sorted_batches(
    uttids: Sequence[str],
    lengths: Dict[str, int],
    batch_size: int,
    drop_last: bool = True,
    descending: bool = True,
) -> List[List[str]]:
    order = sorted(uttids, key=lambda u: lengths[u], reverse=descending)
    return unsorted_batches(order, batch_size, drop_last)


def length_batches(
    uttids: Sequence[str],
    lengths: Dict[str, int],
    batch_bins: int,
    drop_last: bool = False,
) -> List[List[str]]:
    """Pack utterances until the padded token count exceeds batch_bins
    (the 'length' batch_type family)."""
    order = sorted(uttids, key=lambda u: lengths[u])
    batches: List[List[str]] = []
    cur: List[str] = []
    for u in order:
        cand = cur + [u]
        cost = lengths[u] * len(cand)  # padded bins for the sorted batch
        if cur and cost > batch_bins:
            batches.append(cur)
            cur = [u]
        else:
            cur = cand
    if cur and not (drop_last and batches):
        batches.append(cur)
    return batches


def folded_batches(
    uttids: Sequence[str],
    lengths: Dict[str, int],
    batch_size: int,
    fold_length: int,
    drop_last: bool = False,
) -> List[List[str]]:
    """Folded sampler: batch size shrinks for long utterances
    (batch_size / ceil(len / fold_length), samplers/folded_batch_sampler)."""
    order = sorted(uttids, key=lambda u: lengths[u], reverse=True)
    batches: List[List[str]] = []
    i = 0
    while i < len(order):
        u = order[i]
        factor = max(1, -(-lengths[u] // fold_length))
        bs = max(1, batch_size // factor)
        batches.append(order[i : i + bs])
        i += bs
    if drop_last and len(batches) > 1 and len(batches[-1]) < max(
        1, batch_size // max(1, -(-lengths[batches[-1][0]] // fold_length))
    ):
        batches.pop()
    return batches


def numel_batches(
    uttids: Sequence[str],
    shapes: Dict[str, Sequence[int]],
    batch_bins: int,
) -> List[List[str]]:
    """Pack by total padded element count (the 'numel' batch_type family)."""
    order = sorted(uttids, key=lambda u: int(np.prod(shapes[u])))
    batches: List[List[str]] = []
    cur: List[str] = []
    for u in order:
        cand = cur + [u]
        cost = int(np.prod(shapes[u])) * len(cand)
        if cur and cost > batch_bins:
            batches.append(cur)
            cur = [u]
        else:
            cur = cand
    if cur:
        batches.append(cur)
    return batches


def shuffle_batches_for_epoch(
    batches: List[List[str]], seed: int, epoch: int, shuffle: bool = True
) -> List[List[str]]:
    """Deterministic epoch shuffle (sequence_iter_factory.py:65-129)."""
    if not shuffle:
        return list(batches)
    rng = np.random.RandomState(seed + epoch)
    order = rng.permutation(len(batches))
    return [batches[i] for i in order]


def shard_batches(batches: List[List[str]], shard: int, num_shards: int):
    """Rank sharding batches[shard::num_shards] (abs_task.py:1643), for
    loading data in several processes; one card takes the whole batch."""
    return batches[shard::num_shards]
