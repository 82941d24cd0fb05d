"""Chunked training batches for long utterances (port of
funcodec_tpu/data/chunk_iter.py).

Behavioral reference: funcodec/iterators/chunk_iter_factory.py:19-215
(ChunkIterFactory: each utterance sliced into fixed-length chunks with a
shift ratio, a cache that pools chunks of one length into batches, and
epoch-seeded shuffling). Host code: the batches are numpy, and every batch
of a length has the same shape.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple, Union

import numpy as np


def parse_chunk_lengths(spec: Union[int, str, Sequence[int]]) -> List[int]:
    """'500', '500,1000' or [500, 1000] (chunk_iter_factory.py length spec)."""
    if isinstance(spec, int):
        return [spec]
    if isinstance(spec, str):
        return [int(x) for x in spec.replace(",", " ").split()]
    return [int(x) for x in spec]


class ChunkIterFactory:
    """Slice utterances into fixed chunks and pool same-length batches.

    ``build_iter(epoch)`` yields (keys, {feature: (B, L, ...), feature_lengths:
    (B,) = L}); a key is ``{uttid}_{n}``, the utterance's n-th chunk. With
    ``shuffle`` the utterance order, each utterance's chunk length (among
    those that fit) and its first chunk's offset (inside one shift) come
    from ``RandomState(seed + epoch)``, the JAX package's draws."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        chunk_length: Union[int, str, Sequence[int]] = 500,
        chunk_shift_ratio: float = 0.5,
        seed: int = 0,
        shuffle: bool = True,
        feature_name: str = "speech",
        num_cache_chunks: int = 1024,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.chunk_lengths = parse_chunk_lengths(chunk_length)
        self.chunk_shift_ratio = chunk_shift_ratio
        self.seed = seed
        self.shuffle = shuffle
        self.feature_name = feature_name
        self.num_cache_chunks = max(num_cache_chunks, batch_size)

    def build_iter(self, epoch: int) -> Iterator[Tuple[List[str], Dict[str, np.ndarray]]]:
        rng = np.random.RandomState(self.seed + epoch)
        order = list(self.dataset.uttids)
        if self.shuffle:
            rng.shuffle(order)
        cache: Dict[int, List[Tuple[str, np.ndarray]]] = {L: [] for L in self.chunk_lengths}
        name = self.feature_name

        def flush(L: int, force: bool = False):
            while len(cache[L]) >= self.batch_size or (force and cache[L]):
                batch = cache[L][: self.batch_size]
                del cache[L][: len(batch)]
                yield [k for k, _ in batch], {
                    name: np.stack([a for _, a in batch]),
                    f"{name}_lengths": np.full((len(batch),), L, np.int64),
                }

        for uid in order:
            _, data = self.dataset[uid]
            feat = np.asarray(data[name])
            T = feat.shape[0]
            fits = [L for L in self.chunk_lengths if L <= T]
            if not fits:
                continue
            L = int(fits[rng.randint(len(fits))]) if self.shuffle else fits[0]
            shift = max(1, int(L * self.chunk_shift_ratio))
            # a random offset into the first shift window (chunk_iter_factory.py)
            start = int(rng.randint(0, shift)) if self.shuffle and T > L else 0
            n = 0
            while start + L <= T:
                cache[L].append((f"{uid}_{n}", feat[start: start + L]))
                start += shift
                n += 1
            yield from flush(L)
        for L in self.chunk_lengths:
            yield from flush(L, force=True)
