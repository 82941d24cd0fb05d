"""Device-resident corpus cache: training crops gathered on the card (port
of funcodec_tpu/data/device_cache.py).

For a corpus that fits in device memory, the utterances are staged on the
card once as one (N, t_max) fp32 tensor, and each training batch is cut
from it there: a step uploads B row indices and B crop offsets instead of
B x speech_max_length samples, and the host decodes no audio after the
first epoch's staging.

Crop semantics match CodecPreprocessor (preprocessor.py:117-128, reference
datasets/preprocessor.py:547-560): an utterance longer than the crop gets a
uniform start in [0, T - L - 1] (``randint(0, T - L)``, high-exclusive); a
shorter one is zero-padded to L (rows are staged zero-padded, offset 0).
The offsets come from an epoch-seeded host RNG,
``RandomState((seed * 100003 + epoch) % (2**31 - 1))`` and ``floor(U * hi)``,
the JAX package's draws, so both packages cut the same crops for the same
seed and epoch, and a resumed run the crops of an uninterrupted one.

Not valid with RIR/noise augmentation or per-crop normalization (those are
per-crop host transforms); the trainer refuses the combination.

Under data parallelism every rank stages the whole corpus (a replica, as
the JAX package replicates it over the mesh), draws the offsets of the
whole batch from the same epoch-seeded RNG, and cuts the crops of its own
block of the rows (``parallel.dist.local_rows``), so the ranks' crops are
one process's, split.
"""

from __future__ import annotations

import logging
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from funcodec_tpu_torch.parallel.dist import DataGroup, local_rows


def gather_crops(cache: torch.Tensor, idx: torch.Tensor, off: torch.Tensor, crop_len: int) -> torch.Tensor:
    """rows = cache[idx]; rows[b, off[b] : off[b] + crop_len]: one index
    gather on the cache's device. idx, off (B,) int64 -> (B, crop_len)."""
    cols = off[:, None] + torch.arange(crop_len, device=cache.device)[None, :]
    return cache[idx[:, None], cols]


class DeviceCachedCrops:
    """Stage a whole (small) corpus on the card; serve crops as device tensors.

    Parameters
    ----------
    dataset: CodecDataset (its `raw_item` bypasses the preprocessor: the
        cache needs full utterances, cropping happens on the card).
    ids: utterance ids to stage (training split).
    crop_len: speech_max_length (the crop size).
    device: where the corpus lives, the card unless the caller asks for
        the CPU.
    """

    def __init__(self, dataset, ids: Sequence[str], crop_len: int, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        from funcodec_tpu_torch.tasks.codec import resolve_device

        if crop_len <= 0:
            raise ValueError("device_cache requires speech_max_length > 0")
        self.device = resolve_device(device)
        self.ids = list(ids)
        self.crop_len = int(crop_len)
        self.seed = int(seed)
        self.row = {u: i for i, u in enumerate(self.ids)}

        lengths = np.zeros(len(self.ids), np.int64)
        wavs: List[np.ndarray] = []
        for i, u in enumerate(self.ids):
            _, data = dataset.raw_item(u)
            w = np.asarray(data["speech"], np.float32)
            if w.ndim == 2:  # multi-channel: first channel, like the preprocessor
                w = w[:, 0]
            lengths[i] = len(w)
            wavs.append(w)
        t_max = max(int(lengths.max()), self.crop_len)
        # a single outlier-long utterance pads EVERY row to its length (dense
        # (N, t_max) staging): say so before the footprint surprises anyone
        payload = int(lengths.sum())
        self.t_max = t_max
        self.padding_overhead = (len(self.ids) * t_max) / max(payload, 1)
        if self.padding_overhead > 2.0:
            logging.warning(
                "device_cache: dense staging pads the corpus %.1fx past its "
                "payload (t_max=%d vs mean len %.0f) — a few outlier-long "
                "utterances dominate; consider cropping them on host first",
                self.padding_overhead, t_max, payload / max(len(self.ids), 1),
            )
        host = np.zeros((len(self.ids), t_max), np.float32)
        for i, w in enumerate(wavs):
            host[i, : len(w)] = w
        # ONE upload for the whole corpus (then freed on host)
        self.cache = torch.from_numpy(host).to(self.device)
        self.lengths = lengths
        # max valid crop start per row (0 when the row is shorter than the crop)
        self._max_start = np.maximum(lengths - self.crop_len, 0)

    def nbytes(self) -> int:
        return self.cache.numel() * self.cache.element_size()

    def epoch_offsets(self, batches: Sequence[Sequence[str]], epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(row indices, crop offsets) of each batch, int64, from the
        epoch-seeded host RNG."""
        rng = np.random.RandomState((self.seed * 100003 + epoch) % (2**31 - 1))
        for keys in batches:
            idx = np.asarray([self.row[u] for u in keys], np.int64)
            hi = self._max_start[idx]
            # floor(U[0,1) * hi) == randint(0, hi) high-exclusive — the host
            # preprocessor / reference semantics (preprocessor.py:121,
            # reference datasets/preprocessor.py:564); hi==0 rows start at 0
            off = (rng.random_sample(len(idx)) * np.maximum(hi, 1)).astype(np.int32).astype(np.int64)
            yield idx, off

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def epoch_loader(self, batches: Sequence[Sequence[str]], epoch: int, group: Optional[DataGroup] = None):
        """Yield (keys, {"speech": (B, crop_len) crops on the card}) for each
        batch of uttids, cut at ``epoch_offsets``: this rank's rows of each
        batch under a data `group`."""
        for keys, (idx, off) in zip(batches, self.epoch_offsets(batches, epoch)):
            idx, off = local_rows(idx, group), local_rows(off, group)
            speech = gather_crops(self.cache, self._upload(idx), self._upload(off), self.crop_len)
            yield local_rows(list(keys), group), {"speech": speech}
