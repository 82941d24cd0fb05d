"""Streaming data pipeline over jsonl ``data.list`` shards (port of
funcodec_tpu/data/streaming.py).

Behavioral reference: funcodec/datasets/large_datasets/ (the WeNet-style
LargeDataLoader, build_dataloader.py:66-95, and dataset.py's chain of ops:
parse -> shuffle buffer -> load and resample -> filter -> preprocess ->
sort buffer -> batch). Each op is a generator over the previous one's
items, so the chain streams an arbitrarily large corpus in O(buffer)
memory. Host code on numpy; audio through data/wav_io.py.
"""

from __future__ import annotations

import json
import logging
import struct
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from funcodec_tpu_torch.data.wav_io import read_wav, resample


def parse_list(paths: Sequence[str]) -> Iterator[Dict]:
    """The items of jsonl data.list file(s): {"key": ..., "wav": ...} a line."""
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)


def load_audio(stream: Iterator[Dict], target_sr: int = 16000) -> Iterator[Dict]:
    """Each item with its first channel, resampled to target_sr, as float32
    "speech"; an item whose wav cannot be read is skipped (logged)."""
    for item in stream:
        try:
            sr, wav = read_wav(item["wav"])
        except (OSError, struct.error, ValueError) as e:
            logging.warning("streaming: skipping %s (%s)", item.get("key"), e)
            continue
        if wav.ndim == 2:
            wav = wav[:, 0]
        if sr != target_sr:
            wav = resample(wav, sr, target_sr)
        yield {**item, "speech": wav.astype(np.float32), "sample_rate": target_sr}


def filter_by_length(stream: Iterator[Dict], min_length: int = 0, max_length: int = 10**9,
                     name: str = "speech") -> Iterator[Dict]:
    for item in stream:
        if min_length <= len(item[name]) <= max_length:
            yield item


def apply_preprocess(stream: Iterator[Dict], preprocess: Callable) -> Iterator[Dict]:
    """preprocess(key, data) over each item's data (all but key, wav and sample_rate)."""
    for item in stream:
        data = {k: v for k, v in item.items() if k not in ("key", "wav", "sample_rate")}
        yield {**item, **preprocess(item["key"], data)}


def shuffle_buffer(stream: Iterator[Dict], buffer_size: int = 1024, seed: int = 0) -> Iterator[Dict]:
    """A shuffle through a buffer of `buffer_size` items (RandomState(seed))."""
    rng = np.random.RandomState(seed)
    buf: List[Dict] = []
    for item in stream:
        buf.append(item)
        if len(buf) >= buffer_size:
            i = rng.randint(len(buf))
            buf[i], buf[-1] = buf[-1], buf[i]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def sort_buffer(stream: Iterator[Dict], buffer_size: int = 512, name: str = "speech") -> Iterator[Dict]:
    """Each run of `buffer_size` items sorted by length."""
    buf: List[Dict] = []
    for item in stream:
        buf.append(item)
        if len(buf) >= buffer_size:
            buf.sort(key=lambda it: len(it[name]))
            yield from buf
            buf = []
    buf.sort(key=lambda it: len(it[name]))
    yield from buf


def batch(stream: Iterator[Dict], batch_size: int, name: str = "speech"):
    """(keys, {name: (B, T) zero-padded, name_lengths}) batches; the last may be short."""
    buf: List[Dict] = []
    for item in stream:
        buf.append(item)
        if len(buf) == batch_size:
            yield _collate(buf, name)
            buf = []
    if buf:
        yield _collate(buf, name)


def _collate(items: List[Dict], name: str):
    keys = [it["key"] for it in items]
    lengths = np.array([len(it[name]) for it in items], np.int64)
    max_len = int(lengths.max())
    arr = np.stack([np.pad(it[name], (0, max_len - len(it[name]))) for it in items])
    return keys, {name: arr, f"{name}_lengths": lengths}


class LargeDataLoader:
    """The composed streaming loader (build_dataloader.py:66-95):
    ``build_iter(epoch)`` parses the lists, shuffles through a buffer seeded
    with seed + epoch, loads and resamples, filters by length, preprocesses,
    sorts through a buffer and batches (no shuffle: list order, no sort)."""

    def __init__(
        self,
        data_list_files: Sequence[str],
        batch_size: int = 16,
        target_sr: int = 16000,
        min_length: int = 0,
        max_length: int = 10**9,
        shuffle: bool = True,
        shuffle_buffer_size: int = 1024,
        sort_buffer_size: int = 512,
        preprocess: Optional[Callable] = None,
        seed: int = 0,
    ):
        self.files = list(data_list_files)
        self.kw = dict(
            batch_size=batch_size, target_sr=target_sr, min_length=min_length,
            max_length=max_length, shuffle=shuffle,
            shuffle_buffer_size=shuffle_buffer_size,
            sort_buffer_size=sort_buffer_size, preprocess=preprocess, seed=seed,
        )

    def build_iter(self, epoch: int = 0):
        kw = self.kw
        stream = parse_list(self.files)
        if kw["shuffle"]:
            stream = shuffle_buffer(stream, kw["shuffle_buffer_size"], kw["seed"] + epoch)
        stream = load_audio(stream, kw["target_sr"])
        stream = filter_by_length(stream, kw["min_length"], kw["max_length"])
        if kw["preprocess"] is not None:
            stream = apply_preprocess(stream, kw["preprocess"])
        if kw["shuffle"]:
            stream = sort_buffer(stream, kw["sort_buffer_size"])
        return batch(stream, kw["batch_size"])
