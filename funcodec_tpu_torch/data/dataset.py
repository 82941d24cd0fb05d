"""Map-style dataset joining kaldi-style sources by utterance id (port of
funcodec_tpu/data/dataset.py; items stay numpy, as there).

Behavioral reference: funcodec/datasets/dataset.py (DATA_TYPES registry
:149-257, ESPnetDataset :274-454) and collate_fn.py (CommonCollateFn :16-95:
pad to max length, emit *_lengths companions).
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from funcodec_tpu_torch.data.kaldi_ark import ArkScpReader
from funcodec_tpu_torch.data.wav_io import SoundScpReader, read_2column_text


class _SoundSource:
    def __init__(self, path):
        self.reader = SoundScpReader(path)

    def keys(self):
        return self.reader.keys()

    def __getitem__(self, key):
        _sr, wav = self.reader[key]
        return wav

class _ArkSource:
    def __init__(self, path):
        self.reader = ArkScpReader(path)

    def keys(self):
        return self.reader.keys()

    def __getitem__(self, key):
        return self.reader[key]


class _NpySource:
    def __init__(self, path):
        self.data = read_2column_text(path)

    def keys(self):
        return self.data.keys()

    def __getitem__(self, key):
        return np.load(self.data[key])


class _TextSource:
    def __init__(self, path, parser=None):
        self.data = read_2column_text(path)
        self.parser = parser

    def keys(self):
        return self.data.keys()

    def __getitem__(self, key):
        v = self.data[key]
        return self.parser(v) if self.parser else v


def _parse_text_int(v):
    return np.array([int(x) for x in v.split()], dtype=np.int64)


def _parse_text_float(v):
    return np.array([float(x) for x in v.split()], dtype=np.float32)


def _parse_codec_json(v):
    arr = np.array(json.loads(v))
    if arr.ndim == 3:
        arr = arr[0]
    return arr.T  # (T, n_q)


class _Hdf5Source:
    """hdf5 data type (dataset.py:149-257): one h5 file, uttid-keyed datasets.
    h5py is imported here, when an hdf5 source is built, not with the module."""

    def __init__(self, path):
        import h5py

        self.file = h5py.File(path, "r")

    def keys(self):
        return self.file.keys()

    def __getitem__(self, key):
        return self.file[key][()]


class _RandSource:
    """rand_float / rand_int_L_H debug sources (fileio/rand_gen_dataset.py:11-66):
    a shape file `utt 123,83` yields random arrays of that shape."""

    def __init__(self, path: str, dtype, low: int = 0, high: int = 1):
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(maxsplit=1)
                if len(parts) == 2:
                    self.shapes[parts[0]] = tuple(
                        int(x) for x in parts[1].split(",")
                    )
        self.dtype = np.dtype(dtype)
        self.low, self.high = low, high

    def keys(self):
        return self.shapes.keys()

    def __getitem__(self, key):
        shape = self.shapes[key]
        if self.dtype.kind == "f":
            return np.random.randn(*shape).astype(self.dtype)
        return np.random.randint(self.low, self.high, size=shape).astype(self.dtype)


def resolve_data_type(typ: str) -> Callable[[str], Any]:
    """DATA_TYPES lookup with the reference's regex entry rand_int_\\d+_\\d+
    (dataset.py:245-252)."""
    if typ in DATA_TYPES:
        return DATA_TYPES[typ]
    m = re.fullmatch(r"rand_int_(\d+)_(\d+)", typ)
    if m:
        low, high = int(m.group(1)), int(m.group(2))
        return lambda p: _RandSource(p, np.int64, low, high)
    raise ValueError(f"unsupported data type {typ}")


DATA_TYPES: Dict[str, Callable[[str], Any]] = {
    "sound": _SoundSource,
    "rand_float": lambda p: _RandSource(p, np.float32),
    "kaldi_ark": _ArkSource,
    "npy": _NpySource,
    "hdf5": _Hdf5Source,
    "text": lambda p: _TextSource(p),
    "text_int": lambda p: _TextSource(p, _parse_text_int),
    "text_float": lambda p: _TextSource(p, _parse_text_float),
    "csv_int": lambda p: _TextSource(
        p, lambda v: np.array([int(x) for x in v.split(",")], np.int64)
    ),
    "csv_float": lambda p: _TextSource(
        p, lambda v: np.array([float(x) for x in v.split(",")], np.float32)
    ),
    "codec_json": lambda p: _TextSource(p, _parse_codec_json),
}


class CodecDataset:
    """Join N (path, name, type) sources by uttid (dataset.py:274-454)."""

    def __init__(
        self,
        path_name_type_list: Sequence[Tuple[str, str, str]],
        preprocess: Optional[Callable[[str, Dict], Dict]] = None,
    ):
        assert path_name_type_list
        self.sources: Dict[str, Any] = {}
        for path, name, typ in path_name_type_list:
            self.sources[name] = resolve_data_type(typ)(path)
        self.preprocess = preprocess
        first = next(iter(self.sources.values()))
        keys = set(first.keys())
        for src in self.sources.values():
            keys &= set(src.keys())
        self.uttids: List[str] = sorted(keys)

    def __len__(self):
        return len(self.uttids)

    def names(self):
        return list(self.sources.keys())

    def __getitem__(self, uid_or_idx) -> Tuple[str, Dict[str, np.ndarray]]:
        uid = (
            self.uttids[uid_or_idx] if isinstance(uid_or_idx, int) else uid_or_idx
        )
        data = {name: src[uid] for name, src in self.sources.items()}
        if self.preprocess is not None:
            data = self.preprocess(uid, data)
        return uid, data

    def raw_item(self, uid_or_idx) -> Tuple[str, Dict[str, np.ndarray]]:
        """Item WITHOUT preprocessing: the device cache (data/device_cache.py)
        stages full utterances and crops them on the card."""
        uid = (
            self.uttids[uid_or_idx] if isinstance(uid_or_idx, int) else uid_or_idx
        )
        return uid, {name: src[uid] for name, src in self.sources.items()}


def collate_fn(
    batch: Sequence[Tuple[str, Dict[str, np.ndarray]]],
    float_pad_value: float = 0.0,
    int_pad_value: int = -32768,
    pad_mode: str = "constant",
) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """CommonCollateFn (collate_fn.py:16-95): pad to max-T, add *_lengths."""
    keys = [k for k, _ in batch]
    names = batch[0][1].keys()
    out: Dict[str, np.ndarray] = {}
    for name in names:
        arrays = [d[name] for _, d in batch]
        if isinstance(arrays[0], str):
            out[name] = arrays  # raw passthrough (collate_fn.py:60-64)
            continue
        lengths = np.array([a.shape[0] for a in arrays], dtype=np.int64)
        max_len = int(lengths.max())
        pad_value = (
            int_pad_value if arrays[0].dtype.kind == "i" else float_pad_value
        )
        padded = []
        for a in arrays:
            pad = max_len - a.shape[0]
            if pad > 0:
                widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
                if pad_mode == "wrap":
                    a = np.pad(a, widths, mode="wrap")
                else:
                    a = np.pad(a, widths, constant_values=pad_value)
            padded.append(a)
        out[name] = np.stack(padded)
        out[f"{name}_lengths"] = lengths
    return keys, out
