"""Kaldi binary ark/scp matrix I/O (kaldiio-compatible subset).

The port's own copy of funcodec_tpu/data/kaldi_ark.py (numpy only), so that
the port imports nothing of the JAX package; the two write the same bytes.

The reference writes codec indices and embeddings with
kaldiio.WriteHelper("ark,scp,f:...") (funcodec/bin/codec_inference.py:277-286)
and reads them back through kaldi_ark loaders (funcodec/datasets/dataset.py,
funcodec/fileio/codec_loader.py:6-40). This module implements the binary
float/double matrix format those paths use:

  <key> <space> \\0B FM \\x04<rows:int32> \\x04<cols:int32> <row-major data>

(FM = float32 matrix, DM = float64). The scp line is "<key> <path>:<offset>"
with offset pointing at the \\0B marker.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Iterator, Optional, Union

import numpy as np

from funcodec_tpu_torch.data.wav_io import read_2column_text


def _read_token(f) -> bytes:
    tok = b""
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok += c
    return tok


def read_matrix_at(f) -> np.ndarray:
    """Read one binary kaldi matrix/vector at the current position (post-key)."""
    binmark = f.read(2)
    if binmark != b"\0B":
        raise ValueError(f"expected binary marker, got {binmark!r}")
    tok = _read_token(f)
    if tok in (b"FM", b"DM"):
        dtype = "<f4" if tok == b"FM" else "<f8"
        sizes = []
        for _ in range(2):
            (b,) = struct.unpack("<b", f.read(1))
            assert b == 4
            sizes.append(struct.unpack("<i", f.read(4))[0])
        rows, cols = sizes
        data = np.frombuffer(f.read(rows * cols * int(dtype[-1])), dtype)
        return data.reshape(rows, cols).astype(np.float32 if tok == b"FM" else np.float64)
    if tok in (b"FV", b"DV"):
        dtype = "<f4" if tok == b"FV" else "<f8"
        (b,) = struct.unpack("<b", f.read(1))
        assert b == 4
        (n,) = struct.unpack("<i", f.read(4))
        return np.frombuffer(f.read(n * int(dtype[-1])), dtype).copy()
    raise ValueError(f"unsupported kaldi token {tok!r}")


def load_ark(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Sequentially read a whole binary ark file."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        while True:
            key = _read_token(f)
            if not key:
                break
            out[key.decode()] = read_matrix_at(f)
    return out


def load_scp_entry(rxspecifier: str) -> np.ndarray:
    """Read one matrix from 'path:offset'."""
    path, _, offset = rxspecifier.rpartition(":")
    with open(path, "rb") as f:
        f.seek(int(offset))
        return read_matrix_at(f)


class ArkScpReader:
    """uttid -> matrix via an scp index file."""

    def __init__(self, scp_path: Union[str, Path]):
        self.data = read_2column_text(scp_path)

    def __getitem__(self, key: str) -> np.ndarray:
        return load_scp_entry(self.data[key])

    def keys(self):
        return self.data.keys()

    def __iter__(self) -> Iterator[str]:
        return iter(self.data)

    def __len__(self):
        return len(self.data)


class ArkWriter:
    """kaldiio WriteHelper("ark,scp,f:x.ark,x.scp") equivalent."""

    def __init__(self, ark_path: Union[str, Path], scp_path: Optional[Union[str, Path]] = None):
        self.ark_path = str(ark_path)
        self.ark_f = open(ark_path, "wb")
        self.scp_f = open(scp_path, "wt") if scp_path else None

    def __call__(self, key: str, mat: np.ndarray) -> None:
        mat = np.asarray(mat)
        if mat.dtype != np.float32:
            mat = mat.astype(np.float32)
        assert mat.ndim == 2, mat.shape
        self.ark_f.write(key.encode() + b" ")
        offset = self.ark_f.tell()
        self.ark_f.write(b"\0B")
        self.ark_f.write(b"FM ")
        self.ark_f.write(struct.pack("<bi", 4, mat.shape[0]))
        self.ark_f.write(struct.pack("<bi", 4, mat.shape[1]))
        self.ark_f.write(mat.tobytes())
        self.ark_f.flush()
        if self.scp_f:
            self.scp_f.write(f"{key} {self.ark_path}:{offset}\n")
            self.scp_f.flush()

    def close(self):
        self.ark_f.close()
        if self.scp_f:
            self.scp_f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def load_codec_ark_matrix(mat: np.ndarray, n_q: int = 32) -> np.ndarray:
    """Reference CodecLoader reshape (fileio/codec_loader.py:6-40): a flat
    (n_q*k, T) ark matrix -> (T, n_q) int codes (k frames concatenated)."""
    # written as to_write = concat([x[:, b, :T].T for frames], axis=0) ->
    # (T, n_q) already when one frame; ark stores (T, n_q)
    if mat.ndim == 2 and mat.shape[1] == n_q:
        return mat.astype(np.int64)
    return mat.reshape(-1, n_q).astype(np.int64)
