"""The JAX package's checkpoint format, read and written without flax.

funcodec_tpu/train/checkpoint.py writes every weights file and train state
with ``flax.serialization.to_bytes``: msgpack with three extension types.
This module is the port's copy of that format, in ``struct`` and numpy:

- ``restore(data)`` gives what ``flax.serialization.msgpack_restore`` gives:
  nested dicts (a JAX list, tuple, namedtuple or struct dataclass is a map
  keyed "0".."n-1" or by field name), numpy arrays (read-only views of
  `data`), numpy scalars, Python scalars, str, bytes and None. Leaves whose
  dtype numpy lacks (``bfloat16``, the float8 types) come back as torch
  tensors of that dtype.
- ``to_bytes(tree)`` gives the bytes of ``flax.serialization.to_bytes`` for
  the same tree: dicts in insertion order, lists and tuples as index-keyed
  maps, namedtuples and dataclasses by field (a field with
  ``metadata["pytree_node"] = False`` left out, as flax's struct does),
  arrays (numpy, torch, or anything with ``__array__``) as ext 1, numpy
  scalars as ext 3, complex as ext 2, Python floats as float64, every
  header its shortest form.

The extension types: ext 1 is an array, a msgpack ``(shape, dtype name,
C-order bytes)``; ext 2 a complex ``(real, imag)``; ext 3 a numpy scalar
stored as a 0-d array. An array of more than ``MAX_CHUNK_SIZE`` bytes is
stored as ``{"__msgpack_chunked_array__": True, "shape": {"0": ..},
"chunks": {"0": ..}}`` of flat pieces, and ``restore`` joins it again.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, List

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax's: msgpack holds at most 2**31 - 1 bytes in one object
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
# dtypes that numpy lacks (ml_dtypes' in JAX): their bytes as an integer type of the same width
TORCH_ONLY = {"bfloat16": (torch.bfloat16, torch.int16, np.int16),
              "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.int8),
              "float8_e5m2": (torch.float8_e5m2, torch.int8, np.int8)}
_TORCH_NAMES = {v[0]: k for k, v in TORCH_ONLY.items()}


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Array:
    """An array leaf: its dtype's name, shape and a C-contiguous numpy array
    holding its bytes."""

    name: str
    shape: tuple
    data: np.ndarray

    @property
    def nbytes(self) -> int:
        return self.data.size * self.data.dtype.itemsize


def _array(x) -> _Array:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype in _TORCH_NAMES:
            name = _TORCH_NAMES[x.dtype]
            return _Array(name, tuple(x.shape), np.ascontiguousarray(x.contiguous().view(TORCH_ONLY[name][1]).numpy()))
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes do not serialize")
    return _Array(x.dtype.name, x.shape, np.ascontiguousarray(x))


def _chunked(a: _Array) -> dict:
    """flax's _chunk: flat pieces of MAX_CHUNK_SIZE bytes at most."""
    size = max(1, int(MAX_CHUNK_SIZE / a.data.dtype.itemsize))
    flat = a.data.reshape(-1)
    chunks = [_Array(a.name, (len(flat[i:i + size]),), flat[i:i + size]) for i in range(0, flat.size, size)]
    return {CHUNKED: True, "shape": {str(i): int(n) for i, n in enumerate(a.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _state_dict(x) -> Any:
    """flax's to_state_dict, then its array leaves as _Array (chunked where large)."""
    if isinstance(x, dict):
        return {str(k): _state_dict(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _state_dict(getattr(x, k)) for k in x._fields}
    if isinstance(x, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(x)}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _state_dict(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.metadata.get("pytree_node", True)}
    if x is None or type(x) in (bool, int, float, complex, str, bytes) or isinstance(x, np.generic):
        return x
    if isinstance(x, (np.ndarray, torch.Tensor)) or hasattr(x, "__array__"):
        a = _array(x)
        return _chunked(a) if a.nbytes > MAX_CHUNK_SIZE else a
    raise TypeError(f"can not serialize {type(x).__name__}")


def _sized(out: List[bytes], n: int, fix: int, fix_max: int, codes: tuple) -> None:
    """A length header: the fix form below fix_max, else the 8/16/32-bit one
    (codes: the 8-bit code, or None where the type has none)."""
    if n < fix_max:
        out.append(bytes([fix | n]))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"a msgpack object of {n} elements or bytes")


def _bin_header(out: List[bytes], n: int) -> None:
    _sized(out, n, 0, 0, (0xC4, 0xC5, 0xC6))


def _ext(out: List[bytes], code: int, payload: List[bytes]) -> None:
    n = sum(len(p) for p in payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack(">Bb", fixed[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.extend(payload)


def _array_payload(a: _Array) -> List[bytes]:
    """The ext 1 payload: msgpack (shape, name, bytes)."""
    head: List[bytes] = [b"\x93"]
    _sized(head, len(a.shape), 0x90, 16, (None, 0xDC, 0xDD))
    for n in a.shape:
        _pack(int(n), head)
    _pack(a.name, head)
    data = a.data.tobytes("C")
    _bin_header(head, len(data))
    return [b"".join(head), data]


def _pack(x, out: List[bytes]) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        if -32 <= x < 128:
            out.append(struct.pack(">b", x) if x < 0 else bytes([x]))
        elif x >= 0:
            for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF), (0xCE, ">BI", 0xFFFFFFFF),
                                   (0xCF, ">BQ", 2**64 - 1)):
                if x <= top:
                    out.append(struct.pack(fmt, code, x))
                    break
            else:
                raise OverflowError("Integer value out of range")
        else:
            for code, fmt, low in ((0xD0, ">Bb", -(2**7)), (0xD1, ">Bh", -(2**15)), (0xD2, ">Bi", -(2**31)),
                                   (0xD3, ">Bq", -(2**63))):
                if x >= low:
                    out.append(struct.pack(fmt, code, x))
                    break
            else:
                raise OverflowError("Integer value out of range")
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif type(x) is str:
        b = x.encode("utf-8")
        _sized(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(b)
    elif type(x) is bytes:
        _bin_header(out, len(x))
        out.append(x)
    elif type(x) is dict:
        _sized(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, _Array):
        _ext(out, EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _ext(out, EXT_NPSCALAR, _array_payload(_array(np.asarray(x))))
    elif type(x) is complex:
        _ext(out, EXT_COMPLEX, [b"\x92", struct.pack(">Bd", 0xCB, x.real), struct.pack(">Bd", 0xCB, x.imag)])
    else:
        raise TypeError(f"can not serialize {type(x).__name__}")


def to_bytes(tree) -> bytes:
    """The bytes flax.serialization.to_bytes writes for `tree`."""
    out: List[bytes] = []
    _pack(_state_dict(tree), out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _dtype_array(buf, name: str, shape):
    """An array of dtype `name` over `buf` (no copy for numpy dtypes)."""
    if name in TORCH_ONLY:
        dtype, _, raw = TORCH_ONLY[name]
        return torch.from_numpy(np.frombuffer(buf, dtype=raw).reshape(shape).copy()).view(dtype)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


class _Reader:
    """msgpack's unpacker over a memoryview: a bin is a view of it (inside an
    ext) or a bytes copy (in the tree)."""

    def __init__(self, view: memoryview, bin_as_view: bool = False):
        self.view, self.pos, self.bin_as_view = view, 0, bin_as_view

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.view):
            raise ValueError(f"truncated: {n} bytes wanted at offset {self.pos} of {len(self.view)}")
        out = self.view[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def bin(self, n: int):
        v = self.take(n)
        return v if self.bin_as_view else bytes(v)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if CHUNKED in out:
            return _unchunk(out)
        return out

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.map(b & 0x0F)
        if b < 0xA0:
            return [self.read() for _ in range(b & 0x0F)]
        if b < 0xC0:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("B", self.bin), 0xC5: (">H", self.bin), 0xC6: (">I", self.bin),
                 0xD9: ("B", self.str), 0xDA: (">H", self.str), 0xDB: (">I", self.str),
                 0xDC: (">H", lambda n: [self.read() for _ in range(n)]),
                 0xDD: (">I", lambda n: [self.read() for _ in range(n)]),
                 0xDE: (">H", self.map), 0xDF: (">I", self.map)}
        if b in sized:
            fmt, fn = sized[b]
            return fn(self.unpack(fmt))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        ext = {0xC7: "B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            n = self.unpack(ext[b])
        elif 0xD4 <= b <= 0xD8:
            n = 1 << (b - 0xD4)
        else:
            raise ValueError(f"msgpack code 0x{b:02x} at offset {self.pos - 1}")
        code = self.unpack("b")
        return _ext_value(code, self.take(n))


def _ndarray(payload: memoryview):
    r = _Reader(payload, bin_as_view=True)
    fields = r.read()
    if not (isinstance(fields, list) and len(fields) == 3) or r.pos != len(payload):
        raise ValueError("an ndarray extension that is not (shape, dtype, bytes)")
    shape, name, buf = fields
    name = str(name, "ascii") if isinstance(name, (bytes, memoryview)) else name
    return _dtype_array(buf, name, tuple(shape))


def _ext_value(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == EXT_COMPLEX:
        re, im = _Reader(payload).read()
        return complex(re, im)
    raise ValueError(f"msgpack extension type {code}")


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def restore(data) -> Any:
    """The tree of a flax msgpack file's bytes (flax.serialization.msgpack_restore).

    Raises ValueError on bytes that are not one whole msgpack object of
    this format."""
    view = memoryview(data).cast("B")
    r = _Reader(view)
    try:
        tree = r.read()
    except (ValueError, TypeError, KeyError, IndexError, struct.error, UnicodeDecodeError) as e:
        raise ValueError(f"not a flax msgpack file: {e}") from None
    if r.pos != len(view):
        raise ValueError(f"not a flax msgpack file: {len(view) - r.pos} bytes after the object")
    return tree
