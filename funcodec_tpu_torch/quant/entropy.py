"""Entropy coding: arithmetic coder and raw bitstream packing, the .ecdc format (port of funcodec_tpu/quant/entropy.py).

Behavioral reference: funcodec/modules/quantization/ac.py (cdf :18-53,
ArithmeticCoder :56-167, ArithmeticDecoder :169-259) and binary.py (BitPacker
/BitUnpacker :56-126, ECDC header :24-53).

The reference's BitPacker.push (binary.py:75-77) routes every value through
a float32 bit-cast, which corrupts a packed stream; the JAX package packs
integers as upstream EnCodec does, and so does this copy, so that both write
the same bytes. The header's metadata keeps the JAX package's format tag,
``"m": "funcodec_tpu"``: a stream from either package reads in the other.

Host-side Python and numpy, as in the JAX package: serialization, not a
device stage. ``compress_tokens`` takes a numpy array or a tensor on any
device.
"""

from __future__ import annotations

import io
import json
import math
import struct
from typing import IO, Any, Optional

import numpy as np

_ecdc_header_struct = struct.Struct("!4sBI")
_ECDC_MAGIC = b"ECDC"


def write_ecdc_header(fo: IO[bytes], metadata: Any) -> None:
    meta = json.dumps(metadata).encode("utf-8")
    fo.write(_ecdc_header_struct.pack(_ECDC_MAGIC, 0, len(meta)))
    fo.write(meta)
    fo.flush()


def _read_exactly(fo: IO[bytes], size: int) -> bytes:
    buf = b""
    while len(buf) < size:
        new = fo.read(size - len(buf))
        if not new:
            raise EOFError(f"{size - len(buf)} bytes remaining")
        buf += new
    return buf


def read_ecdc_header(fo: IO[bytes]):
    magic, version, meta_size = _ecdc_header_struct.unpack(
        _read_exactly(fo, _ecdc_header_struct.size)
    )
    if magic != _ECDC_MAGIC:
        raise ValueError("File is not in ECDC format.")
    if version != 0:
        raise ValueError("Version not supported.")
    return json.loads(_read_exactly(fo, meta_size).decode("utf-8"))


class BitPacker:
    """Pack ints of arbitrary bit width into bytes (binary.py:56-92)."""

    def __init__(self, bits: int, fo: IO[bytes]):
        self._current_value = 0
        self._current_bits = 0
        self.bits = bits
        self.fo = fo

    def push(self, value: int) -> None:
        self._current_value += value << self._current_bits
        self._current_bits += self.bits
        while self._current_bits >= 8:
            self.fo.write(bytes([self._current_value & 0xFF]))
            self._current_bits -= 8
            self._current_value >>= 8

    def flush(self) -> None:
        if self._current_bits:
            self.fo.write(bytes([self._current_value]))
            self._current_value = 0
            self._current_bits = 0
        self.fo.flush()


class BitUnpacker:
    """Inverse of BitPacker (binary.py:95-126)."""

    def __init__(self, bits: int, fo: IO[bytes]):
        self.bits = bits
        self.fo = fo
        self._mask = (1 << bits) - 1
        self._current_value = 0
        self._current_bits = 0

    def pull(self) -> Optional[int]:
        while self._current_bits < self.bits:
            buf = self.fo.read(1)
            if not buf:
                return None
            self._current_value += buf[0] << self._current_bits
            self._current_bits += 8
        out = self._current_value & self._mask
        self._current_value >>= self.bits
        self._current_bits -= self.bits
        return out


def build_stable_quantized_cdf(
    pdf: np.ndarray,
    total_range_bits: int,
    roundoff: float = 1e-8,
    min_range: int = 2,
    check: bool = True,
) -> np.ndarray:
    """PDF -> quantized CDF over [0, 2**total_range_bits) (ac.py:18-53)."""
    pdf = np.asarray(pdf, np.float64)
    if roundoff:
        pdf = np.floor(pdf / roundoff) * roundoff
    total_range = 2**total_range_bits
    cardinality = len(pdf)
    alpha = min_range * cardinality / total_range
    assert alpha <= 1, "you must reduce min_range"
    ranges = np.floor(((1 - alpha) * total_range) * pdf).astype(np.int64)
    ranges += min_range
    quantized_cdf = np.cumsum(ranges)
    if min_range < 2:
        raise ValueError("min_range must be at least 2.")
    if check:
        assert quantized_cdf[-1] <= total_range, quantized_cdf[-1]
        if (np.diff(quantized_cdf) < min_range).any() or quantized_cdf[0] < min_range:
            raise ValueError("You must increase your total_range_bits.")
    return quantized_cdf


class ArithmeticCoder:
    """Range coder over per-step quantized CDFs (ac.py:56-167)."""

    def __init__(self, fo: IO[bytes], total_range_bits: int = 24):
        assert total_range_bits <= 30
        self.total_range_bits = total_range_bits
        self.packer = BitPacker(bits=1, fo=fo)
        self.low = 0
        self.high = 0
        self.max_bit = -1

    @property
    def delta(self) -> int:
        return self.high - self.low + 1

    def _flush_common_prefix(self) -> None:
        while self.max_bit >= 0:
            b1 = self.low >> self.max_bit
            b2 = self.high >> self.max_bit
            if b1 == b2:
                self.low -= b1 << self.max_bit
                self.high -= b1 << self.max_bit
                self.max_bit -= 1
                self.packer.push(b1)
            else:
                break

    def push(self, symbol: int, quantized_cdf: np.ndarray) -> None:
        while self.delta < 2**self.total_range_bits:
            self.low *= 2
            self.high = self.high * 2 + 1
            self.max_bit += 1
        range_low = 0 if symbol == 0 else int(quantized_cdf[symbol - 1])
        range_high = int(quantized_cdf[symbol]) - 1
        effective_low = int(
            math.ceil(range_low * (self.delta / (2**self.total_range_bits)))
        )
        effective_high = int(
            math.floor(range_high * (self.delta / (2**self.total_range_bits)))
        )
        self.high = self.low + effective_high
        self.low = self.low + effective_low
        assert self.low <= self.high
        self._flush_common_prefix()

    def flush(self) -> None:
        while self.max_bit >= 0:
            self.packer.push((self.low >> self.max_bit) & 1)
            self.max_bit -= 1
        self.packer.flush()


class ArithmeticDecoder:
    """Inverse of ArithmeticCoder (ac.py:169-259)."""

    def __init__(self, fo: IO[bytes], total_range_bits: int = 24):
        self.total_range_bits = total_range_bits
        self.low = 0
        self.high = 0
        self.current = 0
        self.max_bit = -1
        self.unpacker = BitUnpacker(bits=1, fo=fo)

    @property
    def delta(self) -> int:
        return self.high - self.low + 1

    def _flush_common_prefix(self) -> None:
        while self.max_bit >= 0:
            b1 = self.low >> self.max_bit
            b2 = self.high >> self.max_bit
            if b1 == b2:
                self.low -= b1 << self.max_bit
                self.high -= b1 << self.max_bit
                self.current -= b1 << self.max_bit
                self.max_bit -= 1
            else:
                break

    def pull(self, quantized_cdf: np.ndarray) -> Optional[int]:
        while self.delta < 2**self.total_range_bits:
            bit = self.unpacker.pull()
            if bit is None:
                return None
            self.low *= 2
            self.high = self.high * 2 + 1
            self.current = self.current * 2 + bit
            self.max_bit += 1

        def bin_search(low_idx: int, high_idx: int):
            if high_idx < low_idx:
                raise RuntimeError("Binary search failed")
            mid = (low_idx + high_idx) // 2
            range_low = int(quantized_cdf[mid - 1]) if mid > 0 else 0
            range_high = int(quantized_cdf[mid]) - 1
            effective_low = int(
                math.ceil(range_low * (self.delta / (2**self.total_range_bits)))
            )
            effective_high = int(
                math.floor(range_high * (self.delta / (2**self.total_range_bits)))
            )
            low = effective_low + self.low
            high = effective_high + self.low
            if self.current >= low:
                if self.current <= high:
                    return mid, low, high
                return bin_search(mid + 1, high_idx)
            return bin_search(low_idx, mid - 1)

        sym, self.low, self.high = bin_search(0, len(quantized_cdf) - 1)
        self._flush_common_prefix()
        return sym


# ---------------------------------------------------------------------------
# token-stream (de)compression convenience
# ---------------------------------------------------------------------------


def compress_tokens(
    tokens,  # (T, n_q) int codes: a numpy array or a tensor on any device
    codebook_size: int,
    sample_rate: int,
    hop_length: int,
    use_arithmetic: bool = True,
) -> bytes:
    """Serialize codec tokens to an .ecdc byte string.

    With `use_arithmetic`, a uniform-pdf range coder is used (lossless,
    ~log2(bins) bits/token); otherwise raw ceil(log2(bins))-bit packing.
    """
    if hasattr(tokens, "detach"):
        tokens = tokens.detach().cpu().numpy()
    tokens = np.asarray(tokens, np.int64)
    fo = io.BytesIO()
    metadata = {
        "m": "funcodec_tpu",
        "sr": sample_rate,
        "hop": hop_length,
        "t": int(tokens.shape[0]),
        "nq": int(tokens.shape[1]),
        "bins": int(codebook_size),
        "ac": bool(use_arithmetic),
    }
    write_ecdc_header(fo, metadata)
    if use_arithmetic:
        coder = ArithmeticCoder(fo)
        pdf = np.full((codebook_size,), 1.0 / codebook_size)
        cdf = build_stable_quantized_cdf(pdf, coder.total_range_bits, check=False)
        for frame in tokens:
            for sym in frame:
                coder.push(int(sym), cdf)
        coder.flush()
    else:
        packer = BitPacker(int(math.ceil(math.log2(codebook_size))), fo)
        for frame in tokens:
            for sym in frame:
                packer.push(int(sym))
        packer.flush()
    return fo.getvalue()


def decompress_tokens(data: bytes) -> np.ndarray:
    """Inverse of compress_tokens -> (T, n_q) int64 codes."""
    fo = io.BytesIO(data)
    meta = read_ecdc_header(fo)
    T, nq, bins = meta["t"], meta["nq"], meta["bins"]
    out = np.zeros((T, nq), np.int64)
    if meta["ac"]:
        decoder = ArithmeticDecoder(fo)
        pdf = np.full((bins,), 1.0 / bins)
        cdf = build_stable_quantized_cdf(pdf, decoder.total_range_bits, check=False)
        for t in range(T):
            for q in range(nq):
                sym = decoder.pull(cdf)
                assert sym is not None, "stream exhausted early"
                out[t, q] = sym
    else:
        unpacker = BitUnpacker(int(math.ceil(math.log2(bins))), fo)
        for t in range(T):
            for q in range(nq):
                sym = unpacker.pull()
                assert sym is not None
                out[t, q] = sym
    return out
