"""WAV file I/O and resampling (no soundfile/torchaudio dependency).

The port's own copy of funcodec_tpu/data/wav_io.py (numpy and scipy only),
so that the port imports nothing of the JAX package; the two write the same
bytes.

Behavioral reference: funcodec/fileio/sound_scp.py (SoundScpReader/Writer)
and save_audio (funcodec/bin/codec_inference.py:153-161: peak-rescale to
0.99, PCM_S 16-bit).

Supports PCM 16/24/32-bit and IEEE float RIFF/WAVE, mono or multichannel.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np


def read_wav(path: Union[str, Path], normalize: bool = True) -> Tuple[int, np.ndarray]:
    """Read a WAV file -> (sample_rate, float32 array (T,) or (T, C) in [-1, 1]).

    normalize=False returns 16-bit PCM data as raw int16 (other formats still
    come back normalized float32). The serving pipeline uses this to ship
    int16 to the device and dequantize there: x/32768 in fp32 is exact, and
    the host->device transfer is half the bytes."""
    with open(path, "rb") as f:
        return read_wav_fileobj(f, name=str(path), normalize=normalize)


def read_wav_fileobj(
    f, name: str = "<fileobj>", normalize: bool = True
) -> Tuple[int, np.ndarray]:
    """Parse one RIFF/WAVE stream at the current position. Reading is bounded
    by the RIFF size field so a WAV embedded inside a kaldi wav ark (kaldiio
    WriteHelper((rate, int16)) entries) stops at the record boundary."""
    riff, size, wave = struct.unpack("<4sI4s", f.read(12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise ValueError(f"{name}: not a RIFF/WAVE stream")
    remaining = size - 4  # bytes after the WAVE tag
    fmt = None
    data = None
    while remaining >= 8:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        remaining -= 8
        chunk_id, chunk_size = struct.unpack("<4sI", hdr)
        pad = chunk_size % 2
        remaining -= chunk_size + pad
        if chunk_id == b"fmt ":
            fmt = f.read(chunk_size + pad)[:chunk_size]
        elif chunk_id == b"data":
            data = f.read(chunk_size + pad)[:chunk_size]
        else:
            f.seek(chunk_size + pad, 1)
    if fmt is None or data is None:
        raise ValueError(f"{name}: missing fmt/data chunk")
    audio_format, channels, sr, _br, _ba, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 1:  # PCM
        if bits == 16:
            if not normalize:
                x = np.frombuffer(data, "<i2")
                if channels > 1:
                    x = x.reshape(-1, channels)
                return sr, x
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            ints = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            x = ints.astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{name}: unsupported PCM bits {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(data, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"{name}: unsupported format code {audio_format}")

    if channels > 1:
        x = x.reshape(-1, channels)
    return sr, x


def peek_wav_info(path: Union[str, Path]) -> Optional[Tuple[int, int, int]]:
    """Header-only scan -> (sample_rate, n_samples, channels), or None if the
    file is not a parseable plain WAV.

    Lets the serving pipeline build its length-sorted batch plan from RIFF
    headers (~100 bytes/file) instead of decoding the whole corpus before the
    first device dispatch (cli/codec_inference.py batch planning)."""
    try:
        with open(path, "rb") as f:
            riff, size, wave_tag = struct.unpack("<4sI4s", f.read(12))
            if riff != b"RIFF" or wave_tag != b"WAVE":
                return None
            remaining = size - 4
            sr = channels = bits = None
            data_size = None
            while remaining >= 8:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                remaining -= 8
                chunk_id, chunk_size = struct.unpack("<4sI", hdr)
                pad = chunk_size % 2
                remaining -= chunk_size + pad
                if chunk_id == b"fmt ":
                    fmt = f.read(chunk_size + pad)[:chunk_size]
                    _, channels, sr, _br, _ba, bits = struct.unpack(
                        "<HHIIHH", fmt[:16]
                    )
                elif chunk_id == b"data":
                    data_size = chunk_size
                    f.seek(chunk_size + pad, 1)
                else:
                    f.seek(chunk_size + pad, 1)
            if sr is None or data_size is None or not bits or not channels:
                return None
            return sr, data_size // (channels * bits // 8), channels
    except (OSError, struct.error, ValueError):
        return None


def write_wav(
    path: Union[str, Path], wav: np.ndarray, sample_rate: int, bits: int = 16
) -> None:
    """Write float32 [-1, 1] (T,) or (T, C) as PCM WAV. int16 input is
    written through untouched (pre-quantized on device by the serving
    pipeline's PCM16 stage, Speech2Token.dispatch(pcm16_ilens=...))."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        channels = 1
    else:
        channels = wav.shape[1]
    if wav.dtype == np.int16 and bits == 16:
        pcm = wav.astype("<i2", copy=False)
    elif wav.dtype == np.int16:
        raise ValueError("int16 passthrough only supports bits=16")
    elif bits == 16:
        pcm = np.clip(np.round(np.asarray(wav, np.float32) * 32767.0), -32768, 32767).astype("<i2")
    elif bits == 32:
        pcm = np.clip(np.round(np.asarray(wav, np.float32) * 2147483647.0), -(1 << 31), (1 << 31) - 1).astype("<i4")
    else:
        raise ValueError(f"unsupported bits {bits}")
    payload = pcm.tobytes()
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def save_audio(
    wav: np.ndarray, path: Union[str, Path], sample_rate: int, rescale: bool = False
) -> None:
    """Reference save_audio semantics (codec_inference.py:153-161)."""
    wav = np.asarray(wav, np.float32)
    limit = 0.99
    mx = float(np.max(np.abs(wav))) if wav.size else 0.0
    if rescale and mx > 0:
        wav = wav * min(limit / mx, 1.0)
    else:
        wav = np.clip(wav, -limit, limit)
    if wav.ndim == 2:  # (C, T) torch layout -> (T, C)
        wav = wav.T
        if wav.shape[1] == 1:
            wav = wav[:, 0]
    write_wav(path, wav, sample_rate, bits=16)


def resample(wav: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling with a Kaiser-windowed sinc filter.

    Fills the role of torchaudio.functional.resample in the reference
    pipeline (codec_inference.py:318-322); equivalent quality, not bit-equal.
    """
    if orig_sr == new_sr:
        return wav
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, new_sr)
    return resample_poly(wav, new_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def read_2column_text(path: Union[str, Path]) -> Dict[str, str]:
    """uttid -> value map from a kaldi-style scp (fileio/read_text.py:12-38)."""
    out: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            sps = line.rstrip().split(maxsplit=1)
            if len(sps) == 1:
                k, v = sps[0], ""
            else:
                k, v = sps
            out[k] = v
    return out


def read_wav_ark_entry(rxspecifier: str) -> Tuple[int, np.ndarray]:
    """Read one wav from 'path.ark:offset' (kaldiio wav-ark entry: the scp
    offset points directly at the embedded RIFF header)."""
    path, _, offset = rxspecifier.rpartition(":")
    with open(path, "rb") as f:
        f.seek(int(offset))
        return read_wav_fileobj(f, name=rxspecifier)


class WavArkWriter:
    """kaldiio WriteHelper("ark,scp,f:...") for (rate, int16 wav) entries —
    the format the reference's data prep dumps resampled corpora into
    (egs/LibriTTS/codec/run.sh:123-147, scripts/dump_to_wav_ark.py:81).

    Record layout: b"<key> " + RIFF/WAVE bytes (16-bit PCM); scp line is
    "<key> <ark_path>:<offset>" with offset at the RIFF marker.
    """

    def __init__(self, ark_path: Union[str, Path], scp_path: Optional[Union[str, Path]] = None):
        self.ark_path = str(ark_path)
        self.ark_f = open(ark_path, "wb")
        self.scp_f = open(scp_path, "wt") if scp_path else None

    def __call__(self, key: str, sample_rate: int, wav: np.ndarray) -> None:
        wav = np.asarray(wav)
        if wav.dtype != np.int16:  # float [-1,1] -> int16 (dump_to_wav_ark.py:81)
            wav = (np.asarray(wav, np.float32) * (2**15)).astype(np.int16)
        payload = wav.tobytes()
        channels = 1 if wav.ndim == 1 else wav.shape[1]
        self.ark_f.write(key.encode() + b" ")
        offset = self.ark_f.tell()
        byte_rate = sample_rate * channels * 2
        self.ark_f.write(b"RIFF")
        self.ark_f.write(struct.pack("<I", 36 + len(payload)))
        self.ark_f.write(b"WAVE")
        self.ark_f.write(b"fmt ")
        self.ark_f.write(struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                                     byte_rate, channels * 2, 16))
        self.ark_f.write(b"data")
        self.ark_f.write(struct.pack("<I", len(payload)))
        self.ark_f.write(payload)
        if len(payload) % 2:
            self.ark_f.write(b"\0")
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


def _is_ark_entry(path: str) -> bool:
    head, sep, offset = path.rpartition(":")
    return bool(sep) and offset.isdigit() and ".ark" in head.lower()


class SoundScpReader:
    """wav.scp reader: uttid -> (rate, array) (fileio/sound_scp.py:12-67).

    Values may be plain wav paths or wav-ark entries 'x.ark:offset' (the form
    the reference's resample-to-ark data prep produces)."""

    def __init__(self, fname: Union[str, Path], dtype=np.float32):
        self.fname = fname
        self.dtype = dtype
        self.data = read_2column_text(fname)

    def __getitem__(self, key: str) -> Tuple[int, np.ndarray]:
        path = self.data[key]
        if _is_ark_entry(path):
            sr, x = read_wav_ark_entry(path)
        else:
            sr, x = read_wav(path)
        return sr, x.astype(self.dtype)

    def keys(self):
        return self.data.keys()

    def __len__(self):
        return len(self.data)

    def __contains__(self, item):
        return item in self.data

    def __iter__(self) -> Iterator[str]:
        return iter(self.data)
