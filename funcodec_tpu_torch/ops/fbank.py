"""Kaldi-compatible log-mel fbank frontend, LFR and CMVN (port of funcodec_tpu/ops/fbank.py).

Behavioral reference: funcodec/models/frontend/wav_frontend.py:78
(torchaudio.compliance.kaldi.fbank -> apply_lfr -> apply_cmvn).

The Kaldi fbank pipeline: snip_edges framing, DC removal, pre-emphasis
0.97, the povey window, a power spectrum of the right-zero-padded frame
(``torch.fft.rfft``; the JAX package's two DFT matmuls are a TPU
workaround), the HTK mel scale 1127 ln(1 + f / 700) without area
normalization, log with Kaldi's epsilon. No dither, for determinism. The
filterbank, the window and the CMVN file's parse are host numpy, as in the
JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from funcodec_tpu_torch.tasks.codec import resolve_device


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=8)
def _povey_window(length: int) -> np.ndarray:
    n = np.arange(length)
    hann = 0.5 - 0.5 * np.cos(2 * math.pi * n / (length - 1))
    return (hann**0.85).astype(np.float32)


@functools.lru_cache(maxsize=8)
def kaldi_mel_banks(num_bins: int, n_fft: int, sample_rate: int, low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """Kaldi mel filterbank (num_bins, n_fft // 2 + 1): HTK scale, no area normalization."""
    if high_freq <= 0:
        high_freq = sample_rate / 2.0 + high_freq

    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    mel_points = np.linspace(mel(low_freq), mel(high_freq), num_bins + 2)
    fft_mels = mel(np.arange(n_fft // 2 + 1) * sample_rate / n_fft)
    banks = np.zeros((num_bins, n_fft // 2 + 1), np.float32)
    for b in range(num_bins):
        left, center, right = mel_points[b], mel_points[b + 1], mel_points[b + 2]
        up = (fft_mels - left) / (center - left)
        down = (right - fft_mels) / (right - center)
        banks[b] = np.maximum(0.0, np.minimum(up, down))
    return banks


def fbank(
    wav: torch.Tensor,  # (B, T) float in [-1, 1]
    sample_rate: int = 16000,
    num_mel_bins: int = 80,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
    use_log_fbank: bool = True,
    input_scale: float = 32768.0,
) -> torch.Tensor:
    """(B, T) -> (B, frames, num_mel_bins) Kaldi-style log-mel, fp32.

    `input_scale` matches wav_frontend.py (waveform * 2**15 before fbank)."""
    x = wav.float() * input_scale
    frame_len = int(sample_rate * frame_length_ms / 1000)
    shift = int(sample_rate * frame_shift_ms / 1000)
    n_fft = _next_pow2(frame_len)
    frames = x.unfold(-1, frame_len, shift)  # (B, F, L), snip_edges
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis > 0:
        frames = torch.cat([frames[..., :1] - preemphasis * frames[..., :1],
                            frames[..., 1:] - preemphasis * frames[..., :-1]], dim=-1)
    frames = frames * torch.from_numpy(_povey_window(frame_len)).to(frames.device)
    spec = torch.fft.rfft(frames, n=n_fft)  # (B, F, n_fft // 2 + 1)
    power = spec.real.square() + spec.imag.square()
    banks = torch.from_numpy(kaldi_mel_banks(num_mel_bins, n_fft, sample_rate)).to(frames.device)
    mel = power @ banks.T
    if use_log_fbank:
        mel = torch.log(mel.clamp_min(1.1920928955078125e-07))  # Kaldi's epsilon
    return mel


def apply_lfr(feats: torch.Tensor, lfr_m: int = 7, lfr_n: int = 6) -> torch.Tensor:
    """Low-frame-rate stacking (wav_frontend apply_lfr): left-pad with the
    first frame, stack lfr_m frames every lfr_n, right-pad with the last."""
    B, T, D = feats.shape
    left = (lfr_m - 1) // 2
    padded = torch.cat([feats[:, :1].expand(B, left, D), feats], dim=1)
    n_out = math.ceil(T / lfr_n)
    need = (n_out - 1) * lfr_n + lfr_m
    if need > padded.shape[1]:
        padded = torch.cat([padded, padded[:, -1:].expand(B, need - padded.shape[1], D)], dim=1)
    idx = (torch.arange(n_out)[:, None] * lfr_n + torch.arange(lfr_m)[None, :]).to(feats.device)
    return padded[:, idx].reshape(B, n_out, lfr_m * D)


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def load_kaldi_cmvn(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a Kaldi text CMVN stats matrix -> (add_shift, rescale), fp32."""
    with open(path) as f:
        text = f.read()
    nums = text.replace("[", " ").replace("]", " ").split()
    arr = np.asarray([float(v) for v in nums if _is_float(v)], np.float64)
    dim = len(arr) // 2 - 1
    sums, count, sq = arr[:dim], arr[dim], arr[dim + 1 : 2 * dim + 1]
    mean = sums / count
    var = sq / count - mean**2
    return (-mean).astype(np.float32), (1.0 / np.sqrt(np.maximum(var, 1e-20))).astype(np.float32)


def apply_cmvn(feats: torch.Tensor, shift: Union[np.ndarray, torch.Tensor],
               scale: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
    return (feats + torch.as_tensor(shift, device=feats.device)) * torch.as_tensor(scale, device=feats.device)


class WavFrontend:
    """fbank -> LFR -> CMVN (wav_frontend.py:78). The CMVN vectors live on
    `device`, the card unless the caller asks for the CPU."""

    def __init__(self, fs: int = 16000, n_mels: int = 80, frame_length: float = 25.0, frame_shift: float = 10.0,
                 lfr_m: int = 1, lfr_n: int = 1, cmvn_file: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.fs = fs
        self.n_mels = n_mels
        self.frame_length = frame_length
        self.frame_shift = frame_shift
        self.lfr_m = lfr_m
        self.lfr_n = lfr_n
        self.cmvn = None
        if cmvn_file:
            self.cmvn = tuple(torch.from_numpy(a).to(self.device) for a in load_kaldi_cmvn(cmvn_file))

    def output_size(self) -> int:
        return self.n_mels * self.lfr_m

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) on the frontend's device -> (B, frames', output_size())."""
        feats = fbank(torch.as_tensor(wav, device=self.device), self.fs, self.n_mels, self.frame_length,
                      self.frame_shift)
        if self.lfr_m > 1 or self.lfr_n > 1:
            feats = apply_lfr(feats, self.lfr_m, self.lfr_n)
        if self.cmvn is not None:
            feats = apply_cmvn(feats, *self.cmvn)
        return feats
