"""STFT and mel filterbanks (port of funcodec_tpu/ops/stft.py: hann_window,
frame_signal, stft, mel_filterbank, audio_to_mel).

``stft`` is ``torch.stft`` (cuFFT on the card) with torchaudio's window
normalization; the JAX package's windowed-DFT matmuls were a TPU workaround
for XLA's FFT. The spectra are computed in fp32 whatever the input's type.
``mel_filterbank`` is a numpy copy of the JAX package's librosa-slaney
reimplementation (the port imports nothing of that package).

istft and phase_aug (FreqCodec) come with ROADMAP.md slice C.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """torch.hann_window(periodic=True)."""
    return torch.hann_window(win_length, periodic=True, dtype=dtype, device=device)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_length), n_frames = 1 + (T - L) // hop."""
    return x.unfold(-1, frame_length, hop)


def stft(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    center: bool = True,
    normalized: bool = False,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """Complex STFT of (..., T) -> (..., n_fft//2+1, n_frames), complex64.

    torch.stft over a periodic hann window of `win_length`, zero-padded to
    n_fft in the middle. ``normalized=True`` divides by sqrt(sum(window^2))
    (torchaudio's window normalization), not by sqrt(n_fft) as
    ``torch.stft(normalized=True)`` would.
    """
    win_length = win_length or n_fft
    window = hann_window(win_length, device=x.device)
    lead = x.shape[:-1]
    spec = torch.stft(
        x.float().reshape(-1, x.shape[-1]), n_fft, hop_length, win_length, window,
        center=center, pad_mode=pad_mode, normalized=False, onesided=True, return_complex=True,
    )
    if normalized:
        spec = spec / window.square().sum().sqrt()
    return spec.reshape(*lead, *spec.shape[-2:])


@functools.lru_cache(maxsize=32)
def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney') as (n_mels, n_fft//2+1) fp32.

    Slaney mel scale: linear below 1 kHz, logarithmic above; triangular
    filters area-normalized by 2/(mel_f[i+2]-mel_f[i]).
    """
    fmax = fmax or sr / 2.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3.0)
    logstep = math.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        f / (200.0 / 3.0))

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * (200.0 / 3.0))

    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def audio_to_mel(
    audio: torch.Tensor,  # (B, T)
    n_fft: int,
    hop_length: int,
    win_length: int,
    sampling_rate: int,
    n_mel_channels: int,
    return_power_spec: bool = False,
):
    """Reflect pad by (n_fft - hop) // 2, a center=False STFT, the power
    spectrum, the slaney mel projection, log10 clamped at 1e-5; all fp32.
    Returns log_mel (B, n_mels, frames), and log_power (B, F, frames) with
    ``return_power_spec``."""
    p = (n_fft - hop_length) // 2
    x = F.pad(audio.float()[:, None, :], (p, p), mode="reflect")[:, 0]
    spec = stft(x, n_fft, hop_length, win_length, center=False, normalized=False)
    power = torch.view_as_real(spec).square().sum(dim=-1)  # (B, F, frames)
    mel_basis = torch.from_numpy(mel_filterbank(sampling_rate, n_fft, n_mel_channels)).to(power.device)
    log_mel = torch.log10(torch.clamp(torch.einsum("mf,bft->bmt", mel_basis, power), min=1e-5))
    if return_power_spec:
        return log_mel, torch.log10(torch.clamp(power, min=1e-5))
    return log_mel
