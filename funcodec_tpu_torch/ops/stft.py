"""STFT, ISTFT, PhaseAug and mel filterbanks (port of funcodec_tpu/ops/stft.py:
hann_window, frame_signal, stft, istft, mel_filterbank, audio_to_mel,
phase_aug).

``stft`` is ``torch.stft`` and ``istft`` torch.istft's ops without its
per-call host check (cuFFT on the card), with torchaudio's window
normalization; the JAX package's
windowed-DFT matmuls were a TPU workaround for XLA's FFT. The spectra and
the resynthesis are computed in fp32 whatever the input's type, and
autograd differentiates through both. ``mel_filterbank`` is a numpy copy
of the JAX package's librosa-slaney reimplementation (the port imports
nothing of that package).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from funcodec_tpu_torch.parallel.dist import DataGroup, draw_rows


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


def istft(
    spec: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    center: bool = True,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Inverse STFT of complex (..., n_fft//2+1, n_frames) -> (..., T), fp32.

    torch.istft's steps, op for op, over the periodic hann window: each
    frame's inverse real DFT times the window, overlap-added
    (``unfold_backward``), divided by the summed squared window, the
    n_fft//2 samples of the center padding trimmed from each end, then cut
    to `length` (the JAX version's semantics). The same bits as torch.istft
    without its per-call host check of the envelope, which waits for the
    device: ``_envelope`` makes that check once per geometry (torch.istft
    raises where the envelope falls below 1e-11, which the JAX version
    clamps, and which no hann window with hop <= win_length / 2 reaches
    inside the trimmed span).
    """
    win_length = win_length or n_fft
    lead, n_frames = spec.shape[:-2], spec.shape[-1]
    flat = spec.to(torch.complex64).reshape(-1, *spec.shape[-2:])
    frames = torch.fft.irfft(flat.transpose(1, 2), n_fft, dim=-1) * _window(n_fft, win_length, flat.device)
    signal_len = n_fft + hop_length * (n_frames - 1)
    out = torch.ops.aten.unfold_backward(frames, [flat.shape[0], signal_len], 1, n_fft, hop_length)
    start, end = (n_fft // 2, signal_len - n_fft // 2) if center else (0, signal_len)
    out = out[:, start:end] / _envelope(n_fft, hop_length, win_length, n_frames, center, flat.device)
    if length is not None:
        out = out[..., :length]
    return out.reshape(*lead, out.shape[-1])


def _window(n_fft: int, win_length: int, device) -> torch.Tensor:
    """The periodic hann window of `win_length`, zero-padded to n_fft in the
    middle (torch.istft's)."""
    window = hann_window(win_length, device=device)
    left = (n_fft - win_length) // 2
    return F.pad(window, (left, n_fft - win_length - left)) if win_length != n_fft else window


@functools.lru_cache(maxsize=64)
def _envelope(n_fft: int, hop_length: int, win_length: int, n_frames: int, center: bool,
              device: torch.device) -> torch.Tensor:
    """torch.istft's summed squared window over the kept span, (1, T),
    checked once: the check reads it back on the host. Made outside
    inference mode, so a later call with grad can save it."""
    with torch.inference_mode(False), torch.no_grad():
        squares = _window(n_fft, win_length, device).pow(2).expand(1, n_frames, n_fft)
        signal_len = n_fft + hop_length * (n_frames - 1)
        env = torch.ops.aten.unfold_backward(squares, [1, signal_len], 1, n_fft, hop_length)
        env = env[:, n_fft // 2:signal_len - n_fft // 2] if center else env
    if bool(env.abs().min() < 1e-11):
        raise ValueError(f"istft: the squared window's overlap-add falls below 1e-11 (n_fft {n_fft}, hop "
                         f"{hop_length}, win_length {win_length})")
    return env


def phase_aug(
    x: torch.Tensor,  # (B, T)
    generator: Optional[torch.Generator] = None,
    n_fft: int = 512,
    hop_length: int = 160,
    var: float = 6.0,
    delta_max: float = 2.0,
    cutoff: float = 0.05,
    kernel_size: int = 128,
    phi: Optional[torch.Tensor] = None,  # (B, n_fft//2+1) explicit rotation
    group: Optional[DataGroup] = None,
) -> torch.Tensor:
    """PhaseAug (arXiv:2211.04610): rotate each frequency bin k of x's STFT
    by phi(k) = mu(k) + delta * pi * k / (K - 1) and resynthesize, so |STFT|
    is kept on the analysis grid. mu is N(0, var) noise low-passed along
    frequency (a hann-windowed sinc of `kernel_size` taps, edge-padded,
    'valid' convolution), delta ~ U(-delta_max, delta_max), both drawn from
    `generator` unless `phi` is given. DC and Nyquist stay real. Returns x's
    shape and dtype; the transform runs in fp32.

    The draws come from a torch.Generator, not jax.random, so the two
    packages agree only through an explicit `phi`. With a data `group`, x is
    this rank's block of the batch, and mu and delta are drawn at the global
    batch's shape, each rank keeping its rows (as one process draws them).
    """
    B, T = x.shape
    K = n_fft // 2 + 1
    if phi is None:
        dev = x.device
        mu = math.sqrt(var) * draw_rows(lambda n: torch.randn(n, K, generator=generator, device=dev), B, group)
        n = torch.arange(kernel_size, dtype=torch.float32, device=dev) - (kernel_size - 1) / 2.0
        kern = 2 * cutoff * torch.sinc(2 * cutoff * n) * hann_window(kernel_size, device=dev)
        kern = kern / kern.sum()
        pad = (kernel_size - 1) // 2
        mu_p = F.pad(mu[:, None], (pad, kernel_size - 1 - pad), mode="replicate")
        mu = F.conv1d(mu_p, kern.flip(0)[None, None])[:, 0]  # np.convolve flips the kernel
        delta = draw_rows(lambda n: torch.rand(n, 1, generator=generator, device=dev), B, group)
        delta = delta * (2 * delta_max) - delta_max
        phi = mu + delta * math.pi * (torch.arange(K, dtype=torch.float32, device=dev)[None, :] / (K - 1))
    phi = phi.float().clone()
    phi[:, 0] = 0.0
    phi[:, -1] = 0.0
    spec = stft(x, n_fft, hop_length)
    rot = torch.polar(torch.ones_like(phi), phi)[:, :, None]
    return istft(spec * rot, n_fft, hop_length, length=T).to(x.dtype)
