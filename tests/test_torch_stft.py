"""ops/stft of the port against funcodec_tpu/ops/stft, on the CPU.

The same numpy signals go through the JAX windowed-DFT matmuls and the
port's torch.stft. Tolerances: spectra atol 2e-4, rtol 1e-4 (the JAX
package's own against torch.stft: fp32 FFT against fp32 matmuls); the
filterbank rtol 1e-6 (the same numpy code); the window atol 1e-6 (fp32
cosines); log mels atol 1e-4; gradients 1e-4 of the largest.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from funcodec_tpu.ops import stft as jstft
from funcodec_tpu_torch.ops import stft as tstft

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "n_fft,hop,win,center,normalized",
    [
        (1024, 256, 1024, False, False),
        (1024, 256, 1024, False, True),
        (1024, 8, 32, False, False),  # the mel loss's shortest window
        (512, 160, 512, True, False),  # center=True, reflect
        (2048, 512, 2048, False, True),  # a discriminator scale
        (256, 64, 200, True, True),  # win < n_fft, odd half-difference
    ],
)
def test_stft_matches_jax(n_fft, hop, win, center, normalized):
    x = np.random.RandomState(0).randn(2, 4096).astype(np.float32)
    ref = np.asarray(jstft.stft(jnp.asarray(x), n_fft, hop, win, center=center, normalized=normalized))
    out = tstft.stft(torch.from_numpy(x), n_fft, hop, win, center=center, normalized=normalized).numpy()
    assert out.shape == ref.shape and out.dtype == np.complex64
    np.testing.assert_allclose(out.real, ref.real, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(out.imag, ref.imag, atol=2e-4, rtol=1e-4)


def test_stft_keeps_leading_axes_and_computes_in_fp32():
    x = np.random.RandomState(1).randn(2, 3, 2048).astype(np.float32)
    out = tstft.stft(torch.from_numpy(x).to(torch.bfloat16), 512, 128)
    ref = tstft.stft(torch.from_numpy(x).to(torch.bfloat16).float(), 512, 128)
    assert out.shape == (2, 3, 257, 17) and out.dtype == torch.complex64
    assert torch.equal(out, ref)


def test_window_and_frames_match_jax():
    # fp32 cosines rounded at other points: a few ulps of 1.0
    np.testing.assert_allclose(tstft.hann_window(400).numpy(), np.asarray(jstft.hann_window(400)), atol=1e-6)
    x = np.arange(50, dtype=np.float32).reshape(2, 25)
    np.testing.assert_array_equal(tstft.frame_signal(torch.from_numpy(x), 8, 3).numpy(),
                                  np.asarray(jstft.frame_signal(jnp.asarray(x), 8, 3)))


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [(16000, 1024, 64, 0.0, None), (24000, 512, 80, 50.0, 8000.0)])
def test_mel_filterbank_matches_jax(sr, n_fft, n_mels, fmin, fmax):
    ours = tstft.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    ref = jstft.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    assert ours.shape == (n_mels, n_fft // 2 + 1) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("power", [False, True], ids=["mel", "mel+power"])
@pytest.mark.parametrize("p", [5, 10])
def test_audio_to_mel_matches_jax(p, power):
    win = 2**p
    kw = dict(n_fft=1024, hop_length=win // 4, win_length=win, sampling_rate=16000, n_mel_channels=64)
    x = (0.3 * np.random.RandomState(p).randn(2, 4000)).astype(np.float32)
    ref = jstft.audio_to_mel(jnp.asarray(x), return_power_spec=power, **kw)
    out = tstft.audio_to_mel(torch.from_numpy(x), return_power_spec=power, **kw)
    for o, r in zip(out if power else [out], ref if power else [ref]):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)


def test_audio_to_mel_gradient_matches_jax():
    """d/dx of the mel loss's L1 + L2 terms (power spectrum included)."""
    kw = dict(n_fft=1024, hop_length=16, win_length=64, sampling_rate=16000, n_mel_channels=64,
              return_power_spec=True)
    rs = np.random.RandomState(3)
    x, ref_x = (0.3 * rs.randn(2, 3000)).astype(np.float32), (0.3 * rs.randn(2, 3000)).astype(np.float32)

    def jloss(v):
        m, pw = jstft.audio_to_mel(v, **kw)
        rm, rp = jstft.audio_to_mel(jnp.asarray(ref_x), **kw)
        return jnp.mean(jnp.abs(m - rm)) + jnp.mean((pw - rp) ** 2)

    jg = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    m, pw = tstft.audio_to_mel(xt, **kw)
    rm, rp = tstft.audio_to_mel(torch.from_numpy(ref_x), **kw)
    (g,) = torch.autograd.grad((m - rm).abs().mean() + (pw - rp).square().mean(), xt)
    np.testing.assert_allclose(g.numpy(), jg, atol=1e-4 * np.abs(jg).max(), rtol=0)
