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


# ---------------------------------------------------------------------------
# istft and phase_aug (FreqCodec). Tolerances: the resynthesis atol 1e-5
# (cuFFT / pocketfft against the JAX DFT matmuls, fp32); gradients 1e-4 of
# the largest.
# ---------------------------------------------------------------------------


def _spectrum(n_fft, hop, win, batch=2, length=4000, seed=2):
    """A signal's spectrum with its phases perturbed (not the STFT of any
    signal, so the overlap-add and its envelope division both show)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, length).astype(np.float32)
    spec = tstft.stft(torch.from_numpy(x), n_fft, hop, win).numpy()
    rot = np.exp(1j * rs.uniform(-0.5, 0.5, spec.shape)).astype(np.complex64)
    return (spec * rot).astype(np.complex64)


@pytest.mark.parametrize("n_fft,hop,win,length", [
    (512, 160, 512, None),  # FreqCodec's domain transform
    (512, 160, 512, 3900),  # cut to a length
    (64, 16, 64, None),  # the tiny test configs' transform
    (256, 64, 200, 3999),  # win < n_fft
])
def test_istft_matches_jax(n_fft, hop, win, length):
    spec = _spectrum(n_fft, hop, win)
    ref = np.asarray(jstft.istft(jnp.asarray(spec), n_fft, hop, win, center=True, length=length))
    out = tstft.istft(torch.from_numpy(spec), n_fft, hop, win, center=True, length=length)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_fft,hop,win,frames,lead", [
    (512, 160, 512, 609, (3,)),  # FreqCodec's transform at the benchmark's 97,280-sample bucket
    (32, 16, 32, 65, (2, 4)),  # the tiny FreqCodec configs'
    (256, 64, 200, 40, (2,)),  # win < n_fft
])
def test_istft_is_torch_istft_bit_for_bit(n_fft, hop, win, frames, lead):
    """torch.istft's ops without its host check of the envelope: the same bits."""
    spec = torch.randn(*lead, n_fft // 2 + 1, frames, generator=torch.Generator().manual_seed(frames),
                       dtype=torch.complex64)
    flat = spec.reshape(-1, n_fft // 2 + 1, frames)
    ref = torch.istft(flat, n_fft, hop, win, tstft.hann_window(win), center=True, return_complex=False)
    with torch.inference_mode():  # as the codec serves: the cached envelope must still serve autograd
        got = tstft.istft(spec, n_fft, hop, win)
    assert torch.equal(got, ref.reshape(*lead, ref.shape[-1]))
    x = spec.clone().requires_grad_()
    tstft.istft(x, n_fft, hop, win).sum().backward()
    assert torch.isfinite(torch.view_as_real(x.grad)).all()


def test_istft_refuses_an_envelope_that_vanishes():
    """center=False keeps a hann window's zero first sample, which torch.istft refuses too."""
    spec = torch.zeros(1, 257, 30, dtype=torch.complex64)
    with pytest.raises(RuntimeError, match="window overlap add min"):
        torch.istft(spec, 512, 128, 512, tstft.hann_window(512), center=False, return_complex=False)
    with pytest.raises(ValueError, match="below 1e-11"):
        tstft.istft(spec, 512, 128, 512, center=False)


def test_istft_inverts_stft_with_leading_axes():
    x = np.random.RandomState(3).randn(2, 3, 3200).astype(np.float32)
    spec = tstft.stft(torch.from_numpy(x), 512, 160)
    out = tstft.istft(spec, 512, 160, length=3200)
    assert out.shape == (2, 3, 3200)
    np.testing.assert_allclose(out.numpy(), x, atol=1e-5)


def test_istft_gradient_matches_jax():
    spec = _spectrum(64, 16, 64, length=800)
    ct = np.random.RandomState(4).randn(2, 800).astype(np.float32)

    def jloss(re, im):
        return jnp.sum(jstft.istft(jax.lax.complex(re, im), 64, 16, length=800) * ct)

    j_re, j_im = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(spec.real), jnp.asarray(spec.imag))
    re = torch.from_numpy(spec.real.copy()).requires_grad_()
    im = torch.from_numpy(spec.imag.copy()).requires_grad_()
    (tstft.istft(torch.complex(re, im), 64, 16, length=800) * torch.from_numpy(ct)).sum().backward()
    for got, want in ((re.grad, j_re), (im.grad, j_im)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_phase_aug_matches_jax_with_phi():
    """An explicit rotation (its DC and Nyquist entries are zeroed by both).
    A length that is not a multiple of the hop comes back cut to the
    frames' span, hop * (T // hop), in both packages."""
    rs = np.random.RandomState(5)
    phi = rs.uniform(-np.pi, np.pi, (3, 257)).astype(np.float32)
    for T in (3300, 3200):
        x = (0.3 * rs.randn(3, T)).astype(np.float32)
        ref = np.asarray(jstft.phase_aug(jnp.asarray(x), phi=jnp.asarray(phi)))
        out = tstft.phase_aug(torch.from_numpy(x), phi=torch.from_numpy(phi))
        assert out.shape == ref.shape == (3, 3200) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_phase_aug_draws_follow_the_jax_formula():
    """phase_aug(generator) equals phase_aug(phi) with phi computed in numpy
    from the same generator's draws by the JAX version's formula (N(0, var)
    noise low-passed by a hann-windowed sinc, edge-padded, np.convolve
    'valid'; delta ~ U(-2, 2)); bf16 in, bf16 out."""
    B, K, ks, cutoff = 2, 257, 128, 0.05
    x = torch.from_numpy((0.3 * np.random.RandomState(6).randn(B, 1920)).astype(np.float32))
    out = tstft.phase_aug(x, torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(11)
    mu = (np.sqrt(6.0) * torch.randn(B, K, generator=g)).numpy().astype(np.float64)
    delta = (torch.rand(B, 1, generator=g) * 4.0 - 2.0).numpy().astype(np.float64)
    n = np.arange(ks) - (ks - 1) / 2.0
    kern = 2 * cutoff * np.sinc(2 * cutoff * n) * (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(ks) / ks))
    kern /= kern.sum()
    pad = (ks - 1) // 2
    mu = np.stack([np.convolve(np.pad(row, (pad, ks - 1 - pad), mode="edge"), kern, mode="valid") for row in mu])
    phi = (mu + delta * np.pi * np.arange(K)[None, :] / (K - 1)).astype(np.float32)
    want = tstft.phase_aug(x, phi=torch.from_numpy(phi))
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5)
    again = tstft.phase_aug(x.to(torch.bfloat16), torch.Generator().manual_seed(11))
    assert again.dtype == torch.bfloat16 and again.shape == x.shape
