"""The port's Kaldi fbank frontend (ops/fbank.py) against funcodec_tpu's, on the CPU.

The same seeded waveforms go through both packages. Tolerances: log-mel
atol 2e-3 (fp32 power spectra, torch.fft.rfft against JAX's DFT matmuls at
the 2**15 input scale: relative 1e-6 of a power, 1e-6 in its log, except
near Kaldi's epsilon floor, where the log's slope is large); LFR exact;
CMVN rtol 1e-6; plus the JAX file's invariants. A pure tone's mel powers
within 2e-6 of its largest (its far bins' logs are fp32 leakage noise).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from funcodec_tpu.ops import fbank as jfb
from funcodec_tpu_torch.ops import fbank as tfb

torch.set_num_threads(1)

LOGMEL_ATOL = 2e-3


def _cmvn_file(path, dim, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(1000, dim) * 3.0 + 5.0
    sums, sq = feats.sum(axis=0), (feats**2).sum(axis=0)
    path.write_text("[ " + " ".join(map(str, list(sums) + [feats.shape[0]])) + "\n"
                    + " ".join(map(str, list(sq) + [0])) + " ]")
    return str(path), feats


@pytest.mark.parametrize("num_mel_bins,T", [(80, 16000), (40, 8123)])
def test_fbank_matches_jax(num_mel_bins, T):
    wav = (0.1 * np.random.RandomState(0).randn(2, T)).astype(np.float32)
    got = tfb.fbank(torch.from_numpy(wav), 16000, num_mel_bins).numpy()
    want = np.asarray(jfb.fbank(jnp.asarray(wav), 16000, num_mel_bins))
    assert got.shape == want.shape == (2, 1 + (T - 400) // 160, num_mel_bins)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGMEL_ATOL)


def test_fbank_shapes_and_values():
    """tests/test_fbank.py's invariants: 98 frames for 1 s (snip_edges), the
    energy of a 1 kHz tone peaking near the 1 kHz mel bin."""
    sr = 16000
    t = np.arange(sr) / sr
    wav = (0.5 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)[None]
    feats = tfb.fbank(torch.from_numpy(wav), sr, num_mel_bins=80).numpy()
    assert feats.shape == (1, 98, 80) and np.isfinite(feats).all()
    banks = tfb.kaldi_mel_banks(80, 512, sr)
    np.testing.assert_array_equal(banks, jfb.kaldi_mel_banks(80, 512, sr))
    peak_hz = (np.arange(257) * sr / 512)[banks[feats[0].mean(axis=0).argmax()].argmax()]
    assert 800 < peak_hz < 1250, peak_hz
    # a pure tone leaves far bins at 1e-12 of the peak, where fp32 leakage rounding
    # moves the log by up to 0.03 in either package (against float64); so the
    # mel powers are held within 2e-6 of the largest one
    want = np.exp(np.asarray(jfb.fbank(jnp.asarray(wav), sr, 80)))
    np.testing.assert_allclose(np.exp(feats), want, rtol=0, atol=2e-6 * float(want.max()))


@pytest.mark.parametrize("lfr_m,lfr_n,T", [(3, 2, 10), (7, 6, 98), (7, 6, 5), (1, 1, 4)])
def test_lfr_matches_jax(lfr_m, lfr_n, T):
    x = np.random.RandomState(1).randn(2, T, 3).astype(np.float32)
    got = tfb.apply_lfr(torch.from_numpy(x), lfr_m, lfr_n).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfb.apply_lfr(jnp.asarray(x), lfr_m, lfr_n)))


def test_lfr_stacking():
    y = tfb.apply_lfr(torch.arange(10, dtype=torch.float32)[None, :, None], lfr_m=3, lfr_n=2).numpy()
    assert y.shape == (1, 5, 3)
    np.testing.assert_array_equal(y[0, 0], [0, 0, 1])  # left-padded with the first frame
    np.testing.assert_array_equal(y[0, 1], [1, 2, 3])


def test_cmvn_matches_jax_and_normalizes(tmp_path):
    path, feats = _cmvn_file(tmp_path / "cmvn.txt", 4)
    shift, scale = tfb.load_kaldi_cmvn(path)
    j_shift, j_scale = jfb.load_kaldi_cmvn(path)
    np.testing.assert_array_equal(shift, j_shift)
    np.testing.assert_array_equal(scale, j_scale)
    x = feats[None].astype(np.float32)
    out = tfb.apply_cmvn(torch.from_numpy(x), shift, scale).numpy()
    np.testing.assert_allclose(out, np.asarray(jfb.apply_cmvn(jnp.asarray(x), j_shift, j_scale)), rtol=1e-6)
    assert abs(out.mean()) < 1e-2 and abs(out.std() - 1.0) < 1e-2


def test_wav_frontend_matches_jax(tmp_path):
    path, _ = _cmvn_file(tmp_path / "cmvn.txt", 280, seed=2)
    wav = (0.1 * np.random.RandomState(0).randn(2, 8000)).astype(np.float32)
    fe = tfb.WavFrontend(fs=16000, n_mels=40, lfr_m=7, lfr_n=6, cmvn_file=path, device="cpu")
    jfe = jfb.WavFrontend(fs=16000, n_mels=40, lfr_m=7, lfr_n=6, cmvn_file=path)
    got = fe(torch.from_numpy(wav))
    want = np.asarray(jfe(jnp.asarray(wav)))
    assert got.shape == want.shape and got.shape[-1] == fe.output_size() == 280
    assert all(t.device.type == "cpu" for t in fe.cmvn)
    # the CMVN scale multiplies the log-mel difference by up to 1/std of the stats
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGMEL_ATOL * float(fe.cmvn[1].abs().max()))


def test_wav_frontend_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        tfb.WavFrontend()
