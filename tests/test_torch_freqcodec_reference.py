"""The port's FreqCodec served through ``Speech2Token`` against the
benchmark's plain reference (benchmark/reference/freqcodec.py), on the CPU.

A narrowed gr8-shaped FreqCodec: n_filters 8, two (4, .) frequency stages
with the time stride 2, conv_group_ratio 2 (grouped 2D convs and grouped
transposed 2D convs, as gr8's), 4 quantizers of 64 codes, 16-d latents;
n_fft 32 and hop 16, so that the two stages take the 17 bins to 1 (the
released 257 bins take four). Seeded weights from the reference's
``param_specs``; 0.2 s rows of int16 PCM, ragged inside one 16-frame
bucket, through ``dispatch`` (run_mod inference, ``pcm16_ilens``) and
``collect`` as the CLI serves them.

Tolerances, fp32: the latents within 1e-5 relative L2 (the same
arithmetic in another summation order: cuDNN-less grouped convs, the LSTM;
~5e-7 here); the tokens the reference's except at near-ties, where the
first differing stage's two codewords' distances to the residual differ by
at most 1e-4 of its squared norm (the near-tie rule of the port's kernel
tests); the float decode of the served tokens within 1e-5 relative L2 of
the reference's decode of the same tokens, and the served PCM16 within one
step of it. bf16: the latents and that decode within 0.03 relative L2
(bf16 keeps 8 bits: ~4e-3 a rounding, the 2D stacks' ~20 layers
compound it to ~1e-2), the tokens within a mean score gap of 0.02 of the
stage's spread. The faults below each break one of these.
"""

import numpy as np
import pytest
import torch

from benchmark.harness import weights
from benchmark.reference import codec as ref
from benchmark.reference import freqcodec as fref
from funcodec_tpu_torch.cli.codec_inference import Speech2Token, _bucket_length, _wrap_pad
from funcodec_tpu_torch.models.freqcodec import FreqCodec
from funcodec_tpu_torch.ops import conv
from funcodec_tpu_torch.quant import rvq

torch.set_num_threads(1)

HOP, N_Q, SEED = 32, 4, 2**40 + 19
ILENS = [3200, 3190, 3101, 3073]  # 0.2 s and below, all in the 112-frame bucket (> 3584 - 16 x 32)
LATENT_TOL, RECON_TOL, NEAR_TIE = 1e-5, 1e-5, 1e-4
BF16_TOL, BF16_GAP = 0.03, 0.02


def tiny_config() -> dict:
    seanet = {"ratios": [[4, 1], [4, 2]], "norm": "time_group_norm", "causal": False, "dilation_base": 1,
              "n_filters": 8, "conv_group_ratio": 2}
    return {
        "input_size": 3,
        "encoder": "encodec_seanet_encoder_2d", "encoder_conf": dict(seanet),
        "quantizer": "costume_quantizer",
        "quantizer_conf": {"codebook_size": 64, "num_quantizers": N_Q, "ema_decay": 0.99, "kmeans_init": False,
                           "sampling_rate": 16000, "encoder_hop_length": HOP},
        "decoder": "encodec_seanet_decoder_2d",
        "decoder_conf": dict(seanet, channels=3, tr_conv_group_ratio=2),
        "model": "freq_codec",
        "model_conf": {"odim": 16, "target_sample_hz": 16000, "audio_normalize": True, "segment_dur": None,
                       "overlap_ratio": None, "codec_domain": ["mag_phase", "mag_phase"], "domain_n_fft": 32,
                       "domain_hop_length": 16},
    }


@pytest.fixture(scope="module")
def setup():
    """(reference, weights, fp32 Speech2Token, padded int16 rows)."""
    codec = fref.FreqCodec.from_config(tiny_config())
    sd = weights.draw(codec.param_specs(), SEED, "cpu", {})
    s2t = Speech2Token(tiny_config(), None, dtype="float32", bit_width=None, device="cpu")
    s2t.model.load_state_dict(sd, strict=True)
    rs = np.random.RandomState(5)
    rows = [(rs.randn(n) * 3000).astype(np.int16) for n in ILENS]
    return codec, sd, s2t, _wrap_pad(rows, _bucket_length(max(ILENS), HOP))


@pytest.fixture(autouse=True)
def plain(monkeypatch):
    """The kernel switches off (another test may have set them): the CPU runs the plain path."""
    for module, flag in ((rvq, "FUSED_RVQ"), (conv, "FUSED_STRIDE1"), (conv, "FUSED_RESBLOCK")):
        monkeypatch.setattr(module, flag, False)


def serve(s2t, pcm, ilens=ILENS):
    """What the cell serves: (tokens (n_q, B, frames), PCM16 (B, T))."""
    codes, _, recon, _ = s2t.collect(s2t.dispatch(pcm, bit_width=None, pcm16_ilens=ilens), need_sub_quants=False)
    return codes[0], recon


def row_tokens(tokens, ilens, lost: int = 0):
    """Each row's tokens trimmed to its valid frames, ceil(ilen / hop) (the
    CLI's trim), `lost` fewer as a fault."""
    return [tokens[:, i, : -(-n // HOP) - lost] for i, n in enumerate(ilens)]


def _wav(pcm) -> torch.Tensor:
    return torch.from_numpy(pcm.astype(np.float32) / 32768.0)


def token_check(codec, sd, pcm, rows, ilens=ILENS):
    """(flips, worst near-tie gap) of each row's served tokens against the
    reference's greedy search on the reference's latents of the same padded
    row; raises where a row has another frame count than its valid frames
    (the frames whose first sample lies inside the row)."""
    z, _ = fref.encode_latents(codec, sd, _wav(pcm))
    embed = sd["quantizer.rq.model.embed"].float()
    flips, worst = 0, 0.0
    for i, (n, served) in enumerate(zip(ilens, rows)):
        valid = sum(1 for j in range(z.shape[1]) if j * codec.hop < n)
        if served.shape != (N_Q, valid):
            raise AssertionError(f"row {i}: {served.shape[1]} frames served, {valid} valid")
        for t in range(valid):
            r = z[i, t].double()
            for q in range(N_Q):
                d = (r[None] - embed[q].double()).square().sum(-1)
                best, got = int(d.argmin()), int(served[q, t])
                if got != best:
                    flips += 1
                    worst = max(worst, float((d[got] - d[best]) / r.square().sum()))
                    break
                r = r - embed[q, best].double()
    return flips, worst


def recon_check(codec, sd, s2t, pcm, tokens, pcm16, ilens=ILENS):
    """(float decode rel L2, max |PCM16 step|): the served tokens decoded by
    the port (float, the scale of the row's own encode) and by the reference."""
    wav = _wav(pcm)
    _, scale = fref.encode_latents(codec, sd, wav)
    want = fref.decode(codec, sd, ref.rvq_decode(sd, torch.from_numpy(np.asarray(tokens, np.int64))), scale)
    want = want[:, : wav.shape[1]]
    with torch.no_grad():
        model = s2t.model
        emb = model.quantizer.decode(torch.from_numpy(np.asarray(tokens, np.int64)))
        _, port_scale = model._encode(wav.to(next(model.parameters()).dtype))[0]
        got = model._decode([(emb, port_scale)])[:, : wav.shape[1]].float()
    rel = float((got - want).norm() / want.norm())
    steps = max(int(np.abs(pcm16[i, :n].astype(int) - ref.pcm16_float(want, torch.tensor(ilens))[i, :n]
                           .round().numpy().astype(int)).max()) for i, n in enumerate(ilens))
    return rel, steps


def test_bucket_gives_k_plus_one_frames(setup):
    """A center STFT over a bucket of k x hop samples has 2k + 1 frames, the
    time stride 2 makes k + 1 codec frames; PCM16 comes back for the whole
    bucket, each row peak-scaled over its own valid samples."""
    codec, _, s2t, pcm = setup
    tokens, pcm16 = serve(s2t, pcm)
    k = pcm.shape[1] // HOP
    assert tokens.shape == (N_Q, len(ILENS), k + 1) == (N_Q, len(ILENS), codec.frames(pcm.shape[1]))
    assert pcm16.shape == pcm.shape and pcm16.dtype == np.int16


def test_latents_match_the_reference(setup):
    codec, sd, s2t, pcm = setup
    wav = _wav(pcm)
    z, _ = fref.encode_latents(codec, sd, wav)
    with torch.no_grad():
        got = s2t.model._encode(wav)[0][0]
    assert got.shape == z.shape
    assert float((got - z).norm() / z.norm()) <= LATENT_TOL


def test_tokens_and_recon_match_the_reference(setup):
    codec, sd, s2t, pcm = setup
    tokens, pcm16 = serve(s2t, pcm)
    flips, worst = token_check(codec, sd, pcm, row_tokens(tokens, ILENS))
    assert worst <= NEAR_TIE and flips <= 2, (flips, worst)
    rel, steps = recon_check(codec, sd, s2t, pcm, tokens, pcm16)
    assert rel <= RECON_TOL and steps <= 1, (rel, steps)


def test_bf16_within_its_tolerance(setup):
    codec, sd, _, pcm = setup
    s2t = Speech2Token(tiny_config(), None, dtype="bfloat16", bit_width=None, device="cpu")
    s2t.model.load_state_dict(sd, strict=True)
    wav = _wav(pcm)
    z, _ = fref.encode_latents(codec, sd, wav)
    with torch.no_grad():
        got = s2t.model._encode(wav.bfloat16())[0][0].float()
    assert float((got - z).norm() / z.norm()) <= BF16_TOL
    tokens, pcm16 = serve(s2t, pcm)
    gaps = []
    for i, served in enumerate(row_tokens(tokens, ILENS)):
        r = z[i, : served.shape[1]]
        embed = sd["quantizer.rq.model.embed"].float()
        for q in range(N_Q):
            s = ref.scores(r, embed[q])
            chosen = torch.from_numpy(np.asarray(served[q], np.int64))
            gaps.append((s.max(-1).values - s.gather(1, chosen[:, None])[:, 0]) / s.std(-1))
            r = r - embed[q][chosen]
    assert float(torch.cat(gaps).mean()) <= BF16_GAP
    rel, _ = recon_check(codec, sd, s2t, pcm, tokens, pcm16)
    assert rel <= BF16_TOL


def _holds(codec, sd, s2t, pcm, lost: int = 0) -> bool:
    tokens, pcm16 = serve(s2t, pcm)
    try:
        flips, worst = token_check(codec, sd, pcm, row_tokens(tokens, ILENS, lost))
    except AssertionError:
        return False
    rel, steps = recon_check(codec, sd, s2t, pcm, tokens, pcm16)
    return worst <= NEAR_TIE and flips <= 2 and rel <= RECON_TOL and steps <= 1


def _affine_dropped(apply_post_norm):
    def wrapped(spec, y, norm_scale, norm_bias):
        if norm_scale is not None and y.dim() == 4:
            norm_scale, norm_bias = torch.ones_like(norm_scale), torch.zeros_like(norm_bias)
        return apply_post_norm(spec, y, norm_scale, norm_bias)
    return wrapped


def _phase_swapped(features):
    def wrapped(self, x, scale):
        feats, scale = features(self, x, scale)
        return feats[:, [0, 2, 1]], scale
    return wrapped


@pytest.mark.parametrize("fault", ["none", "2d_norm_affine_dropped", "phase_channels_swapped", "frame_lost_in_trim"])
def test_faults_fail_the_comparison(setup, monkeypatch, fault):
    codec, sd, s2t, pcm = setup
    lost = 0
    if fault == "2d_norm_affine_dropped":
        monkeypatch.setattr(conv, "apply_post_norm", _affine_dropped(conv.apply_post_norm))
    elif fault == "phase_channels_swapped":
        monkeypatch.setattr(FreqCodec, "_features", _phase_swapped(FreqCodec._features))
    elif fault == "frame_lost_in_trim":
        lost = 1
    assert _holds(codec, sd, s2t, pcm, lost) is (fault == "none")
