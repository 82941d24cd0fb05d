"""The port's FreqCodec serving path against funcodec_tpu, on the CPU.

Both packages build the model from one config dict; the JAX parameters
(numpy values from a seed, laid out by the JAX init traced for shapes only)
cross over through compat/from_jax. fp32: the tokens must be JAX's
exactly, the reconstructions agree within 1e-4 (2D convs, LSTM and the
ISTFT in another summation order: cuFFT / pocketfft against the JAX DFT
matmuls). The CLI's codecs.txt must be byte-equal with the JAX CLI's.

Configs: the tiny mag_phase model of tests/test_seanet2d_freqcodec.py's
fixture (n_filters 4, the shipped (freq, time) ratios) at conv group
ratios -1, 1 and 2; the gr8 topology of scripts/bench_freqcodec.py at its
full width (n_filters 32: below it, gr8's n // 2 // 8 groups reach 0) on
0.1 s;
every codec domain at n_fft 64, hop 16 (tests/test_freqcodec_domains.py's
shapes).
"""

import copy
import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import funcodec_tpu.cli.codec_inference as jcli
import funcodec_tpu_torch.cli.codec_inference as tcli
import funcodec_tpu_torch.data.wav_io as twav
from funcodec_tpu.tasks.codec import build_codec_model as jbuild
from funcodec_tpu_torch.models.freqcodec import FreqCodec
from funcodec_tpu_torch.tasks.codec import build_codec_model as tbuild
from test_torch_encodec import REPO, _jit, _pair

torch.set_num_threads(1)

RECON_TOL = 1e-4


def tiny_config(conv_group_ratio=-1, n_filters=4, **model_conf):
    """tests/test_seanet2d_freqcodec.py's fixture: the shipped 2D topology
    at n_filters 4, 4 quantizers of 64 codes, 32-d latents. A group ratio r
    needs n_filters >= 4 r (a resblock's first conv has n_filters // 4 // r
    groups)."""
    seanet = {"n_filters": n_filters, "ratios": [[4, 1], [4, 1], [4, 2], [4, 1]], "norm": "time_group_norm",
              "causal": False, "dilation_base": 1, "conv_group_ratio": conv_group_ratio}
    return {
        "input_size": 3,
        "encoder": "encodec_seanet_encoder_2d", "encoder_conf": dict(seanet),
        "quantizer": "costume_quantizer",
        "quantizer_conf": {"codebook_size": 64, "num_quantizers": 4, "ema_decay": 0.99, "kmeans_init": False,
                           "sampling_rate": 16000, "encoder_hop_length": 320},
        "decoder": "encodec_seanet_decoder_2d",
        "decoder_conf": dict(seanet, channels=3, tr_conv_group_ratio=conv_group_ratio),
        "model": "freq_codec",
        "model_conf": {"odim": 32, "target_sample_hz": 16000, "audio_normalize": True, "segment_dur": None,
                       "overlap_ratio": None, "codec_domain": ["mag_phase", "mag_phase"], **model_conf},
    }


def _speech(batch=2, length=3200, seed=0):
    return (0.25 * np.random.RandomState(seed).randn(batch, length)).astype(np.float32)


def _check_inference(jm, params, state, tm, x, **kw):
    out = _jit(jm.inference, params, state, jnp.asarray(x), need_recon=True, **kw)
    with torch.no_grad():
        tout = tm.inference(torch.from_numpy(x), **kw)
    tokens = np.asarray(out["code_indices"][0])
    np.testing.assert_array_equal(tout["code_indices"][0].numpy(), tokens)
    np.testing.assert_allclose(tout["recon_speech"].numpy(), np.asarray(out["recon_speech"]),
                               atol=RECON_TOL, rtol=RECON_TOL)
    assert tout["recon_speech"].shape == x.shape
    return tokens


@pytest.mark.parametrize("ratio,n_filters", [(-1, 4), (1, 4), (2, 8)])
def test_tiny_freqcodec_modes_match_jax(ratio, n_filters):
    """inference (ragged length), inference_encoding with its recon,
    inference_decoding from the tokens and inference_decoding_emb."""
    jm, params, state, tm = _pair(tiny_config(ratio, n_filters))
    assert isinstance(tm, FreqCodec)
    x = _speech(length=3300)
    tokens = _check_inference(jm, params, state, tm, x)
    assert tokens.shape == (4, 2, 11)  # ceil((3300 // 160 + 1) / 2): 21 STFT frames, time stride 2
    x = _speech(length=3200, seed=1)
    jenc = _jit(jm.inference_encoding, params, state, jnp.asarray(x), need_recon=True)
    with torch.no_grad():
        tenc = tm.inference_encoding(torch.from_numpy(x), need_recon=True)
    tokens = np.asarray(jenc["code_indices"][0])
    np.testing.assert_array_equal(tenc["code_indices"][0].numpy(), tokens)
    np.testing.assert_allclose(tenc["recon_speech"].numpy(), np.asarray(jenc["recon_speech"]), atol=RECON_TOL)
    btq = np.ascontiguousarray(np.transpose(tokens, (1, 2, 0)))
    jdec = _jit(jm.inference_decoding, params, state, jnp.asarray(btq))
    emb = np.asarray(jdec["code_embeddings"][0][0])
    jemb = _jit(jm.inference_decoding_emb, params, state, jnp.asarray(emb))
    with torch.no_grad():
        tdec = tm.inference_decoding(torch.from_numpy(btq))
        temb = tm.inference_decoding_emb(torch.from_numpy(emb.copy()))
    np.testing.assert_allclose(tdec["recon_speech"].numpy(), np.asarray(jdec["recon_speech"]), atol=RECON_TOL)
    np.testing.assert_allclose(temb["recon_speech"].numpy(), np.asarray(jemb["recon_speech"]), atol=RECON_TOL)


def _bench_freq_config(monkeypatch, gr):
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    import bench_freqcodec

    return bench_freqcodec.freq_config(gr)


@pytest.mark.parametrize("gr,count", [(8, 9_932_201), (1, 9_418_793)])
def test_freq_config_param_counts_match_jax(monkeypatch, gr, count):
    """Construct only: scripts/bench_freqcodec.freq_config builds the same
    parameters in both packages (JAX counted by shape), chip_smoke.py's copy
    of the config is the script's, and the encoder and decoder counts are
    the ones the JAX package gives."""
    config = _bench_freq_config(monkeypatch, gr)
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    assert chip_smoke.freq_config(gr) == config
    jm, _ = jbuild(copy.deepcopy(config))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))[0]
    j_count = {k: sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes[k]))
               for k in ("encoder", "decoder")}
    tm, _ = tbuild(config, device="cpu")
    t_count = {k: sum(p.numel() for p in getattr(tm, k).parameters()) for k in ("encoder", "decoder")}
    assert t_count == j_count
    assert sum(p.numel() for p in tm.parameters()) == count
    assert tuple(tm.quantizer.state.embed.shape) == (32, 1024, 128)


def test_gr8_full_width_matches_jax(monkeypatch):
    """gr8 at its published width (8-group convs, 128-d latents) on 0.1 s,
    with 4 of its 32 quantizers to keep the JAX compile short."""
    config = _bench_freq_config(monkeypatch, 8)
    config["quantizer_conf"]["num_quantizers"] = 4
    jm, params, state, tm = _pair(config)
    enc = tm.encoder.model
    # _groups: the 32 -> 64 downsample 32 // 2 // 8, the 256-wide resblock's k3 conv 128 // 2 // 8
    assert (enc[1].block[1].spec.groups, enc[3].spec.groups, enc[10].block[1].spec.groups) == (1, 2, 8)
    tokens = _check_inference(jm, params, state, tm, _speech(batch=1, length=1600, seed=2))
    assert tokens.shape == (4, 1, 6)


# (enc domain, dec domain, encoder input channels, decoder output channels, T)
DOMAINS = [
    ("time", "time", 1, 1, 4096),
    ("stft", "stft", 2, 2, 4096),
    ("mag", "mag_phase", 1, 3, 4096),
    ("mag_phase", "mag_phase", 3, 3, 4096),
    ("mag_angle", "mag_angle", 2, 2, 4096),
    ("mag_oracle_phase", "mag_oracle_phase", 1, 1, 4080),
    ("mel", "mag_phase", 1, 3, 4096),
    ("mag_phase", "time", 3, 1, 4096),  # a time decoder over spectral tokens: the hop // 2 trims
]


def domain_config(enc, dec, in_ch, out_ch):
    """tests/test_freqcodec_domains.py's tiny config (n_fft 64, hop 16); a
    time-domain side takes the 1D SEANet, the mel encoder its 80-bin ratios."""
    seanet2d = {"n_filters": 4, "norm": "time_group_norm", "causal": False, "dilation_base": 1,
                "ratios": [[4, 1], [4, 2], [2, 1]]}
    seanet1d = {"n_filters": 4, "norm": "time_group_norm", "ratios": [8, 4]}
    enc_conf = dict(seanet2d, ratios=[[4, 1], [4, 2], [5, 1]]) if enc == "mel" else seanet2d
    return {
        "input_size": in_ch,
        "encoder": "encodec_seanet_encoder" if enc == "time" else "encodec_seanet_encoder_2d",
        "encoder_conf": dict(seanet1d if enc == "time" else enc_conf),
        "quantizer": "costume_quantizer",
        "quantizer_conf": {"codebook_size": 32, "num_quantizers": 4, "ema_decay": 0.9, "kmeans_init": False,
                           "sampling_rate": 16000, "encoder_hop_length": 32},
        "decoder": "encodec_seanet_decoder" if dec == "time" else "encodec_seanet_decoder_2d",
        "decoder_conf": dict(seanet1d if dec == "time" else seanet2d, channels=out_ch),
        "model": "freq_codec",
        "model_conf": {"odim": 16, "target_sample_hz": 16000, "audio_normalize": True, "segment_dur": None,
                       "overlap_ratio": None, "codec_domain": [enc, dec], "domain_conf": {"n_fft": 64,
                                                                                       "hop_length": 16}},
    }


def _snap_real(stft_fn, xp):
    """`stft_fn` with each value within 1e-5 of the real axis (relative to
    its real part) set exactly real. Exact arithmetic makes the DC and
    Nyquist bins real in every frame, and every bin of frame 0 (a center=True
    reflect-padded frame is symmetric about x[0]); each package leaves
    rounding noise of either sign there, and mag_angle's angle feature jumps
    between +pi and -pi with that sign."""

    def snapped(*args, **kwargs):
        spec = stft_fn(*args, **kwargs)
        re, im = xp.real(spec), xp.imag(spec)
        im = xp.where(xp.abs(im) <= 1e-5 * xp.abs(re), xp.zeros_like(im), im)
        return re + 1j * im

    return snapped


@pytest.mark.parametrize("enc,dec,in_ch,out_ch,T", DOMAINS, ids=[f"{e}-{d}" for e, d, *_ in DOMAINS])
def test_domain_matches_jax(monkeypatch, enc, dec, in_ch, out_ch, T):
    if enc == "mag_angle":
        import funcodec_tpu.models.freqcodec as jfreq
        import funcodec_tpu_torch.models.freqcodec as tfreq

        monkeypatch.setattr(jfreq, "stft", _snap_real(jfreq.stft, jnp))
        monkeypatch.setattr(tfreq, "stft", _snap_real(tfreq.stft, torch))
    jm, params, state, tm = _pair(domain_config(enc, dec, in_ch, out_ch))
    assert tm.cfg.domain_n_fft == 64 and tm.cfg.domain_hop_length == 16
    tokens = _check_inference(jm, params, state, tm, _speech(length=T, seed=3))
    assert tokens.shape[:2] == (4, 2)


def test_unknown_domain_raises():
    config = domain_config("mag_phase", "mel", 3, 1)  # mel is an encode domain only
    tm, _ = tbuild(config, device="cpu")
    with pytest.raises(ValueError):
        tm.inference(torch.zeros(1, 1024))


# ---------------------------------------------------------------------------
# the CLI: codecs.txt byte-equal with the JAX CLI's
# ---------------------------------------------------------------------------

LENGTHS = {"utt_a": 3000, "utt_b": 3700, "utt_c": 4100, "utt_d": 2500}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both packages' inference_pipeline over one wav.scp of 4 seeded
    utterances (two batches of 2 that bucket to one padded length), then
    decode from their own codecs.txt."""
    root = tmp_path_factory.mktemp("freq_cli")
    config = tiny_config()
    (root / "config.yaml").write_text(yaml.safe_dump(config))
    _, _, _, tm = _pair(config)
    torch.save(tm.state_dict(), root / "model.pth")
    rs = np.random.RandomState(8)
    lines = []
    for key, n in LENGTHS.items():
        pcm = np.clip(rs.randn(n) * 0.2 * 32768, -32768, 32767).astype(np.int16)
        twav.write_wav(root / f"{key}.in.wav", pcm, 16000)
        lines.append(f"{key} {root / f'{key}.in.wav'}")
    (root / "wav.scp").write_text("\n".join(lines) + "\n")
    mp = pytest.MonkeyPatch()
    mp.setattr(jcli, "_CACHE_DIR", "disabled")
    try:
        cfg, pth = str(root / "config.yaml"), str(root / "model.pth")
        models = {"jax": jcli.Speech2Token(cfg, pth, bit_width=None),
                  "torch": tcli.Speech2Token(cfg, pth, bit_width=None, device="cpu")}
        for name, pkg in (("jax", jcli), ("torch", tcli)):
            d = root / name
            common = dict(config_file=cfg, model_file=pth, batch_size=2, bit_width=None, model=models[name],
                          num_reader_threads=2, num_writer_threads=2)
            pkg.inference_pipeline(output_dir=str(d / "enc"), run_mod="encode",
                                   data_path_and_name_and_type=[(str(root / "wav.scp"), "speech", "sound")],
                                   **common)
            pkg.inference_pipeline(output_dir=str(d / "dec"), run_mod="decode",
                                   data_path_and_name_and_type=[(str(d / "enc" / "codecs.txt"), "speech",
                                                                 "codec_json")], **common)
    finally:
        mp.undo()
    return root


def test_cli_codecs_txt_byte_equal_with_jax(cli_runs):
    port = (cli_runs / "torch" / "enc" / "codecs.txt").read_bytes()
    assert port == (cli_runs / "jax" / "enc" / "codecs.txt").read_bytes()
    lines = dict(line.split(" ", 1) for line in port.decode().splitlines())
    assert sorted(lines) == sorted(LENGTHS)
    for key in LENGTHS:  # (1, n_q, frames): the frames the model gives, whatever the 320 bucketing did
        codes = np.asarray(json.loads(lines[key]))
        assert codes.shape[:2] == (1, 4) and codes.shape[2] > 0


def test_cli_decode_wavs_within_one_pcm16_step(cli_runs):
    for key in LENGTHS:
        p_sr, port = twav.read_wav(cli_runs / "torch" / "dec" / f"{key}.wav", normalize=False)
        r_sr, ref = twav.read_wav(cli_runs / "jax" / "dec" / f"{key}.wav", normalize=False)
        assert p_sr == r_sr == 16000 and port.shape == ref.shape and port.shape[0] > 0
        assert np.abs(port.astype(np.int32) - ref.astype(np.int32)).max() <= 1, key
