"""The port's file-to-file CLI against funcodec_tpu's, on the CPU.

One tiny config (test_torch_encodec._config) as yaml and one model.pth saved
from the port drive both packages' inference_pipeline over the same wav.scp:
4 utterances of ragged length, one of them at 24 kHz (resampled on read).
The fp32 tokens are exact, so codecs.txt and indices.ark/.scp must be
byte-equal; the reconstructions differ only in summation order, so every wav
is held within 1 PCM16 step and the codec embeddings within 1e-5.
"""

import json

import numpy as np
import pytest
import torch
import yaml

import funcodec_tpu.cli.codec_inference as jcli
import funcodec_tpu.data.kaldi_ark as jark
import funcodec_tpu.data.wav_io as jwav
import funcodec_tpu_torch.cli.codec_inference as tcli
import funcodec_tpu_torch.data.kaldi_ark as tark
import funcodec_tpu_torch.data.wav_io as twav
from test_torch_encodec import _config, _pair

# one torch thread per test process: the suite runs in several processes at once,
# and the small CPU ops here gain nothing from more
torch.set_num_threads(1)

# two batches of 2 that bucket to one padded length, so each JAX run mode compiles once
LENGTHS = {"utt_a": (700, 16000), "utt_b": (900, 16000), "utt_c": (1020, 16000), "utt_d": (1500, 24000)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    config = _config()
    (root / "config.yaml").write_text(yaml.safe_dump(config))
    _, _, _, tm = _pair(config)
    torch.save(tm.state_dict(), root / "model.pth")
    rs = np.random.RandomState(7)
    lines = []
    for key, (n, sr) in LENGTHS.items():
        pcm = np.clip(rs.randn(n) * 0.2 * 32768, -32768, 32767).astype(np.int16)
        jwav.write_wav(root / f"{key}.in.wav", pcm, sr)
        lines.append(f"{key} {root / f'{key}.in.wav'}")
    (root / "wav.scp").write_text("\n".join(lines) + "\n")
    return root


def _run(pkg, model, root, out, triple, **kw):
    pkg.inference_pipeline(
        output_dir=str(out), config_file=str(root / "config.yaml"), model_file=str(root / "model.pth"),
        data_path_and_name_and_type=[triple], batch_size=2, bit_width=None, model=model,
        num_reader_threads=2, num_writer_threads=2, **kw,
    )


@pytest.fixture(scope="module")
def runs(corpus):
    """Each package: inference to json (with codec_emb), inference to ark,
    decode from codecs.txt and from indices.scp. One model per package, so
    each JAX bucket shape compiles once."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcli, "_CACHE_DIR", "disabled")
    try:
        cfg, pth = str(corpus / "config.yaml"), str(corpus / "model.pth")
        models = {"jax": jcli.Speech2Token(cfg, pth, bit_width=None),
                  "torch": tcli.Speech2Token(cfg, pth, bit_width=None, device="cpu")}
        pkgs = {"jax": jcli, "torch": tcli}
        out = {}
        for name, pkg in pkgs.items():
            d = corpus / name
            sound = (str(corpus / "wav.scp"), "speech", "sound")
            _run(pkg, models[name], corpus, d / "json", sound, need_sub_quants=True)
            _run(pkg, models[name], corpus, d / "ark", sound, indices_save_type="ark")
            _run(pkg, models[name], corpus, d / "dec_json", (str(d / "json" / "codecs.txt"), "speech", "codec_json"),
                 run_mod="decode")
            _run(pkg, models[name], corpus, d / "dec_ark", (str(d / "ark" / "indices.scp"), "speech", "kaldi_ark"),
                 run_mod="decode")
            out[name] = d
    finally:
        mp.undo()
    return out


def test_codecs_txt_byte_equal(runs):
    port = (runs["torch"] / "json" / "codecs.txt").read_bytes()
    assert port == (runs["jax"] / "json" / "codecs.txt").read_bytes()
    lines = dict(line.split(" ", 1) for line in port.decode().splitlines())
    assert sorted(lines) == sorted(LENGTHS)
    for key, (n, sr) in LENGTHS.items():
        frames = -(-(-(-n * 16000 // sr)) // 8)
        assert np.asarray(json.loads(lines[key])).shape == (1, 4, frames)


def test_indices_ark_scp_byte_equal(runs):
    for name in ("indices.ark", "indices.scp"):
        port = (runs["torch"] / "ark" / name).read_bytes()
        ref = (runs["jax"] / "ark" / name).read_bytes()
        if name.endswith(".scp"):  # the scp names each package's own ark path
            port = port.replace(str(runs["torch"]).encode(), b"OUT")
            ref = ref.replace(str(runs["jax"]).encode(), b"OUT")
        assert port == ref, name


def test_codec_emb_within_tolerance(runs):
    port = tark.load_ark(runs["torch"] / "json" / "codec_emb.ark")
    ref = jark.load_ark(runs["jax"] / "json" / "codec_emb.ark")
    assert sorted(port) == sorted(ref) == sorted(LENGTHS)
    for key in ref:
        assert port[key].shape == ref[key].shape and port[key].shape[1] == 4 * 16
        np.testing.assert_allclose(port[key], ref[key], atol=1e-5, rtol=0)


@pytest.mark.parametrize("run", ["json", "ark", "dec_json", "dec_ark"])
def test_wavs_within_one_pcm16_step(runs, run):
    for key, (n, sr) in LENGTHS.items():
        p_sr, port = twav.read_wav(runs["torch"] / run / f"{key}.wav", normalize=False)
        r_sr, ref = jwav.read_wav(runs["jax"] / run / f"{key}.wav", normalize=False)
        assert p_sr == r_sr == 16000 and port.dtype == ref.dtype == np.int16
        assert port.shape == ref.shape
        if not run.startswith("dec"):  # an encode-decode run keeps each input's length
            assert port.shape == (-(-n * 16000 // sr),)
        assert np.abs(port.astype(np.int32) - ref.astype(np.int32)).max() <= 1, (run, key)


def test_writers_write_the_jax_bytes(tmp_path):
    rs = np.random.RandomState(3)
    wav = (0.3 * rs.randn(501)).astype(np.float32)
    pcm = (rs.randn(300, 2) * 3000).astype(np.int16)
    mat = rs.randn(7, 12).astype(np.float32)
    for mod, d in ((jwav, "j"), (twav, "t")):
        (tmp_path / d).mkdir()
        mod.write_wav(tmp_path / d / "a.wav", wav, 16000)
        mod.write_wav(tmp_path / d / "b.wav", pcm, 24000)
        mod.write_wav(tmp_path / d / "c.wav", wav, 8000, bits=32)
        mod.save_audio(3.0 * wav, tmp_path / d / "d.wav", 16000, rescale=True)
        with mod.WavArkWriter(tmp_path / d / "w.ark", tmp_path / d / "w.scp") as w:
            w("k1", 16000, wav)
            w("k2", 24000, pcm[:, 0])
    for mod, d in ((jark, "j"), (tark, "t")):
        with mod.ArkWriter(tmp_path / d / "m.ark", tmp_path / d / "m.scp") as w:
            w("k1", mat)
            w("k2", mat[:3].astype(np.float64))
    for name in ("a.wav", "b.wav", "c.wav", "d.wav", "w.ark", "m.ark"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    reader = twav.SoundScpReader(tmp_path / "t" / "w.scp")
    np.testing.assert_array_equal(reader["k2"][1], jwav.SoundScpReader(tmp_path / "j" / "w.scp")["k2"][1])
    np.testing.assert_array_equal(tark.ArkScpReader(tmp_path / "t" / "m.scp")["k2"], mat[:3])
    assert twav.peek_wav_info(tmp_path / "t" / "b.wav") == (24000, 300, 2)


def test_speech2token_positional_arguments_match_jax(corpus, monkeypatch):
    """(config_file, model_file, dtype, sampling_rate, bit_width, data_parallel)
    mean the same in both packages."""
    monkeypatch.setattr(jcli, "_CACHE_DIR", "disabled")
    args = (str(corpus / "config.yaml"), str(corpus / "model.pth"), "float32", 24000, 16000, 1)
    j, t = jcli.Speech2Token(*args), tcli.Speech2Token(*args, device="cpu")
    for attr in ("sampling_rate", "bit_width", "data_parallel", "hop_length", "bits_per_quant"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert (t.sampling_rate, t.bit_width, t.hop_length) == (24000, 16000, 8)
    # more cards than are visible clamp, as in JAX; -1 is every visible device
    assert tcli.Speech2Token(*args[:5], 4, device="cpu").data_parallel == 1
    assert tcli.Speech2Token(*args[:5], -1, device="cpu").data_parallel == 1


def test_dispatch_pcm16_matches_jax(corpus, monkeypatch):
    """The on-device peak rescale to PCM16 over the valid samples only."""
    monkeypatch.setattr(jcli, "_CACHE_DIR", "disabled")
    cfg, pth = str(corpus / "config.yaml"), str(corpus / "model.pth")
    recon = (np.random.RandomState(4).randn(3, 256) * np.array([[0.3], [2.0], [0.0]])).astype(np.float32)
    recon[1, 200:] = 50.0  # past the valid samples: not part of the peak
    ilens = [256, 200, 256]
    ref = np.asarray(jcli.Speech2Token(cfg, pth)._pcm16(recon, ilens))
    out = tcli.pcm16(torch.from_numpy(recon), ilens).numpy()
    assert out.dtype == np.int16
    np.testing.assert_array_equal(out, ref)


def test_unported_options_raise(corpus, tmp_path, caplog):
    """--stat_flops raised until the tooling was ported: it now logs the
    serving path's cost tree before serving. The JAX package's .ckpt raised
    until its format was ported: an empty one now raises as a malformed
    file, naming it."""
    import logging

    from funcodec_tpu_torch.utils.misc import codec_flops_tree

    base = ["--config_file", str(corpus / "config.yaml"), "--model_file", str(corpus / "model.pth"),
            "--output_dir", str(tmp_path), "--data_path_and_name_and_type",
            f"{corpus / 'wav.scp'},speech,sound", "--device", "cpu", "--batch_size", "2"]
    with caplog.at_level(logging.INFO):
        tcli.main(base + ["--stat_flops"])
    model = tcli.Speech2Token(str(corpus / "config.yaml"), str(corpus / "model.pth"), device="cpu").model
    assert [r.getMessage() for r in caplog.records if "cost tree" in r.getMessage()] == [
        "\n" + codec_flops_tree(model, samples=16000)]
    assert (tmp_path / "codecs.txt").exists()
    ckpt = tmp_path / "model.ckpt"
    ckpt.write_bytes(b"")
    with pytest.raises(ValueError, match=f"{ckpt}: not a JAX checkpoint"):
        tcli.Speech2Token(str(corpus / "config.yaml"), str(ckpt), device="cpu")


def test_main_on_the_cpu_encodes_and_decodes(corpus, tmp_path):
    """main() with --device cpu at 16 kb/s (all 4 quantizers), json then decode."""
    base = ["--config_file", str(corpus / "config.yaml"), "--model_file", str(corpus / "model.pth"),
            "--device", "cpu", "--batch_size", "3", "--bit_width", "16000"]
    tcli.main(base + ["--output_dir", str(tmp_path / "enc"),
                      "--data_path_and_name_and_type", f"{corpus / 'wav.scp'},speech,sound"])
    lines = (tmp_path / "enc" / "codecs.txt").read_text().splitlines()
    assert len(lines) == len(LENGTHS)
    tcli.main(base + ["--output_dir", str(tmp_path / "dec"), "--run_mod", "decode",
                      "--data_path_and_name_and_type", f"{tmp_path / 'enc' / 'codecs.txt'},speech,codec_json"])
    for key in LENGTHS:
        sr, wav = twav.read_wav(tmp_path / "dec" / f"{key}.wav")
        frames = np.asarray(json.loads(dict(l.split(" ", 1) for l in lines)[key])).shape[-1]
        assert sr == 16000 and wav.shape == (frames * 8,)
