"""Serving one batch over several model replicas (Speech2Token
data_parallel=N), the port's counterpart of tests/test_sharded_serving.py.

The JAX package serves a batch over a 1-D "data" mesh from one process; the
port holds one replica of the model on each device and gives each a
contiguous block of the batch's rows. Here four replicas live on the CPU
(``devices=["cpu"] * 4``). Five utterances at batch sizes 3 and 5 exercise
the pad rows (a batch of 3 pads 1, of 2 pads 2, of 5 pads 3).

Held: the four-replica runs' codecs.txt, indices.ark/.scp and codec_emb.ark
byte-equal to the one-replica run's, and their wavs (inference and decode)
too where each replica's block has two rows or more (batch 5: blocks of
2). A block of one row (batch 3: 1 + 1 + 1 + the pad)
takes another of torch's CPU convolution paths than a batch of several (the
reconstruction moves by about 2e-8), so there the wavs are held within one
PCM16 step, and the split itself exactly: each replica's rows are what one
replica computes for them alone. Against the JAX CLI on a 4-device CPU mesh:
codecs.txt and indices.ark byte-equal, the wavs within one PCM16 step (the
packages' reconstructions differ in summation order: tests/test_torch_cli.py).
"""

import numpy as np
import pytest
import torch
import yaml

import funcodec_tpu.cli.codec_inference as jcli
import funcodec_tpu_torch.cli.codec_inference as tcli
import funcodec_tpu_torch.data.wav_io as twav
from test_torch_encodec import _config, _pair

torch.set_num_threads(1)

LENGTHS = (1280, 1280, 2560, 2560, 2000)
REPLICAS = ["cpu"] * 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    config = _config(causal=True)
    (root / "config.yaml").write_text(yaml.safe_dump(config))
    _, _, _, tm = _pair(config)
    torch.save(tm.state_dict(), root / "model.pth")
    rs = np.random.RandomState(0)
    lines = []
    for i, n in enumerate(LENGTHS):
        w = (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * np.arange(n) / 16000) + 0.05 * rs.randn(n))
        twav.write_wav(root / f"utt{i}.in.wav", w.astype(np.float32), 16000)
        lines.append(f"utt{i} {root / f'utt{i}.in.wav'}")
    (root / "wav.scp").write_text("\n".join(lines) + "\n")
    return root


def _run(pkg, model, root, out, triple, batch_size, **kw):
    pkg.inference_pipeline(
        output_dir=str(out), config_file=str(root / "config.yaml"), model_file=str(root / "model.pth"),
        data_path_and_name_and_type=[triple], batch_size=batch_size, bit_width=None, model=model,
        num_reader_threads=2, num_writer_threads=2, **kw)
    return out


@pytest.fixture(scope="module")
def runs(corpus):
    """{(package, replicas, batch size): output root} of inference to json
    (with codec_emb), inference to ark and decode from codecs.txt."""
    cfg, pth = str(corpus / "config.yaml"), str(corpus / "model.pth")
    mp = pytest.MonkeyPatch()
    mp.setattr(jcli, "_CACHE_DIR", "disabled")
    try:
        models = {("torch", 1): tcli.Speech2Token(cfg, pth, bit_width=None, devices=["cpu"]),
                  ("torch", 4): tcli.Speech2Token(cfg, pth, bit_width=None, devices=REPLICAS),
                  ("jax", 4): jcli.Speech2Token(cfg, pth, bit_width=None, data_parallel=4)}
        pkgs = {"torch": tcli, "jax": jcli}
        out = {}
        for (pkg, n), model in models.items():
            for bs in ((3, 5) if pkg == "torch" else (3,)):
                d = corpus / f"{pkg}{n}_b{bs}"
                sound = (str(corpus / "wav.scp"), "speech", "sound")
                _run(pkgs[pkg], model, corpus, d / "json", sound, bs, need_sub_quants=pkg == "torch")
                _run(pkgs[pkg], model, corpus, d / "ark", sound, bs, indices_save_type="ark")
                _run(pkgs[pkg], model, corpus, d / "dec", (str(d / "json" / "codecs.txt"), "speech", "codec_json"),
                     bs, run_mod="decode")
                out[(pkg, n, bs)] = d
    finally:
        mp.undo()
    return out


def _wav(path):
    return twav.read_wav(path, normalize=False)[1]


def _scp(d, root):
    return (d / "ark" / "indices.scp").read_bytes().replace(str(root).encode(), b"OUT")


@pytest.mark.parametrize("batch_size", [3, 5])
def test_replicas_write_the_one_replica_bytes(runs, batch_size):
    one, four = runs[("torch", 1, batch_size)], runs[("torch", 4, batch_size)]
    for f in ("json/codecs.txt", "json/codec_emb.ark", "ark/indices.ark"):
        assert (four / f).read_bytes() == (one / f).read_bytes(), f
    assert _scp(four, four) == _scp(one, one)
    for run in ("json", "ark", "dec"):
        for i in range(len(LENGTHS)):
            a, b = four / run / f"utt{i}.wav", one / run / f"utt{i}.wav"
            if batch_size == 5:  # blocks of 2 rows: byte-equal
                assert a.read_bytes() == b.read_bytes(), (run, i)
            else:  # blocks of 1 row: another CPU convolution path
                p, r = _wav(a), _wav(b)
                assert p.shape == r.shape and np.abs(p.astype(np.int32) - r.astype(np.int32)).max() <= 1, (run, i)


def test_replicas_match_the_jax_mesh(runs):
    port, ref = runs[("torch", 4, 3)], runs[("jax", 4, 3)]
    assert (port / "json" / "codecs.txt").read_bytes() == (ref / "json" / "codecs.txt").read_bytes()
    assert (port / "ark" / "indices.ark").read_bytes() == (ref / "ark" / "indices.ark").read_bytes()
    assert _scp(port, port) == _scp(ref, ref)
    for run in ("json", "ark", "dec"):
        for i, n in enumerate(LENGTHS):
            p, r = _wav(port / run / f"utt{i}.wav"), _wav(ref / run / f"utt{i}.wav")
            assert p.shape == r.shape and p.dtype == r.dtype == np.int16
            assert np.abs(p.astype(np.int32) - r.astype(np.int32)).max() <= 1, (run, i)


def test_dispatch_pads_and_collect_strips(corpus):
    """A batch of 3 on four replicas pads one row (the last, repeated) and
    collect() strips it: each replica's block is what one replica computes
    for those rows alone, the tokens are the unsharded call's, and the
    reconstruction differs from it by summation order only."""
    cfg, pth = str(corpus / "config.yaml"), str(corpus / "model.pth")
    m1 = tcli.Speech2Token(cfg, pth, bit_width=None, devices=["cpu"])
    m4 = tcli.Speech2Token(cfg, pth, bit_width=None, devices=REPLICAS)
    speech = (np.random.RandomState(3).randn(3, 1024) * 0.2).astype(np.float32)
    out4 = m4.dispatch(speech, run_mod="inference")
    assert out4["_row_pad"] == 1 and len(out4["_replicas"]) == 4
    codes4, embs4, recon4, _ = tcli.Speech2Token.collect(out4)
    codes1, embs1, recon1, _ = m1.collect(m1.dispatch(speech, run_mod="inference"))
    assert codes4[0].shape == codes1[0].shape == (4, 3, 128)
    np.testing.assert_array_equal(codes4[0], codes1[0])
    assert recon4.shape == recon1.shape == (3, 1024)
    rows = [m1.collect(m1.dispatch(speech[i:i + 1], run_mod="inference"))[2] for i in range(3)]
    np.testing.assert_array_equal(recon4, np.concatenate(rows))
    np.testing.assert_allclose(recon4, recon1, atol=1e-6, rtol=0)
    assert embs4[0][0].shape == embs1[0][0].shape and embs4[0][1].shape == embs1[0][1].shape == (3, 1)


def test_replicas_own_their_weights(corpus):
    """Each replica is a copy of its own (the kernels cache packed weights on
    the tensors), with the same values; data_parallel without devices is
    clamped to the visible cards (none here: one)."""
    cfg, pth = str(corpus / "config.yaml"), str(corpus / "model.pth")
    m = tcli.Speech2Token(cfg, pth, bit_width=None, devices=["cpu", "cpu"])
    assert m.data_parallel == 2 and m.replicas[0] is m.model
    a, b = (dict(r.state_dict()) for r in m.replicas)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].data_ptr() != b[k].data_ptr() and torch.equal(a[k], b[k]), k
    assert tcli.Speech2Token(cfg, pth, data_parallel=4, device="cpu").data_parallel == 1
    with pytest.raises(ValueError):
        tcli.Speech2Token(cfg, pth, devices=[])
