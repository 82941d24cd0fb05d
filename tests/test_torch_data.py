"""The port's training data pipeline, reporter and quality metrics against
funcodec_tpu's, on the CPU.

Host data is numpy in both packages, so batches are held bit for bit:
every sampler on seeded ids and lengths; the data sources; CodecDataset +
CodecPreprocessor (a seeded rng, one loader thread; crops, pads and the
RIR / noise augmentation all drawn) + collate_fn through PrefetchLoader;
MultipleSplitLoader; DeviceCachedCrops on the CPU against the JAX cache for
two epochs. The reporter's queries agree and reporter.json crosses between
the packages; reconstruction_metrics agrees to 1e-6 relative (the same
float64 numpy arithmetic, the mel filterbank and resampler being each
package's own copy). A subprocess shows that the port's training modules
import nothing of JAX.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import funcodec_tpu.data.dataset as jds
import funcodec_tpu.data.loader as jloader
import funcodec_tpu.data.preprocessor as jpre
import funcodec_tpu.data.sampler as jsampler
import funcodec_tpu.train.reporter as jrep
import funcodec_tpu.utils.quality as jquality
import funcodec_tpu_torch.data.dataset as tds
import funcodec_tpu_torch.data.loader as tloader
import funcodec_tpu_torch.data.preprocessor as tpre
import funcodec_tpu_torch.data.sampler as tsampler
import funcodec_tpu_torch.train.reporter as trep
import funcodec_tpu_torch.utils.quality as tquality
from funcodec_tpu_torch.data.device_cache import DeviceCachedCrops, gather_crops
from funcodec_tpu_torch.data.wav_io import write_wav

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MAX_LEN = 3000  # speech_max_length of the preprocessor cases


def _ids_lengths(n=23, seed=0):
    rs = np.random.RandomState(seed)
    ids = [f"utt{i:03d}" for i in rs.permutation(n)]
    lengths = {u: int(rs.randint(500, 9000)) for u in ids}
    return ids, lengths


SAMPLERS = {
    "unsorted": lambda m, ids, L: m.unsorted_batches(ids, 4, drop_last=True),
    "unsorted_keep_last": lambda m, ids, L: m.unsorted_batches(ids, 4, drop_last=False),
    "sorted": lambda m, ids, L: m.sorted_batches(ids, L, 5),
    "sorted_ascending": lambda m, ids, L: m.sorted_batches(ids, L, 3, drop_last=False, descending=False),
    "length": lambda m, ids, L: m.length_batches(ids, L, 20_000),
    "length_drop_last": lambda m, ids, L: m.length_batches(ids, L, 20_000, drop_last=True),
    "folded": lambda m, ids, L: m.folded_batches(ids, L, 8, 3000),
    "folded_drop_last": lambda m, ids, L: m.folded_batches(ids, L, 8, 3000, drop_last=True),
    "numel": lambda m, ids, L: m.numel_batches(ids, {u: (n, 2) for u, n in L.items()}, 30_000),
    "shuffle": lambda m, ids, L: m.shuffle_batches_for_epoch(m.unsorted_batches(ids, 3), seed=5, epoch=3),
    "no_shuffle": lambda m, ids, L: m.shuffle_batches_for_epoch(m.unsorted_batches(ids, 3), 5, 3, shuffle=False),
    "shard": lambda m, ids, L: m.shard_batches(m.unsorted_batches(ids, 2), 1, 3),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_samplers_match_jax(name):
    ids, lengths = _ids_lengths()
    want = SAMPLERS[name](jsampler, ids, lengths)
    got = SAMPLERS[name](tsampler, ids, lengths)
    assert got == want and len(got) > 0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 wavs (16 kHz PCM16): 4 shorter than MAX_LEN (padded), 4 longer
    (cropped); an RIR list and a noise list for the augmentation."""
    root = tmp_path_factory.mktemp("data")
    rs = np.random.RandomState(3)
    lines = []
    for i, n in enumerate([1200, 2000, 2999, 3000, 3001, 4500, 6000, 8000]):
        w = (0.3 * np.sin(2 * np.pi * (150 + 30 * i) * np.arange(n) / 16000) + 0.05 * rs.randn(n))
        p = root / f"u{i}.wav"
        write_wav(p, w.astype(np.float32), 16000)
        lines.append(f"u{i} {p}")
    (root / "wav.scp").write_text("\n".join(lines) + "\n")
    for kind, n in (("rir", 400), ("noise", 2500)):
        w = rs.randn(n).astype(np.float32) * (np.exp(-np.arange(n) / 80.0) if kind == "rir" else 0.1)
        write_wav(root / f"{kind}.wav", w.astype(np.float32), 16000)
        (root / f"{kind}.scp").write_text(f"{kind}0 {root / f'{kind}.wav'}\n")
    return root


def _loader_batches(mod_ds, mod_pre, mod_loader, corpus, augment: bool, seed: int = 11):
    kw = dict(rir_scp=str(corpus / "rir.scp"), noise_scp=str(corpus / "noise.scp"),
              rir_apply_prob=0.7, noise_apply_prob=0.7) if augment else {}
    pre = mod_pre.CodecPreprocessor(train=True, speech_max_length=MAX_LEN, rng=np.random.RandomState(seed), **kw)
    ds = mod_ds.CodecDataset([(str(corpus / "wav.scp"), "speech", "sound")], preprocess=pre)
    batches = [ds.uttids[i: i + 3] for i in range(0, len(ds), 3)]
    loader = mod_loader.PrefetchLoader(ds, batches * 2, mod_ds.collate_fn, num_workers=1, prefetch=2)
    return list(loader)


@pytest.mark.parametrize("augment", [False, True], ids=["crop_pad", "rir_noise"])
def test_dataset_preprocessor_loader_match_jax(corpus, augment):
    """Seeded rng and one loader thread: both packages draw the same crops
    (and augmentation) in the same order; the collated arrays are equal, with
    the same keys in the same order."""
    want = _loader_batches(jds, jpre, jloader, corpus, augment)
    got = _loader_batches(tds, tpre, tloader, corpus, augment)
    assert len(got) == len(want) == 6
    crops = 0
    for (gk, gb), (wk, wb) in zip(got, want):
        assert gk == wk
        assert list(gb) == list(wb) == ["speech", "speech_lengths"]
        for k in wb:
            assert gb[k].dtype == wb[k].dtype
            np.testing.assert_array_equal(gb[k], wb[k])
        assert gb["speech"].shape[1] == MAX_LEN
        crops += sum(1 for k in gk if int(k[1:]) >= 4)
    assert crops == 8  # every long utterance cropped (twice), every short one padded


def test_collate_pads_and_passes_strings_like_jax():
    rs = np.random.RandomState(0)
    items = [(f"k{i}", {"a": rs.randn(n).astype(np.float32), "tok": rs.randint(0, 9, (n, 2)),
                        "txt": f"text {i}"}) for i, n in enumerate([5, 9, 7])]
    for mode in ("constant", "wrap"):
        gk, gb = tds.collate_fn(items, pad_mode=mode)
        wk, wb = jds.collate_fn(items, pad_mode=mode)
        assert gk == wk and list(gb) == list(wb)
        for k in wb:
            if k == "txt":
                assert gb[k] == wb[k]
            else:
                np.testing.assert_array_equal(gb[k], wb[k])


def test_data_sources_match_jax(tmp_path):
    """npy / text_int / text_float / csv / codec_json / rand_int sources
    joined by utterance id (the intersection, sorted)."""
    rs = np.random.RandomState(1)
    lines = {"npy": [], "ti": [], "tf": [], "ci": [], "cj": [], "shape": []}
    for i in range(4):
        a = rs.randn(3 + i, 2).astype(np.float32)
        np.save(tmp_path / f"a{i}.npy", a)
        lines["npy"].append(f"u{i} {tmp_path / f'a{i}.npy'}")
        lines["ti"].append(f"u{i} " + " ".join(str(x) for x in rs.randint(0, 50, 4)))
        lines["tf"].append(f"u{i} " + " ".join(f"{x:.3f}" for x in rs.randn(3)))
        lines["ci"].append(f"u{i} " + ",".join(str(x) for x in rs.randint(0, 50, 5)))
        lines["cj"].append(f"u{i} " + json.dumps(rs.randint(0, 32, (1, 2, 6)).tolist()))
        lines["shape"].append(f"u{i} {2 + i},3")
    lines["ti"].append("extra 1 2")  # not in every source: dropped
    for k, v in lines.items():
        (tmp_path / f"{k}.scp").write_text("\n".join(v) + "\n")
    spec = [(str(tmp_path / "npy.scp"), "feats", "npy"), (str(tmp_path / "ti.scp"), "ids", "text_int"),
            (str(tmp_path / "tf.scp"), "vals", "text_float"), (str(tmp_path / "ci.scp"), "csv", "csv_int"),
            (str(tmp_path / "cj.scp"), "codec", "codec_json"), (str(tmp_path / "shape.scp"), "r", "rand_int_3_9")]
    want_ds, got_ds = jds.CodecDataset(spec), tds.CodecDataset(spec)
    assert got_ds.uttids == want_ds.uttids == [f"u{i}" for i in range(4)]
    assert got_ds.names() == want_ds.names()
    for u in want_ds.uttids:
        np.random.seed(9)
        _, want = want_ds[u]
        np.random.seed(9)
        _, got = got_ds.raw_item(u)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="unsupported data type"):
        tds.resolve_data_type("nope")


def test_multiple_split_loader_matches_jax():
    class Split:
        def __init__(self, tag):
            self.tag = tag

        def build_iter(self, epoch, shuffle):
            return iter([(self.tag, epoch, shuffle)])

    for shuffle in (False, True):
        got = list(tloader.MultipleSplitLoader([lambda t=t: Split(t) for t in "abcd"], seed=3,
                                               shuffle=shuffle).build_iter(4))
        want = list(jloader.MultipleSplitLoader([lambda t=t: Split(t) for t in "abcd"], seed=3,
                                                shuffle=shuffle).build_iter(4))
        assert got == want


def test_prefetch_loader_raises_loader_errors():
    class Bad:
        def __getitem__(self, u):
            raise KeyError(u)

    with pytest.raises(KeyError):
        list(tloader.PrefetchLoader(Bad(), [["x"]], tds.collate_fn, num_workers=2))


# ---------------------------------------------------------------------------
# device cache
# ---------------------------------------------------------------------------


class _StubDataset:
    """raw_item over a dict uttid -> float32 waveform."""

    def __init__(self, wavs):
        self.wavs = dict(wavs)

    def raw_item(self, uid):
        return uid, {"speech": self.wavs[uid]}


def test_device_cache_crops_match_jax():
    """The same seed and epochs: the port's crops (on the CPU) equal the JAX
    cache's, rows longer than the crop, shorter ones and a 2-channel one."""
    from funcodec_tpu.data.device_cache import DeviceCachedCrops as JaxCrops

    crop = 1024
    rs = np.random.RandomState(0)
    wavs = {f"u{i:02d}": (rs.randn(700 + 211 * i) * 0.1).astype(np.float32) for i in range(12)}
    wavs["stereo"] = (rs.randn(3000, 2) * 0.1).astype(np.float32)
    ids = sorted(wavs)
    ds = _StubDataset(wavs)
    jc = JaxCrops(ds, ids, crop_len=crop, seed=7)
    tc = DeviceCachedCrops(ds, ids, crop_len=crop, seed=7, device="cpu")
    assert tc.t_max == jc.t_max and tc.padding_overhead == jc.padding_overhead and tc.nbytes() == jc.nbytes()
    batches = [ids[:5], ids[5:10], ids[10:]]
    for epoch in (1, 2):
        n = 0
        for (gk, gb), (wk, wb) in zip(tc.epoch_loader(batches, epoch), jc.epoch_loader(batches, epoch)):
            assert gk == wk
            assert gb["speech"].device.type == "cpu" and gb["speech"].dtype == torch.float32
            np.testing.assert_array_equal(gb["speech"].numpy(), np.asarray(wb["speech"]))
            n += 1
        assert n == 3


def test_gather_crops_is_the_host_gather():
    rs = np.random.RandomState(2)
    cache = rs.randn(5, 40).astype(np.float32)
    idx, off = np.array([3, 0, 3, 4]), np.array([0, 7, 30, 12])
    got = gather_crops(torch.from_numpy(cache), torch.from_numpy(idx), torch.from_numpy(off), 10)
    want = np.stack([cache[i, o: o + 10] for i, o in zip(idx, off)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_cache_padding_overhead_warning(caplog):
    """One outlier-long utterance inflates dense staging: it warns and
    exposes the ratio, as the JAX cache does."""
    wavs = {f"u{i}": np.ones(80, np.float32) for i in range(8)}
    wavs["outlier"] = np.ones(8000, np.float32)
    with caplog.at_level(logging.WARNING):
        cache = DeviceCachedCrops(_StubDataset(wavs), sorted(wavs), crop_len=64, device="cpu")
    assert cache.padding_overhead > 2.0
    assert any("pads the corpus" in r.message for r in caplog.records)


def test_device_cache_rejects_nonpositive_crop_and_missing_card():
    ds = _StubDataset({"u": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="speech_max_length"):
        DeviceCachedCrops(ds, ["u"], crop_len=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            DeviceCachedCrops(ds, ["u"], crop_len=4)  # the card by default


# ---------------------------------------------------------------------------
# reporter
# ---------------------------------------------------------------------------


def _fill(mod):
    rep = mod.Reporter()
    rs = np.random.RandomState(4)
    for epoch in range(1, 6):
        rep.set_epoch(epoch)
        for phase in ("train", "valid"):
            sub = rep.start_epoch(phase)
            for _ in range(3):
                sub.register({"loss": float(rs.rand()), "acc": float(rs.rand()), "skip": None},
                             weight=float(rs.randint(1, 4)))
            rep.finish_epoch(sub)
    return rep


def test_reporter_matches_jax_and_json_crosses():
    got, want = _fill(trep), _fill(jrep)
    assert got.state_dict() == want.state_dict()
    for key, mode in (("loss", "min"), ("acc", "max"), ("loss", "max")):
        assert got.sort_epochs("valid", key, mode) == want.sort_epochs("valid", key, mode)
        assert got.best_epoch("valid", key, mode) == want.best_epoch("valid", key, mode)
        for patience in (0, 1, 3):
            assert (got.check_early_stopping(patience, "valid", key, mode)
                    == want.check_early_stopping(patience, "valid", key, mode))
    assert got.best_epoch("valid", "absent") is None and not got.has("valid", "absent")
    # reporter.json written by one package loads in the other
    for src, dst_mod in ((got, jrep), (want, trep)):
        loaded = dst_mod.Reporter()
        loaded.load_state_dict(json.loads(json.dumps(src.state_dict())))
        assert loaded.state_dict() == src.state_dict()
        assert loaded.epoch == 5 and loaded.get_value("train", "acc", 2) == src.get_value("train", "acc", 2)


# ---------------------------------------------------------------------------
# quality metrics
# ---------------------------------------------------------------------------


def _pair(kind):
    rs = np.random.RandomState(5)
    t = np.arange(16000) / 16000.0
    ref = (0.4 * np.sin(2 * np.pi * 220 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
           + 0.1 * np.sin(2 * np.pi * 1330 * t) + 0.01 * rs.randn(t.size)).astype(np.float32)
    if kind == "clean":
        return ref, ref.copy()
    if kind == "noisy":
        return ref, (ref + 0.05 * rs.randn(t.size)).astype(np.float32)
    env = np.convolve(np.abs(ref), np.ones(801) / 801, mode="same")  # smeared envelope
    return ref, (np.sign(ref) * env * 2.0 + 0.002 * rs.randn(t.size)).astype(np.float32)


@pytest.mark.parametrize("kind", ["clean", "noisy", "smeared"])
def test_reconstruction_metrics_match_jax(kind):
    ref, deg = _pair(kind)
    got = tquality.reconstruction_metrics(ref, deg, sr=16000)
    want = jquality.reconstruction_metrics(ref, deg, sr=16000)
    assert list(got) == list(want) == ["lsd_db", "mel_distortion", "si_snr_db", "stoi", "nsim"]
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-12, err_msg=k)


# ---------------------------------------------------------------------------
# no JAX in the port
# ---------------------------------------------------------------------------

PORT_TRAINING_MODULES = [
    "funcodec_tpu_torch.data.sampler", "funcodec_tpu_torch.data.dataset", "funcodec_tpu_torch.data.preprocessor",
    "funcodec_tpu_torch.data.loader", "funcodec_tpu_torch.data.device_cache", "funcodec_tpu_torch.train.reporter",
    "funcodec_tpu_torch.train.checkpoint", "funcodec_tpu_torch.train.gan_trainer",
    "funcodec_tpu_torch.utils.quality", "funcodec_tpu_torch.utils.profiling", "funcodec_tpu_torch.cli.codec_train",
    "funcodec_tpu_torch.cli.codec_inference", "funcodec_tpu_torch.compat.from_jax",
]

_BLOCKER = """
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "funcodec_tpu"):
            raise ImportError("blocked: " + name)
for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "funcodec_tpu")]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    importlib.import_module(name)
for bad in ("jax", "flax", "funcodec_tpu"):
    try:
        importlib.import_module(bad)
    except ImportError:
        pass
    else:
        raise SystemExit("the blocker let " + bad + " through")
print("ok", len(sys.argv) - 1)
"""


def test_port_training_modules_import_no_jax():
    """Each module imports in a process where jax, flax and funcodec_tpu
    cannot be imported."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _BLOCKER, *PORT_TRAINING_MODULES], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["ok", str(len(PORT_TRAINING_MODULES))]
