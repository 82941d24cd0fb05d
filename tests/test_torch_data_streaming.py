"""The streaming data modules of the port (data/chunk_iter.py,
data/streaming.py, data/text.load_num_sequence_text) against funcodec_tpu's
on one corpus and seed: the same batches, keys and values.

The corpus is tests/test_data_utils.py's (five noise utterances of 900 to
2,232 samples at 16 kHz); the data.list comes from the JAX package's
utils/shape_utils.generate_data_list, which both loaders read.
"""

import numpy as np
import pytest

from funcodec_tpu.data import chunk_iter as jchunk, streaming as jstream, text as jtext
from funcodec_tpu.data.dataset import CodecDataset as JDataset
from funcodec_tpu.data.wav_io import write_wav
from funcodec_tpu.utils.shape_utils import generate_data_list
from funcodec_tpu_torch.data import chunk_iter as tchunk, streaming as tstream, text as ttext
from funcodec_tpu_torch.data.dataset import CodecDataset as TDataset


@pytest.fixture()
def wav_corpus(tmp_path):
    rng = np.random.RandomState(0)
    (tmp_path / "train").mkdir()
    lines = []
    for i in range(5):
        t = 900 + 333 * i
        p = tmp_path / f"u{i}.wav"
        write_wav(p, np.clip((0.2 * rng.randn(t)).astype(np.float32), -1, 1), 16000)
        lines.append(f"u{i} {p}")
    (tmp_path / "train" / "wav.scp").write_text("\n".join(lines) + "\n")
    return tmp_path


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for (gk, gb), (wk, wb) in zip(got, want):
        assert gk == wk
        assert set(gb) == set(wb)
        for name in wb:
            assert gb[name].dtype == wb[name].dtype, name
            np.testing.assert_array_equal(gb[name], wb[name], err_msg=name)


@pytest.mark.parametrize("chunk_length,shuffle,epoch", [("512", True, 1), ("400,800", True, 3),
                                                         ([512, 1000], False, 0)])
def test_chunk_iter_factory_matches_jax(wav_corpus, chunk_length, shuffle, epoch):
    scp = [(str(wav_corpus / "train" / "wav.scp"), "speech", "sound")]
    kw = dict(batch_size=3, chunk_length=chunk_length, chunk_shift_ratio=0.5, seed=7, shuffle=shuffle)
    got = list(tchunk.ChunkIterFactory(TDataset(scp), **kw).build_iter(epoch))
    want = list(jchunk.ChunkIterFactory(JDataset(scp), **kw).build_iter(epoch))
    _assert_same_batches(got, want)
    for _, b in got:  # fixed chunk shapes
        assert b["speech"].shape[1] == int(b["speech_lengths"][0])
    assert tchunk.parse_chunk_lengths("400,800") == jchunk.parse_chunk_lengths("400,800") == [400, 800]


@pytest.mark.parametrize("shuffle", [True, False])
def test_streaming_loader_matches_jax(wav_corpus, shuffle):
    dl = generate_data_list(str(wav_corpus), "train")
    kw = dict(batch_size=2, min_length=1000, shuffle=shuffle, shuffle_buffer_size=4, sort_buffer_size=4, seed=3)
    for epoch in (0, 1):
        got = list(tstream.LargeDataLoader([dl], **kw).build_iter(epoch=epoch))
        want = list(jstream.LargeDataLoader([dl], **kw).build_iter(epoch=epoch))
        _assert_same_batches(got, want)
        assert sorted(k for keys, _ in got for k in keys) == ["u1", "u2", "u3", "u4"]


def test_streaming_ops_match_jax(wav_corpus, tmp_path):
    """The ops one by one: a resample to 8 kHz, a preprocess, an unreadable wav skipped."""
    dl = generate_data_list(str(wav_corpus), "train")
    bad = tmp_path / "bad.list"
    bad.write_text(open(dl).read() + '{"key": "broken", "wav": "%s"}\n' % (tmp_path / "train" / "wav.scp"))

    def chain(mod):
        stream = mod.load_audio(mod.parse_list([str(bad)]), target_sr=8000)
        stream = mod.apply_preprocess(stream, lambda key, data: {"speech": data["speech"] * 0.5})
        return list(mod.batch(mod.sort_buffer(mod.shuffle_buffer(stream, 3, seed=5), 2), 3))

    _assert_same_batches(chain(tstream), chain(jstream))


@pytest.mark.parametrize("loader_type,text", [("csv_int", "a 1,2,3\nb 4\nc\n"), ("text_int", "a 1 2 3\nb 4\n"),
                                              ("csv_float", "a 1.5,2\n"), ("text_float", "x 0.25 3\n\n")])
def test_load_num_sequence_text_matches_jax(tmp_path, loader_type, text):
    p = tmp_path / "shape"
    p.write_text(text)
    got = ttext.load_num_sequence_text(p, loader_type)
    assert got == jtext.load_num_sequence_text(p, loader_type)
    assert all(type(v) is (int if loader_type.endswith("int") else float) for vals in got.values() for v in vals)
    with pytest.raises(ValueError):
        ttext.load_num_sequence_text(p, "json")
