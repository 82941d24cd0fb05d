"""The port's own copies of the text front end and the TTS proxies
(data/{text,g2p_fallback,sentencepiece_lite}.py, utils/tts_quality.py) give
the JAX package's outputs on the same strings and signals."""

import pytest

import funcodec_tpu.data.g2p_fallback as jg2p
import funcodec_tpu.data.sentencepiece_lite as jspm
import funcodec_tpu.data.text as jtext
import funcodec_tpu.utils.tts_quality as jq
import funcodec_tpu_torch.data.g2p_fallback as tg2p
import funcodec_tpu_torch.data.sentencepiece_lite as tspm
import funcodec_tpu_torch.data.text as ttext
import funcodec_tpu_torch.utils.tts_quality as tq
from test_sentencepiece_lite import model_path  # noqa: F401  (the toy .model bytes)
from test_tts_quality import SPK_A, SPK_B, _voice

LINES = ["hello world", "The 21 knights, really!", "  cake  station\tphone ", "quiz checker 1999", ""]


@pytest.mark.parametrize("token_type", ["char", "word", "phn"])
def test_tokenizers_match(token_type):
    kw = {"g2p_type": "g2p_fallback"} if token_type == "phn" else {}
    ours, ref = ttext.build_tokenizer(token_type, **kw), jtext.build_tokenizer(token_type, **kw)
    for line in LINES:
        assert ours.text2tokens(line) == ref.text2tokens(line), line


def test_g2p_fallback_matches():
    for line in LINES + ["blorping cromulent phonetics"]:
        assert tg2p.G2pFallback()(line) == jg2p.G2pFallback()(line)
        assert tg2p.expand_numbers(line) == jg2p.expand_numbers(line)


def test_token_id_converter_and_cleaner_match(tmp_path):
    tokens = ["<blank>", "a", "b", "<unk>", "hello"]
    (tmp_path / "tokens.txt").write_text("\n".join(tokens) + "\n")
    for src in (tokens, str(tmp_path / "tokens.txt")):
        ours, ref = ttext.TokenIDConverter(src), jtext.TokenIDConverter(src)
        words = ["a", "hello", "zzz", "b"]
        assert ours.tokens2ids(words) == ref.tokens2ids(words) == [1, 4, 3, 2]
        assert ours.ids2tokens([4, 0]) == ref.ids2tokens([4, 0])
        assert ours.get_num_vocabulary_size() == ref.get_num_vocabulary_size()
    assert ttext.TextCleaner("whitespace")(LINES[2]) == jtext.TextCleaner("whitespace")(LINES[2])


def test_sentencepiece_lite_matches(model_path):  # noqa: F811
    ours, ref = tspm.SentencepiecesTokenizer(str(model_path)), jspm.SentencepiecesTokenizer(str(model_path))
    for line in ("hello world", "helloworld hello", "held weird"):
        assert ours.text2tokens(line) == ref.text2tokens(line), line
        assert ours.tokens2text(ours.text2tokens(line)) == ref.tokens2text(ref.text2tokens(line))
    assert ttext.build_tokenizer("bpe", bpemodel=str(model_path)).text2tokens("hello") == ref.text2tokens("hello")


def test_tts_metrics_match():
    a, b = _voice(**SPK_A, seed=1), _voice(**SPK_B, seed=2)
    for gen, prompt in ((a, b), (a, _voice(**SPK_A, seed=3)), (a[:500], b), (a, None)):
        ours, ref = tq.tts_metrics(gen, prompt=prompt), jq.tts_metrics(gen, prompt=prompt)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k] == pytest.approx(ref[k], abs=1e-6, nan_ok=True), k
    assert tq.speaker_similarity(a, b) == pytest.approx(jq.speaker_similarity(a, b), abs=1e-6)
    assert tq.mel_cepstral_distance(a, b) == pytest.approx(jq.mel_cepstral_distance(a, b), abs=1e-6)
