"""Text tokenization: char/word tokenizers, token-id conversion, g2p gateway
(the port's copy of funcodec_tpu/data/text.py).

Behavioral reference: funcodec/text/ (build_tokenizer, CharTokenizer,
WordTokenizer, TokenIDConverter, phoneme_tokenizer.G2p_en :209) and
Text2AudioPreprocessor (datasets/preprocessor.py:947-1034).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

import numpy as np


class TextCleaner:
    """Text cleaner registry (funcodec/text/cleaner.py:13-44).

    The reference's cleaner types all shell out to external packages
    (tacotron_cleaner, jaconv, vietnamese_cleaner, …) which are not in this
    image; an empty cleaner list (the shipped-config default) is the
    identity, and requesting an unavailable type raises with a clear
    message. `whitespace` (collapse runs of whitespace) is provided natively.
    """

    _EXTERNAL = ("tacotron", "jaconv", "vietnamese", "korean_cleaner")

    def __init__(self, cleaner_types=None):
        if cleaner_types is None:
            self.cleaner_types = []
        elif isinstance(cleaner_types, str):
            self.cleaner_types = [cleaner_types]
        else:
            self.cleaner_types = list(cleaner_types)
        for t in self.cleaner_types:
            if t in self._EXTERNAL:
                raise RuntimeError(
                    f"text cleaner '{t}' needs an external package not "
                    f"available in this environment"
                )
            if t != "whitespace":
                raise RuntimeError(f"unknown text cleaner type: {t}")

    def __call__(self, text: str) -> str:
        for t in self.cleaner_types:
            if t == "whitespace":
                text = " ".join(text.split())
        return text


def load_num_sequence_text(
    path: Union[Path, str], loader_type: str = "csv_int"
) -> Dict[str, List[Union[float, int]]]:
    """`utt 1,2,3` shape/number files -> dict (fileio/read_text.py:40-90):
    loader_type text_int / text_float (space-separated) or csv_int /
    csv_float (comma-separated)."""
    if loader_type == "text_int":
        delimiter, dtype = " ", int
    elif loader_type == "text_float":
        delimiter, dtype = " ", float
    elif loader_type == "csv_int":
        delimiter, dtype = ",", int
    elif loader_type == "csv_float":
        delimiter, dtype = ",", float
    else:
        raise ValueError(f"Not supported loader_type={loader_type}")
    out: Dict[str, List[Union[float, int]]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(maxsplit=1)
            if not parts:
                continue
            value = parts[1] if len(parts) == 2 else ""
            out[parts[0]] = [dtype(v) for v in value.split(delimiter) if v != ""]
    return out


class CharTokenizer:
    def __init__(self, space_symbol: str = "<space>", non_linguistic_symbols=()):
        self.space_symbol = space_symbol
        self.non_linguistic_symbols = set(non_linguistic_symbols or ())

    def text2tokens(self, line: str) -> List[str]:
        tokens = []
        while line:
            for w in self.non_linguistic_symbols:
                if line.startswith(w):
                    tokens.append(w)
                    line = line[len(w):]
                    break
            else:
                t = line[0]
                tokens.append(self.space_symbol if t == " " else t)
                line = line[1:]
        return tokens

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return "".join(" " if t == self.space_symbol else t for t in tokens)


class WordTokenizer:
    def __init__(self, delimiter: Optional[str] = None):
        self.delimiter = delimiter

    def text2tokens(self, line: str) -> List[str]:
        return line.split(self.delimiter)

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return (self.delimiter or " ").join(tokens)


class PhonemeTokenizer:
    """Phoneme tokenizer (phoneme_tokenizer.py:209).

    g2p_type="g2p_en" uses the external package when installed;
    g2p_type="g2p_fallback" (or the default when g2p_en is missing) uses the
    self-contained rule/lexicon ARPAbet G2P in data/g2p_fallback.py, so raw
    English text synthesizes without external wheels.
    """

    def __init__(self, g2p_type: str = "g2p_en"):
        if g2p_type in ("g2p_fallback", "rule"):
            from funcodec_tpu_torch.data.g2p_fallback import G2pFallback

            self.g2p = G2pFallback()
            return
        try:
            from g2p_en import G2p  # type: ignore
        except ImportError:
            import logging

            logging.warning(
                "g2p_en is not installed; using the built-in rule/lexicon "
                "ARPAbet fallback (approximate pronunciations — install "
                "g2p_en for checkpoint-exact phonemes)"
            )
            from funcodec_tpu_torch.data.g2p_fallback import G2pFallback

            self.g2p = G2pFallback()
            return
        self.g2p = G2p()

    def text2tokens(self, line: str) -> List[str]:
        return [p for p in self.g2p(line) if p != " "]


def build_tokenizer(
    token_type: str,
    space_symbol: str = "<space>",
    non_linguistic_symbols=None,
    delimiter: Optional[str] = None,
    g2p_type: Optional[str] = None,
    bpemodel: Optional[str] = None,
    **_unused,
):
    if token_type == "char":
        return CharTokenizer(space_symbol, non_linguistic_symbols)
    if token_type == "word":
        return WordTokenizer(delimiter)
    if token_type == "phn":
        return PhonemeTokenizer(g2p_type or "g2p_en")
    if token_type == "bpe":
        from funcodec_tpu_torch.data.sentencepiece_lite import SentencepiecesTokenizer

        assert bpemodel is not None, "token_type=bpe needs bpemodel=<.model path>"
        return SentencepiecesTokenizer(bpemodel)
    raise ValueError(f"unsupported token_type {token_type}")


class TokenIDConverter:
    def __init__(self, token_list: Union[str, Path, List[str]], unk_symbol: str = "<unk>"):
        if isinstance(token_list, (str, Path)):
            with open(token_list, encoding="utf-8") as f:
                token_list = [line.rstrip("\n").split(maxsplit=1)[0] for line in f if line.strip()]
        self.token_list = list(token_list)
        self.token2id = {t: i for i, t in enumerate(self.token_list)}
        self.unk_symbol = unk_symbol
        self.unk_id = self.token2id.get(unk_symbol)

    def get_num_vocabulary_size(self) -> int:
        return len(self.token_list)

    def tokens2ids(self, tokens: Iterable[str]) -> List[int]:
        if self.unk_id is not None:
            return [self.token2id.get(t, self.unk_id) for t in tokens]
        return [self.token2id[t] for t in tokens]

    def ids2tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.token_list[i] for i in ids]


class Text2AudioPreprocessor:
    """Random codec crop + text tokenization (preprocessor.py:947-1034).

    A codec matrix longer than audio_max_duration * codec_token_rate frames
    is cropped at a start drawn from `rng` (an ``np.random.RandomState``;
    unseeded by default, as in the JAX package); a string text becomes
    token ids through the tokenizer of `token_type` and `token_list`."""

    def __init__(
        self,
        train: bool,
        audio_max_duration: int = 30,
        codec_token_rate: int = 25,
        text_name: str = "text",
        codec_name: str = "codec",
        token_list=None,
        token_type: Optional[str] = None,
        g2p_type: Optional[str] = None,
        rng: Optional[np.random.RandomState] = None,
        **tokenizer_kwargs,
    ):
        self.train = train
        self.audio_max_duration = audio_max_duration
        self.codec_token_rate = codec_token_rate
        self.text_name = text_name
        self.codec_name = codec_name
        self.rng = rng or np.random.RandomState()
        self.token_list: List[str] = []
        if token_list is not None:
            if isinstance(token_list, list):
                self.token_list = token_list
            elif os.path.exists(str(token_list)):
                with open(token_list, encoding="utf-8") as f:
                    self.token_list = [line.strip() for line in f]
        self.tokenizer = None
        self.converter = None
        if token_type is not None and self.token_list:
            self.tokenizer = build_tokenizer(token_type, g2p_type=g2p_type, **tokenizer_kwargs)
            self.converter = TokenIDConverter(self.token_list)

    @property
    def vocab_size(self) -> int:
        return len(self.token_list)

    def __call__(self, uid: str, data: Dict) -> Dict:
        if self.codec_name in data:
            codec = np.asarray(data[self.codec_name]).astype(np.int64)
            max_len = int(self.audio_max_duration * self.codec_token_rate)
            if codec.shape[0] > max_len:
                st = int(self.rng.randint(0, codec.shape[0] - max_len + 1))
                codec = codec[st: st + max_len]
            data[self.codec_name] = codec
        if self.text_name in data and self.tokenizer is not None:
            text = data[self.text_name]
            if isinstance(text, str):
                data[self.text_name] = np.array(self.converter.tokens2ids(self.tokenizer.text2tokens(text)),
                                                dtype=np.int64)
        return data
