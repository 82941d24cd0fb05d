"""Self-contained SentencePiece model reader + encoder (the port's copy of
funcodec_tpu/data/sentencepiece_lite.py).

The reference's subword path requires the external `sentencepiece` wheel
(funcodec/text/sentencepiece_tokenizer.py:12-38), absent from this image.
This module loads a trained `.model` file directly (hand-parsed protobuf
wire format — only the `pieces` of ModelProto are needed) and segments text
with the standard unigram-LM Viterbi (greedy-longest for BPE models), so
subword tokenization works with zero external wheels.

Approximations vs the real library: no NFKC normalization (most speech
vocabularies are ASCII), no byte-fallback for pieces absent from the vocab
(unknown characters map to <unk>), no sampling/nbest segmentation. For the
shipped FunCodec recipes (char/phoneme token types) sentencepiece is never
exercised; this exists so `token_type=bpe` models load at all.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Tuple, Union

SPIECE_UNDERLINE = "▁"

# SentencePiece piece types (sentencepiece_model.proto)
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_BYTE = 6
TYPE_UNUSED = 5


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _skip_field(buf: bytes, i: int, wire: int) -> int:
    if wire == 0:
        _, i = _read_varint(buf, i)
    elif wire == 1:
        i += 8
    elif wire == 2:
        n, i = _read_varint(buf, i)
        i += n
    elif wire == 5:
        i += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return i


def _parse_piece(buf: bytes) -> Tuple[str, float, int]:
    """SentencePiece submessage: piece:1 (string), score:2 (float),
    type:3 (enum, default NORMAL)."""
    piece, score, typ = "", 0.0, TYPE_NORMAL
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, i = _read_varint(buf, i)
            piece = buf[i : i + n].decode("utf-8")
            i += n
        elif field == 2 and wire == 5:
            score = struct.unpack("<f", buf[i : i + 4])[0]
            i += 4
        elif field == 3 and wire == 0:
            typ, i = _read_varint(buf, i)
        else:
            i = _skip_field(buf, i, wire)
    return piece, score, typ


def load_model(path: Union[str, Path]) -> List[Tuple[str, float, int]]:
    """Parse ModelProto, returning [(piece, score, type), ...] in vocab order
    (ModelProto field 1 = repeated SentencePiece)."""
    buf = Path(path).read_bytes()
    pieces = []
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, i = _read_varint(buf, i)
            pieces.append(_parse_piece(buf[i : i + n]))
            i += n
        else:
            i = _skip_field(buf, i, wire)
    if not pieces:
        raise ValueError(f"{path}: no sentencepiece vocabulary found")
    return pieces


class SentencePieceLite:
    """EncodeAsPieces/DecodePieces-compatible segmenter over a .model file."""

    def __init__(self, model: Union[str, Path]):
        self.pieces = load_model(model)
        self.vocab: Dict[str, int] = {p: i for i, (p, _s, _t) in enumerate(self.pieces)}
        self.scores: Dict[str, float] = {
            p: s for p, s, t in self.pieces if t in (TYPE_NORMAL, TYPE_USER_DEFINED)
        }
        self.unk_piece = next(
            (p for p, _s, t in self.pieces if t == TYPE_UNKNOWN), "<unk>"
        )
        self.max_len = max((len(p) for p in self.scores), default=1)

    # -- encoding -------------------------------------------------------------

    def _normalize(self, text: str) -> str:
        # add_dummy_prefix + space escaping (the sentencepiece default)
        text = text.replace(" ", SPIECE_UNDERLINE)
        if not text.startswith(SPIECE_UNDERLINE):
            text = SPIECE_UNDERLINE + text
        return text

    def encode_as_pieces(self, text: str) -> List[str]:
        """Unigram Viterbi segmentation (maximum total log-prob); characters
        with no covering piece emit the unk piece."""
        s = self._normalize(text)
        n = len(s)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Tuple[int, str]] = [(0, "")] * (n + 1)
        best[0] = 0.0
        unk_penalty = min(self.scores.values(), default=-10.0) - 10.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            upper = min(n, i + self.max_len)
            matched = False
            for j in range(i + 1, upper + 1):
                piece = s[i:j]
                sc = self.scores.get(piece)
                if sc is None:
                    continue
                matched = True
                if best[i] + sc > best[j]:
                    best[j] = best[i] + sc
                    back[j] = (i, piece)
            if not matched or best[i + 1] <= NEG / 2:
                # unk fallback over one character keeps the lattice connected
                if best[i] + unk_penalty > best[i + 1]:
                    best[i + 1] = best[i] + unk_penalty
                    back[i + 1] = (i, s[i : i + 1])
        out: List[str] = []
        j = n
        while j > 0:
            i, piece = back[j]
            out.append(piece if piece in self.vocab else self.unk_piece)
            j = i
        return out[::-1]

    # reference API names (sentencepiece_tokenizer.py:32-38)
    EncodeAsPieces = encode_as_pieces

    def decode_pieces(self, pieces: List[str]) -> str:
        text = "".join(pieces)
        return text.replace(SPIECE_UNDERLINE, " ").strip()

    DecodePieces = decode_pieces


class SentencepiecesTokenizer:
    """Drop-in for the reference SentencepiecesTokenizer: uses the real
    `sentencepiece` wheel when installed, else SentencePieceLite."""

    def __init__(self, model: Union[str, Path]):
        self.model = str(model)
        try:
            import sentencepiece as spm  # type: ignore

            self.sp = spm.SentencePieceProcessor()
            self.sp.load(self.model)
        except ImportError:
            self.sp = SentencePieceLite(self.model)

    def text2tokens(self, line: str) -> List[str]:
        return list(self.sp.EncodeAsPieces(line))

    def tokens2text(self, tokens) -> str:
        return self.sp.DecodePieces(list(tokens))
