"""The port's entropy coder (quant/entropy.py) against funcodec_tpu's, on the CPU.

The bitstream is the contract: every test holds the port's bytes equal to
the JAX package's on the same inputs (seeded numpy), then the round trip.
"""

import io

import numpy as np
import pytest
import torch

from funcodec_tpu.quant import entropy as jent
from funcodec_tpu_torch.quant import entropy as tent


@pytest.mark.parametrize("use_arithmetic", [True, False], ids=["arithmetic", "raw"])
@pytest.mark.parametrize("shape,bins", [((250, 32), 1024), ((37, 3), 1000), ((1, 1), 2)])
def test_compress_tokens_bytes_equal_jax(use_arithmetic, shape, bins):
    tokens = np.random.RandomState(0).randint(0, bins, shape)
    blob = tent.compress_tokens(tokens, bins, 16000, 320, use_arithmetic=use_arithmetic)
    assert blob == jent.compress_tokens(tokens, bins, 16000, 320, use_arithmetic=use_arithmetic)
    np.testing.assert_array_equal(tent.decompress_tokens(blob), tokens)
    np.testing.assert_array_equal(jent.decompress_tokens(blob), tokens)
    # a tensor (here on the CPU) serializes to the same bytes
    assert tent.compress_tokens(torch.from_numpy(tokens).int(), bins, 16000, 320,
                                use_arithmetic=use_arithmetic) == blob


def test_compressed_size_near_the_information_bound():
    tokens = np.random.RandomState(1).randint(0, 1024, (250, 32))
    for ac in (True, False):
        blob = tent.compress_tokens(tokens, 1024, 16000, 320, use_arithmetic=ac)
        assert len(blob) < 250 * 32 * 10 / 8 * 1.1 + 200


def test_arithmetic_coder_stream_equals_jax():
    """The reference's inline fuzz test (ac.py:262-291): per-step random pdfs;
    the port's stream equals JAX's byte for byte and decodes in both."""
    rng = np.random.RandomState(1234)
    for _ in range(3):
        cardinality = rng.randint(2, 1024)
        steps = rng.randint(100, 300)
        fo, jfo = io.BytesIO(), io.BytesIO()
        enc, jenc = tent.ArithmeticCoder(fo), jent.ArithmeticCoder(jfo)
        cdfs, symbols = [], []
        for _ in range(steps):
            logits = rng.randn(cardinality)
            pdf = np.exp(logits - logits.max())
            pdf = pdf / pdf.sum()
            cdf = tent.build_stable_quantized_cdf(pdf, enc.total_range_bits)
            np.testing.assert_array_equal(cdf, jent.build_stable_quantized_cdf(pdf, jenc.total_range_bits))
            symbol = int(rng.choice(cardinality, p=pdf))
            cdfs.append(cdf)
            symbols.append(symbol)
            enc.push(symbol, cdf)
            jenc.push(symbol, cdf)
        enc.flush()
        jenc.flush()
        assert fo.getvalue() == jfo.getvalue()
        for mod in (tent, jent):
            dec = mod.ArithmeticDecoder(io.BytesIO(fo.getvalue()))
            assert [dec.pull(c) for c in cdfs] == symbols


@pytest.mark.parametrize("bits", [1, 7, 10, 16])
def test_bitpacker_bytes_equal_jax(bits):
    vals = np.random.RandomState(42).randint(0, 2**bits, 500).tolist()
    fo, jfo = io.BytesIO(), io.BytesIO()
    packer, jpacker = tent.BitPacker(bits, fo), jent.BitPacker(bits, jfo)
    for v in vals:
        packer.push(int(v))
        jpacker.push(int(v))
    packer.flush()
    jpacker.flush()
    assert fo.getvalue() == jfo.getvalue()
    assert len(fo.getvalue()) == -(-500 * bits // 8)
    unpacker = tent.BitUnpacker(bits, io.BytesIO(fo.getvalue()))
    assert [unpacker.pull() for _ in vals] == vals


def test_ecdc_header():
    meta = {"m": "funcodec_tpu", "sr": 16000, "hop": 320, "t": 5, "nq": 2, "bins": 1024, "ac": True}
    fo, jfo = io.BytesIO(), io.BytesIO()
    tent.write_ecdc_header(fo, meta)
    jent.write_ecdc_header(jfo, meta)
    assert fo.getvalue() == jfo.getvalue()
    assert fo.getvalue()[:4] == b"ECDC" and fo.getvalue()[4] == 0
    assert tent.read_ecdc_header(io.BytesIO(fo.getvalue())) == meta
    # the format tag of compress_tokens is the JAX package's, verbatim
    blob = tent.compress_tokens(np.zeros((5, 2), np.int64), 1024, 16000, 320)
    assert tent.read_ecdc_header(io.BytesIO(blob)) == meta
    with pytest.raises(ValueError, match="ECDC"):
        tent.read_ecdc_header(io.BytesIO(b"XXXX" + fo.getvalue()[4:]))
    with pytest.raises(ValueError, match="Version"):
        tent.read_ecdc_header(io.BytesIO(fo.getvalue()[:4] + b"\x01" + fo.getvalue()[5:]))
    with pytest.raises(EOFError):
        tent.read_ecdc_header(io.BytesIO(fo.getvalue()[:12]))
