"""Speech2Token's overlap of batches on a card: ``dispatch`` makes no
synchronising call, two batches in flight are bit-equal to the synchronous
path, the host outputs land in pinned memory, and ``collect`` counts one
collect a replica in ``COLLECTS``; FreqCodec's iSTFT (``ops/stft.istft``,
without torch.istft's host check) gives torch.istft's bits.

The models are the benchmark's two configurations as served there
(``benchmark/configs/*.json``: bf16, the kernel switches), at its batch of
64 utterances of 5.825 s in a 97,280-sample bucket. This file imports
neither JAX nor the JAX package. On a machine with a card:

    python -m pytest --noconftest -q tests/test_torch_serving_overlap.py
"""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from funcodec_tpu_torch.cli import codec_inference
from funcodec_tpu_torch.cli.codec_inference import Speech2Token
from funcodec_tpu_torch.ops import stft

CONFIGS = Path(__file__).resolve().parents[1] / "benchmark" / "configs"
B, SAMPLES, ILEN = 64, 97_280, 93_200  # the cell's batch: 5.825 s padded to a 16-frame bucket
RUN_MODS = ["inference", "encode", "decode"]


def _config(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def served():
    """name -> a built Speech2Token, with the configuration's switches set
    for the module's tests and put back after them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the overlap is of CUDA work with the host")
    built = {}
    with pytest.MonkeyPatch.context() as mp:

        def build(name: str, replicas: int = 1) -> Speech2Token:
            if (name, replicas) not in built:
                conf = _config(name)
                for path, value in conf["flags"].items():
                    module, attr = path.rsplit(".", 1)
                    mp.setattr(importlib.import_module(module), attr, value)
                built[name, replicas] = Speech2Token(conf["funcodec"], None, dtype=conf["dtype"],
                                                     bit_width=conf["bit_width"], devices=["cuda"] * replicas)
            return built[name, replicas]

        yield build
        torch.cuda.synchronize()


def _batch(run_mod: str, seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    if run_mod == "decode":
        return rs.randint(0, 1024, (B, SAMPLES // 320, 32))
    return np.round(0.1 * rs.randn(B, SAMPLES) * 32767).astype(np.int16)


def _dispatch(s2t: Speech2Token, x: np.ndarray, run_mod: str):
    """inference: PCM16 out, as the benchmark and the CLI serve; encode:
    codes only; decode: the float32 recon."""
    return s2t.dispatch(x, need_recon=run_mod != "encode", bit_width=None, run_mod=run_mod,
                        pcm16_ilens=[ILEN] * B if run_mod == "inference" else None)


def _serve(s2t: Speech2Token, x: np.ndarray, run_mod: str):
    return s2t.collect(_dispatch(s2t, x, run_mod), need_sub_quants=False)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["encodec_nq32ds320", "freqcodec_gr8"])
@pytest.mark.parametrize("run_mod", RUN_MODS)
def test_dispatch_makes_no_synchronising_call(served, name, run_mod):
    s2t = served(name)
    x = _batch(run_mod, 1)
    _serve(s2t, x, run_mod)  # cuDNN's plans and the pinned blocks, made before the checked call
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _dispatch(s2t, x, run_mod)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    codes, _, recon, _ = s2t.collect(out, need_sub_quants=False)
    assert (codes is None) == (run_mod == "decode") and (recon is None) == (run_mod == "encode")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["encodec_nq32ds320", "freqcodec_gr8"])
def test_two_batches_in_flight_equal_the_synchronous_path(served, name):
    s2t = served(name)
    batches = [_batch("inference", seed) for seed in (2, 3)]
    outs = [_dispatch(s2t, x, "inference") for x in batches]
    for out in outs:
        assert all(c.is_pinned() and c.dtype == torch.int32 for c in out["code_indices"])
        assert out["recon_pcm16"].is_pinned() and out["recon_pcm16"].dtype == torch.int16
        assert out["code_embeddings"][0][0].is_cuda
    pipelined = [s2t.collect(out, need_sub_quants=False) for out in outs]
    for x, out, (codes, _, recon, _) in zip(batches, outs, pipelined):
        # numpy views of the pinned copies
        assert np.shares_memory(recon, out["recon_pcm16"].numpy())
        assert np.shares_memory(codes[0], out["code_indices"][0].numpy())
        torch.cuda.synchronize()
        alone = _serve(s2t, x, "inference")
        assert codes[0].dtype == np.int32 and codes[0].shape[:2] == (32, B)
        assert recon.dtype == np.int16 and recon.shape == (B, SAMPLES)
        np.testing.assert_array_equal(codes[0], alone[0][0])
        np.testing.assert_array_equal(recon, alone[2])
    assert not np.array_equal(pipelined[0][0][0], pipelined[1][0][0])


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [1, 2])
def test_collects_count_one_collect_a_replica(served, monkeypatch, replicas):
    s2t = served("encodec_nq32ds320", replicas)
    counts = {"ready": 0, "waited": 0}
    monkeypatch.setattr(codec_inference, "COLLECTS", counts)
    x = _batch("inference", 4)
    _serve(s2t, x, "inference")
    assert sum(counts.values()) == replicas
    out = _dispatch(s2t, x, "inference")
    torch.cuda.synchronize()  # the copies are done before collect begins
    s2t.collect(out, need_sub_quants=False)
    assert counts["ready"] >= replicas and sum(counts.values()) == 2 * replicas


@pytest.mark.gpu
def test_istft_is_torch_istft_bit_for_bit(served):
    """At FreqCodec's transform of the cell's batch: (64, 257, 609) -> (64, 97,280)."""
    del served  # the card check
    spec = torch.randn(B, 257, 609, dtype=torch.complex64, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(5))
    ref = torch.istft(spec, 512, 160, 512, stft.hann_window(512, device="cuda"), center=True,
                      return_complex=False)
    assert torch.equal(stft.istft(spec, 512, 160), ref)
