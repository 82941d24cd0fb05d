"""The traffic generator: the same seed gives the same traffic, and the
laws and buckets are as the mixes state."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import traffic

BENCH = Path(__file__).resolve().parents[1]


def test_the_mix_s_law_is_its_source_s_mean():
    law = json.loads((BENCH / "traffic/corpus_mean_b64.json").read_text())["length_s"]
    x = traffic.quantiles(law, 4096)
    assert law["law"] == "fixed" and np.all(x == law["value"])
    assert abs(law["value"] - 53.78 * 3600 / 33236) < 1e-3  # train-clean-100's hours over its utterances


def test_lognormal_quantiles_keep_the_law():
    law = {"law": "lognormal", "mean": 5.8, "sigma": 0.6, "min": 0.5, "max": 35.0}
    x = traffic.quantiles(law, 4096)
    assert x.min() >= law["min"] and x.max() <= law["max"]
    assert abs(x.mean() - law["mean"]) < 0.05 * law["mean"]  # clipping moves the mean a little
    assert np.all(np.diff(x) >= 0)


def test_uniform_quantiles():
    x = traffic.quantiles({"law": "uniform", "min": 1.0, "max": 5.0}, 400)
    assert x.min() > 1.0 and x.max() < 5.0 and abs(x.mean() - 3.0) < 1e-9


@pytest.mark.parametrize("t", [1, 319, 320, 5119, 5120, 5121, 560000])
def test_bucket_length_is_whole_buckets(t):
    b = traffic.bucket_length(t, 320, 16)
    assert b >= t and b % (320 * 16) == 0 and b - t < 320 * 16


def test_sorted_batches_cover_the_shard():
    lengths = np.sort((traffic.quantiles({"law": "lognormal", "mean": 5.8, "sigma": 0.6, "min": 0.5, "max": 35},
                                         4096) * 16000).astype(int))
    batches = traffic.sorted_batches(lengths, 64, 320, 16)
    assert len(batches) == 64 and batches[0][0] == 0 and batches[-1][1] == 4096
    for first, end, padded in batches:
        assert padded >= lengths[end - 1]


def test_wrap_pad_repeats_the_start():
    out = traffic.wrap_pad([np.arange(3), np.arange(5)], 7)
    assert out.tolist() == [[0, 1, 2, 0, 1, 2, 0], [0, 1, 2, 3, 4, 0, 1]]


def test_same_seed_same_traffic():
    seed = 2**31 + 5
    p1 = traffic.pcm_pool(2.0, 16000, seed, "cpu")
    assert np.array_equal(p1, traffic.pcm_pool(2.0, 16000, seed, "cpu")) and p1.dtype == np.int16
    assert not np.array_equal(p1, traffic.pcm_pool(2.0, 16000, seed + 1, "cpu"))
    assert traffic.rng(seed, 1).integers(1 << 30) == traffic.rng(seed, 1).integers(1 << 30)
    assert traffic.rng(seed, 1).integers(1 << 30) != traffic.rng(seed + 1, 1).integers(1 << 30)
