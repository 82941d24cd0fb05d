"""Shared fixtures of the benchmark's CPU tests.

``tiny_root`` is a copy of BENCHMARK.json and the benchmark's files in a
temporary directory, with the codec narrowed (2 filters, 4 x 32 codebooks,
16-d latents), served in float32 on the CPU (torch's CPU bf16 conv1d is
wrong for some shapes, e.g. C = 16, K = 8, stride 4 at T = 4,000), and the
traffic cut to utterances of 0.5-2 s. The drivers, reference and metrics are the
real ones; only the data is small.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_LIMITS = {"token_gap": 0.05, "recon_err": 0.01}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


def narrow(config: dict) -> dict:
    """A configuration file's codec at a few units of width, served in fp32."""
    f = config["funcodec"]
    f["encoder_conf"]["n_filters"] = 2
    f["decoder_conf"]["n_filters"] = 2
    f["quantizer_conf"].update(num_quantizers=4, codebook_size=32)
    f["model_conf"]["odim"] = 16
    config.update(dtype="float32", bit_width=1000)
    return config


def _edit(path: Path, fn) -> None:
    path.write_text(json.dumps(fn(json.loads(path.read_text()))))


@pytest.fixture()
def tiny_root(tmp_path):
    torch.set_num_threads(1)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    for conf in (bench / "configs").glob("*.json"):
        _edit(conf, narrow)

    def small_traffic(t):
        t.update(shard_utterances=24, batch=8, pool_s=20, trace_seconds=0.5, sample_max=4)
        t["length_s"] = {"law": "uniform", "min": 0.5, "max": 2.0}  # a few shapes, as a spread of lengths gives
        return t

    for mix in (bench / "traffic").glob("*.json"):
        _edit(mix, small_traffic)
    for w in (bench / "workloads").glob("*.json"):
        _edit(w, lambda d: dict(d, limits=TINY_LIMITS))
    return tmp_path


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
