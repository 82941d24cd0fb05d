"""The check for the JAX side compares whole top-level names."""

import subprocess
import sys
from pathlib import Path

from benchmark.harness import guard

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_compared_whole():
    ok = ["funcodec_tpu_torch", "funcodec_tpu_torch.models.encodec", "jaxtyping", "flax_like", "numpy"]
    assert guard.forbidden_loaded(ok) == []
    assert guard.forbidden_loaded(ok + ["funcodec_tpu.models"]) == ["funcodec_tpu"]
    assert guard.forbidden_loaded(["jax", "jaxlib.xla_client", "flax.core"]) == ["flax", "jax", "jaxlib"]


def test_harness_and_program_import_no_jax():
    """Everything a run loads, imported in a fresh process, leaves no JAX module."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness.main, benchmark.harness.codec, benchmark.drivers.codec_batch, "
            "benchmark.costs.codec\n"
            "import funcodec_tpu_torch.cli.codec_inference\n"
            "from benchmark.harness import guard\n"
            "print(guard.forbidden_loaded())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    """With no CUDA card the run exits non-zero and prints no result."""
    code = ("import sys, runpy, torch; torch.cuda.is_available = lambda: False; "
            "sys.argv = ['run.py', '--workload', 'encodec_nq32ds320.serve_batch', '--seed', '1', '--seconds', '1'];"
            "runpy.run_path(%r, run_name='__main__')") % str(ROOT / "benchmark/run.py")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
