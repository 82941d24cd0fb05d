"""Chip smoke test of the PyTorch/CUDA port (funcodec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving main path (EnCodec 16 kHz nq32ds320, the
egs/LibriTTS/codec/conf/encodec_16k_n32_600k_step.yaml flagship at full
width, seeded random weights) through ``Speech2Token``, in phases that each
raise on failure:

1. checks: a CUDA card is present; TF32 is turned off for fp32 matmuls and
   cuDNN; the card's name and power limit are printed.
2. build: csrc/*.cu compiled with nvcc for sm_90a (time, ptxas report).
3. kernel: the RVQ-encode kernel against its plain torch version at the
   flagship shapes (N = 32,000 tokens x 32 stages x 1024 bins x 128), a
   ragged N and n_q = 16.
4. serving: bf16 + kernel requests of B = 8 x 10 s, with the kernel's launch
   count read around them; the fp32-exact path on the same batch and the
   token flip rates between the two; the fp32 path on the card against the
   same model on the CPU for a short clip.
5. timing: the kernel against its plain version at N = 32,000, and the
   B = 64 x 10 s serving rate of both paths.

The line before the last is the card's name and power limit (nvidia-smi),
the one before it a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

_JAX_PRELOADED = "jax" in sys.modules

import funcodec_tpu_torch.quant.rvq as rvq  # noqa: E402
from funcodec_tpu_torch.cli.codec_inference import Speech2Token  # noqa: E402
from funcodec_tpu_torch.kernels import build  # noqa: E402
from funcodec_tpu_torch.quant import rvq_kernel  # noqa: E402
from funcodec_tpu_torch.tasks.codec import load_config  # noqa: E402

REPO = Path(__file__).resolve().parent
FLAGSHIP_YAML = REPO / "egs/LibriTTS/codec/conf/encodec_16k_n32_600k_step.yaml"
SR = 16_000
PARAMS_M = 14.85  # the flagship's published generator size
# kernel vs plain version: ties broken by summation order only
MIN_AGREE_Q0, MIN_AGREE_ALL, MAX_QUANT_ERR = 0.999, 0.99, 1e-5


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card_line()}; "
        f"device_count {torch.cuda.device_count()}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return torch.device("cuda", 0)


def build_phase() -> None:
    t0 = time.perf_counter()
    build.load()
    rep = build.build_report()
    log(f"[build] {rep['path']} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {rep['seconds']:.2f} s, cached={rep['cached']})")
    for line in str(rep["ptxas"]).splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] ptxas: {line.strip()}")
    log(f"[build] rvq_encode dynamic shared memory per block: "
        f"{build.load().rvq_encode_smem_bytes()} bytes")


def _codebooks(gen: torch.Generator, dev) -> torch.Tensor:
    """Flagship-shaped codebooks drawn like RVQState's uniform init."""
    bound = (2.0 / 6.0) ** 0.5 * (3.0 / 128) ** 0.5
    return torch.empty(32, 1024, 128, device=dev).uniform_(-bound, bound, generator=gen)


def _compare(k_idx, k_quant, r_idx, r_quant):
    agree = k_idx == r_idx
    rows = agree.all(dim=0).reshape(-1)
    diff = (k_quant - r_quant).abs().reshape(-1, k_quant.shape[-1])[rows]
    max_err = float(diff.max()) if diff.numel() else 0.0
    return float(agree[0].float().mean()), float(agree.float().mean()), float(rows.float().mean()), max_err


def kernel_phase(dev) -> float:
    """The kernel against rvq_encode_reference; returns the largest
    |quant difference| over rows whose tokens all agree."""
    gen = torch.Generator(device=dev).manual_seed(1)
    embed = _codebooks(gen, dev)
    worst = 0.0
    for name, (B, T), n_q in (("flagship", (64, 500), 32), ("ragged", (1, 137), 32), ("nq16", (64, 500), 16)):
        x = torch.randn(B, T, 128, device=dev, generator=gen) * 0.1
        k_idx, k_quant = rvq_kernel.rvq_encode_fused(x, embed, n_q)
        torch.cuda.synchronize()
        r_idx, r_quant = rvq_kernel.rvq_encode_reference(x, embed, n_q)
        q0, all_, rows, err = _compare(k_idx, k_quant, r_idx, r_quant)
        log(f"[kernel] {name}: N={B * T} n_q={n_q} agree q0={q0:.6f} all={all_:.6f} "
            f"rows={rows:.6f} max|dquant| on agreeing rows={err:.3e}")
        if q0 < MIN_AGREE_Q0 or all_ < MIN_AGREE_ALL or err > MAX_QUANT_ERR:
            raise RuntimeError(f"kernel disagrees with its plain version ({name})")
        if not torch.isfinite(k_quant).all():
            raise RuntimeError(f"kernel output is not finite ({name})")
        worst = max(worst, err)
    return worst


def _speech(seed: int, batch: int, seconds: float) -> np.ndarray:
    return (0.1 * np.random.RandomState(seed).randn(batch, int(seconds * SR))).astype(np.float32)


def _flagship_config():
    config = load_config(str(FLAGSHIP_YAML))
    # kmeans init leaves every codebook at zero until a checkpoint loads
    config["quantizer_conf"]["kmeans_init"] = False
    return config


def serving_phase(dev):
    """bf16 + kernel requests, the fp32-exact path, and CPU agreement.
    Returns (launches in the main-path run, the two Speech2Tokens)."""
    config = _flagship_config()
    s_bf = Speech2Token(config, None, dtype="bfloat16", device=dev)
    n_params = sum(p.numel() for p in s_bf.model.parameters())
    log(f"[serve] flagship params {n_params} ({n_params / 1e6:.3f}M)")
    if abs(n_params / 1e6 - PARAMS_M) / PARAMS_M > 0.02:
        raise RuntimeError(f"parameter count {n_params} is not {PARAMS_M}M +-2%")

    requests = [_speech(10 + i, 8, 10.0) for i in range(3)]
    rvq.FUSED_RVQ = True
    torch.cuda.synchronize()
    rvq_kernel.LAUNCHES = 0
    outs = [s_bf(x, bit_width=None) for x in requests]
    outs.append(s_bf(requests[0]))  # the constructor default, 8 kbps
    launches = rvq_kernel.LAUNCHES
    log(f"[serve] {len(outs)} requests, rvq_encode launches {launches}")
    if launches != len(outs):
        raise RuntimeError(f"expected one kernel launch per request, saw {launches}")
    for i, (codes, _, recon, _) in enumerate(outs):
        n_q = 16 if i == 3 else 32
        if codes[0].shape != (n_q, 8, 500) or recon.shape != (8, 160_000):
            raise RuntimeError(f"request {i}: tokens {codes[0].shape}, recon {recon.shape}")
        if not np.isfinite(recon).all() or codes[0].min() < 0 or codes[0].max() >= 1024:
            raise RuntimeError(f"request {i}: non-finite recon or out-of-range tokens")

    rvq.FUSED_RVQ = False
    s_fp = Speech2Token(config, None, dtype="float32", device=dev)
    if not torch.equal(s_fp.model.quantizer.state.embed, s_bf.model.quantizer.state.embed):
        raise RuntimeError("the fp32 and bf16 models were not built with the same weights")
    codes_fp, _, recon_fp, _ = s_fp(requests[0], bit_width=None)
    tok_bf, tok_fp = outs[0][0][0], codes_fp[0]
    flip_q0 = float((tok_bf[0] != tok_fp[0]).mean())
    flip_all = float((tok_bf != tok_fp).mean())
    log(f"[serve] token flip rate fp32-exact vs bf16+kernel: q0={flip_q0:.5f} all={flip_all:.5f}")
    if not np.isfinite(recon_fp).all():
        raise RuntimeError("fp32 recon is not finite")

    # the fp32 path on the card against the same model on the CPU (the CPU
    # path is held to the JAX package by tests/test_torch_encodec.py)
    s_cpu = Speech2Token(config, None, dtype="float32", device="cpu")
    s_cpu.model.load_state_dict(s_fp.model.state_dict())
    clip = _speech(99, 1, 1.0)
    c_gpu, _, r_gpu, _ = s_fp(clip, bit_width=None)
    c_cpu, _, r_cpu, _ = s_cpu(clip, bit_width=None)
    agree = float((c_gpu[0] == c_cpu[0]).mean())
    rdiff = float(np.abs(r_gpu - r_cpu).max())
    log(f"[serve] fp32 card vs CPU on 1 s: token agreement {agree:.5f}, max|drecon| {rdiff:.3e}")
    if agree < 0.95:
        raise RuntimeError("fp32 tokens on the card disagree with the CPU path")
    return launches, s_bf, s_fp


def _cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _serve_seconds(s2t, x) -> float:
    """Best of 3 after a warm-up; fenced with synchronize."""
    s2t.dispatch(x, bit_width=None)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        s2t.dispatch(x, bit_width=None)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def timing_phase(dev, s_bf, s_fp, card: str):
    gen = torch.Generator(device=dev).manual_seed(2)
    embed = _codebooks(gen, dev)
    x = torch.randn(64, 500, 128, device=dev, generator=gen) * 0.1
    plain_ms = _cuda_ms(lambda: rvq_kernel.rvq_encode_reference(x, embed, 32), 5)
    kernel_ms = _cuda_ms(lambda: rvq_kernel.rvq_encode_fused(x, embed, 32), 5)
    log(f"[time] rvq_encode N=32000 n_q=32: kernel {kernel_ms:.3f} ms, plain torch "
        f"{plain_ms:.3f} ms ({card})")

    speech = torch.from_numpy(_speech(5, 64, 10.0)).to(dev)
    rvq.FUSED_RVQ = False
    t_fp = _serve_seconds(s_fp, speech)
    rvq.FUSED_RVQ = True
    t_bf = _serve_seconds(s_bf, speech)
    rvq.FUSED_RVQ = False
    log(f"[time] serving B=64 x 10 s encode+decode: bf16+kernel {640 / t_bf:.1f} audio-s/s "
        f"({t_bf * 1e3:.1f} ms), fp32-exact {640 / t_fp:.1f} audio-s/s ({t_fp * 1e3:.1f} ms) ({card})")
    return kernel_ms, plain_ms


def main() -> int:
    dev = check_device()
    card = card_line()
    build_phase()
    max_err = kernel_phase(dev)
    launches, s_bf, s_fp = serving_phase(dev)
    kernel_ms, plain_ms = timing_phase(dev, s_bf, s_fp, card)
    if "funcodec_tpu" in sys.modules or ("jax" in sys.modules and not _JAX_PRELOADED):
        raise RuntimeError("the port imported JAX or the JAX package")
    kernels = [{
        "name": "rvq_encode",
        "route": "cuda",
        "source": "funcodec_tpu_torch/csrc/rvq_encode.cu",
        "replaces": "funcodec_tpu/quant/rvq_pallas.py:29",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
