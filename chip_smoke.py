"""Chip smoke test of the PyTorch/CUDA port (funcodec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # the smoke run below
    python3 chip_smoke.py --profile   # checks, build, then a torch.profiler table of
                                      # one B = 64 x 10 s request per serving path
                                      # (tables also in build/chip_smoke/)

Drives the port's serving main path (EnCodec 16 kHz nq32ds320, the
egs/LibriTTS/codec/conf/encodec_16k_n32_600k_step.yaml flagship at full
width, seeded random weights) through ``Speech2Token``, in phases that each
raise on failure:

1. checks: a CUDA card is present; TF32 is turned off for fp32 matmuls and
   cuDNN; the card's name and power limit are printed.
2. build: csrc/*.cu compiled with nvcc for sm_90a, one nvcc per source in
   parallel (time, ptxas registers / shared memory / spills per kernel).
3. kernel: each kernel against its plain torch version. RVQ encode at the
   flagship shapes (N = 32,000 tokens x 32 stages x 1024 bins x 128), a
   ragged N and n_q = 16. The fused conv at every flagship layer it serves
   (B = 64 x 10 s), a dilated causal replicate case, a ragged T and an fp32
   case. The fused resblock at the four flagship widths (B = 64 x 10 s), a
   ragged T and an fp32 case. bf16 outputs are held to 2 bf16 ulps of the
   output's largest value.
4. serving: B = 8 x 10 s requests on three bf16 paths, each with FUSED_RVQ:
   unfused SEANet; FUSED_STRIDE1; FUSED_STRIDE1 + FUSED_RESBLOCK (the main
   path of this slice). Every kernel's launch count is read around each
   request against what the gates imply. Token flip rates between the
   paths and against the fp32-exact path; the fp32 path on the card
   against the same model on the CPU for a short clip.
5. probe: the HBM copy probes (csrc/copy_probe.cu, ops/copy_kernel.py).
   scale_copy and dma_copy held bit for bit to x * 2 in bf16 and fp32 at
   the probe shape 256 x 20,000 x 128, a ragged T and a row count that is
   not a multiple of chunk_rows; then the probe path, tools/bw_probe.run
   (every tile and block shape, dma_copy, torch.mul, copy_), whose best
   rate is the measured copy ceiling.
6. cli: the file-to-file entry point, cli/codec_inference.main, on a
   seeded corpus of 32 noise utterances of 1-12 s (16 kHz PCM16) under
   build/chip_smoke/cli/: bf16 on the main path at batch 16 and 16 kb/s
   (32 quantizers) with exact launch counts, its first batch against a
   direct Speech2Token.dispatch, decode from codecs.txt, the ark round
   trip, two 24 kHz files through --file_sampling_rate, and fp32
   codecs.txt on the card against the CPU; end-to-end audio-s/s.
7. timing: each kernel against its plain version (and cuDNN / the unfused
   block) at each flagship shape, beside its bound, with each bytes-bound
   row's share of the published peak and of the measured copy ceiling; the
   B = 64 x 10 s serving rate of fp32-exact, bf16 + RVQ kernel,
   + FUSED_STRIDE1 and + both SEANet flags. The per-shape rows also go to
   build/chip_smoke/timings.json (git-ignored).

The line before the last is the card's name and power limit (nvidia-smi),
the one before it a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

_JAX_PRELOADED = "jax" in sys.modules

import funcodec_tpu_torch.cli.codec_inference as cli  # noqa: E402
import funcodec_tpu_torch.ops.conv as conv_ops  # noqa: E402
import funcodec_tpu_torch.quant.rvq as rvq  # noqa: E402
from funcodec_tpu_torch.cli.codec_inference import Speech2Token  # noqa: E402
from funcodec_tpu_torch.data.kaldi_ark import ArkScpReader  # noqa: E402
from funcodec_tpu_torch.data.wav_io import read_wav, write_wav  # noqa: E402
from funcodec_tpu_torch.kernels import build  # noqa: E402
from funcodec_tpu_torch.models.seanet import (  # noqa: E402
    SEANetConfig,
    SEANetResnetBlock,
    _resblock_layers,
    make_layer,
)
from funcodec_tpu_torch.ops import conv_kernel, copy_kernel, resblock_kernel  # noqa: E402
from funcodec_tpu_torch.ops.pad import conv_padding_total, pad1d_time, split_padding  # noqa: E402
from funcodec_tpu_torch.quant import rvq_kernel  # noqa: E402
from funcodec_tpu_torch.tasks.codec import load_config  # noqa: E402
from funcodec_tpu_torch.tools import bw_probe  # noqa: E402
from funcodec_tpu_torch.tools.benchlib import PEAK_BYTES, card_line, timeit, timeit_amortized  # noqa: E402

REPO = Path(__file__).resolve().parent
FLAGSHIP_YAML = REPO / "egs/LibriTTS/codec/conf/encodec_16k_n32_600k_step.yaml"
OUT_DIR = REPO / "build" / "chip_smoke"
SR = 16_000
PARAMS_M = 14.85  # the flagship's published generator size
# kernel vs plain version: ties broken by summation order only
MIN_AGREE_Q0, MIN_AGREE_ALL, MAX_QUANT_ERR = 0.999, 0.99, 1e-5
# fp32 outputs of the SEANet kernels: summation order only, relative to the output's scale
FP32_REL_TOL = {"conv1d_s1": 1e-5, "resblock_tgn": 1e-4}
# a sanity bound on token flips between two bf16 paths (a broken kernel flips ~all)
MAX_FLIP_ALL = 0.5
# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BF16, PEAK_FP32 = 989e12, 67e12  # PEAK_BYTES (3.35 TB/s) comes from tools/benchlib
CARD = torch.device("cuda", 0)
# kernel launches per request with the gates of ops/conv_kernel and ops/resblock_kernel:
# 4 head convs + 8 resblock k3 convs; or the 4 head convs and 8 blocks x 3 passes
EXPECT = {
    "unfused": {"conv1d_s1": 0, "resblock_tgn": 0, "rvq_encode": 1},
    "stride1": {"conv1d_s1": 12, "resblock_tgn": 0, "rvq_encode": 1},
    "stride1+resblock": {"conv1d_s1": 4, "resblock_tgn": 24, "rvq_encode": 1},
}
FLAGS = {"unfused": (False, False), "stride1": (True, False), "stride1+resblock": (True, True)}
MAIN_PATH = "stride1+resblock"
COUNTERS = {"conv1d_s1": conv_kernel, "resblock_tgn": resblock_kernel, "rvq_encode": rvq_kernel}


def log(*args) -> None:
    print(*args, flush=True)


def check_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card_line(CARD)}; "
        f"device_count {torch.cuda.device_count()}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return CARD


def set_flags(path: str) -> None:
    conv_ops.FUSED_STRIDE1, conv_ops.FUSED_RESBLOCK = FLAGS[path]
    rvq.FUSED_RVQ = True


def reset_counts() -> None:
    for mod in COUNTERS.values():
        mod.LAUNCHES = 0
    copy_kernel.LAUNCHES.update(scale_copy=0, dma_copy=0)


def read_counts() -> dict:
    return {name: mod.LAUNCHES for name, mod in COUNTERS.items()}


def build_phase() -> None:
    t0 = time.perf_counter()
    lib = build.load()
    rep = build.build_report()
    log(f"[build] {rep['path']} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {rep['seconds']:.2f} s, cached={rep['cached']})")
    for line in str(rep["ptxas"]).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")
    log(f"[build] dynamic shared memory per block: rvq_encode {lib.rvq_encode_smem_bytes()} B; "
        + ", ".join(f"conv1d_s1 {ci}->{co} k{k} bf16 {lib.conv1d_s1_smem_bytes(ci, co, k, 1, 1)} B"
                    for ci, co, k in ((1, 32, 7), (512, 128, 7), (32, 16, 3)))
        + "; " + ", ".join(f"resblock_tgn C={c} bf16 {lib.resblock_tgn_smem_bytes(c, c // 2, 3, 1, 1)} B "
                           f"(tile {lib.resblock_tgn_tile(c, c // 2, 1)})" for c in (32, 64, 128, 256)))


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


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


def rvq_kernel_phase(dev) -> float:
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
        log(f"[kernel] rvq_encode {name}: N={B * T} n_q={n_q} agree q0={q0:.6f} all={all_:.6f} "
            f"rows={rows:.6f} max|dquant| on agreeing rows={err:.3e}")
        if q0 < MIN_AGREE_Q0 or all_ < MIN_AGREE_ALL or err > MAX_QUANT_ERR:
            raise RuntimeError(f"kernel disagrees with its plain version ({name})")
        if not torch.isfinite(k_quant).all():
            raise RuntimeError(f"kernel output is not finite ({name})")
        worst = max(worst, err)
    return worst


def _tolerance(kernel: str, ref: torch.Tensor) -> float:
    """2 bf16 ulps of the output's largest value; fp32: FP32_REL_TOL of it."""
    scale = float(ref.float().abs().max())
    if ref.dtype == torch.bfloat16:
        return 2.0 * 2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0 else 0.0
    return FP32_REL_TOL[kernel] * scale


def _held(kernel: str, name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    if out.shape != ref.shape or out.dtype != ref.dtype or not torch.isfinite(out).all():
        raise RuntimeError(f"{kernel} {name}: output {out.dtype}{tuple(out.shape)} is not finite "
                           f"or not shaped like the plain version's {ref.dtype}{tuple(ref.shape)}")
    err = float((out.float() - ref.float()).abs().max())
    tol = _tolerance(kernel, ref)
    log(f"[kernel] {kernel} {name}: {tuple(out.shape)} {str(out.dtype)[6:]} max|err| {err:.3e} (limit {tol:.3e})")
    if err > tol:
        raise RuntimeError(f"{kernel} {name}: the kernel disagrees with its plain version")
    return err


class ConvLayer:
    """One stride-1 conv call at its main-path shape: (B, Cin, T) -> (B, Cout, T)."""

    def __init__(self, name, conv, B, T, act, dtype, dev, seed):
        spec = conv.spec
        self.name, self.act, self.spec = name, act, spec
        self.left, self.right = split_padding(conv_padding_total(spec.kernel_size, 1, spec.dilation), spec.causal)
        w, b, _, _ = conv.params()
        self.w, self.b = w.detach().to(dtype), b.detach().float()
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.x = torch.randn(B, spec.in_channels, T, device=dev, generator=gen).to(dtype)
        self.xp = None

    def args(self):
        s = self.spec
        return (self.x, self.w, self.b, self.left, self.right, s.dilation, s.pad_mode, self.act)

    def kernel(self):
        return conv_kernel.fused_conv1d_s1(*self.args())

    def plain(self):
        return conv_kernel.fused_conv1d_s1_reference(*self.args())

    def library(self):
        """cuDNN's conv1d on the input padded beforehand (pad and act untimed)."""
        if self.xp is None:
            self.xp = pad1d_time(conv_kernel.apply_act(self.x, self.act), (self.left, self.right),
                                 mode=self.spec.pad_mode)
        return F.conv1d(self.xp, self.w, self.b.to(self.x.dtype), dilation=self.spec.dilation)

    def bound_ms(self):
        B, Cin, T = self.x.shape
        Cout, _, K = self.w.shape
        e = self.x.element_size()
        nbytes = (B * Cin * T + B * Cout * T + Cout * Cin * K) * e + Cout * 4
        flops = 2.0 * B * Cout * T * Cin * K
        return _bound(nbytes, flops, PEAK_BF16 if e == 2 else PEAK_FP32)


class ResblockCall:
    """One residual block at its main-path shape (B, C, T)."""

    def __init__(self, name, block, B, T, dtype, dev, seed):
        self.name, self.block = name, block
        self.convs = (block.block[1], block.block[3], block.shortcut)
        C = self.convs[0].spec.in_channels
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.x = torch.randn(B, C, T, device=dev, generator=gen).to(dtype)

    def kernel(self):
        return resblock_kernel.fused_resblock_tgn(self.x, *self.convs)

    def plain(self):
        return resblock_kernel.fused_resblock_tgn_reference(self.x, *self.convs)

    def unfused(self):
        """The port's unfused block (cuDNN convs, F.group_norm); the flags are off."""
        return self.block(self.x)

    def bound_ms(self):
        B, C, T = self.x.shape
        H, K = self.convs[0].spec.out_channels, self.convs[0].spec.kernel_size
        e = self.x.element_size()
        macs = H * K * C + C * H + C * C
        return _bound(2 * B * C * T * e + macs * e, 2.0 * B * T * macs, PEAK_BF16 if e == 2 else PEAK_FP32)


def _bound(nbytes: float, flops: float, peak: float):
    """(bound ms, bound_by): the larger of bytes / 3.35 TB/s and FLOP / peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _blocks(model):
    return [m for m in model.modules() if isinstance(m, SEANetResnetBlock)]


def flagship_calls(s_bf, dev, B=64, seconds=10.0):
    """The SEANet kernels' calls of one B x 10 s request, at their shapes,
    on the served bf16 model's own weights: (conv layers of the main path,
    resblock k3 convs run with FUSED_STRIDE1 alone, resblocks)."""
    enc, dec = s_bf.model.encoder.model, s_bf.model.decoder.model
    T = int(seconds * SR)
    Ts = [T, T // 2, T // 8, T // 40]  # the encoder's stage lengths (strides 2, 4, 5, 8)
    bf = torch.bfloat16
    heads = [
        ConvLayer("enc_first 1->32 k7", enc[0], B, T, None, bf, dev, 10),
        ConvLayer("enc_last elu 512->128 k7", enc[len(enc) - 1], B, T // 320, "elu", bf, dev, 11),
        ConvLayer("dec_first 128->512 k7", dec[0], B, T // 320, None, bf, dev, 12),
        ConvLayer("dec_last elu 32->1 k7", dec[len(dec) - 1], B, T, "elu", bf, dev, 13),
    ]
    blocks = _blocks(s_bf.model.encoder)
    rb_convs = [ConvLayer(f"resblock elu {b.block[1].spec.in_channels}->{b.block[1].spec.out_channels} k3",
                          b.block[1], B, t, "elu", bf, dev, 20 + i) for i, (b, t) in enumerate(zip(blocks, Ts))]
    resblocks = [ResblockCall(f"C={b.block[1].spec.in_channels} T={t}", b, B, t, bf, dev, 30 + i)
                 for i, (b, t) in enumerate(zip(blocks, Ts))]
    return heads, rb_convs, resblocks


def _extra_block(C, dil, causal, pad_mode, dtype, dev, seed):
    """A flagship-style residual block of width C on its own, seeded."""
    cfg = SEANetConfig(norm="time_group_norm", causal=causal, pad_mode=pad_mode)
    gen = torch.Generator(device=dev).manual_seed(seed)
    block = make_layer("resblock", _resblock_layers(cfg, C, dil)[1], device=dev, generator=gen)
    return block.to(dtype).eval()


def seanet_kernel_phase(dev, calls):
    """The fused conv and resblock kernels against their plain versions."""
    heads, rb_convs, resblocks = calls
    errs = {"conv1d_s1": 0.0, "resblock_tgn": 0.0}
    extra_convs = [
        ConvLayer("dilated causal replicate elu 64->32 k3 d9",
                  _extra_block(64, 9, True, "replicate", torch.bfloat16, dev, 40).block[1],
                  64, 80_000, "elu", torch.bfloat16, dev, 41),
        ConvLayer("ragged elu 32->16 k3 T=160003",
                  _extra_block(32, 1, False, "reflect", torch.bfloat16, dev, 42).block[1],
                  64, 160_003, "elu", torch.bfloat16, dev, 43),
        ConvLayer("fp32 elu 128->64 k3", _extra_block(128, 1, False, "reflect", torch.float32, dev, 44).block[1],
                  8, 20_000, "elu", torch.float32, dev, 45),
    ]
    with torch.inference_mode():
        for layer in heads + rb_convs + extra_convs:
            out = layer.kernel()
            torch.cuda.synchronize()
            err = _held("conv1d_s1", layer.name, out, layer.plain())
            if layer.x.dtype == torch.bfloat16:
                errs["conv1d_s1"] = max(errs["conv1d_s1"], err)
        extra_blocks = [
            ResblockCall("ragged C=64 T=80003", _extra_block(64, 1, False, "reflect", torch.bfloat16, dev, 50),
                         64, 80_003, torch.bfloat16, dev, 51),
            ResblockCall("fp32 C=128 T=20000", _extra_block(128, 1, False, "reflect", torch.float32, dev, 52),
                         8, 20_000, torch.float32, dev, 53),
        ]
        for call in resblocks + extra_blocks:
            out = call.kernel()
            torch.cuda.synchronize()
            err = _held("resblock_tgn", call.name, out, call.plain())
            if call.x.dtype == torch.bfloat16:
                errs["resblock_tgn"] = max(errs["resblock_tgn"], err)
    return errs


# ---------------------------------------------------------------------------
# serving phase
# ---------------------------------------------------------------------------


def _speech(seed: int, batch: int, seconds: float) -> np.ndarray:
    return (0.1 * np.random.RandomState(seed).randn(batch, int(seconds * SR))).astype(np.float32)


def _flagship_config():
    config = load_config(str(FLAGSHIP_YAML))
    # kmeans init leaves every codebook at zero until a checkpoint loads
    config["quantizer_conf"]["kmeans_init"] = False
    return config


def build_models(dev):
    config = _flagship_config()
    s_bf = Speech2Token(config, None, dtype="bfloat16", device=dev)
    n_params = sum(p.numel() for p in s_bf.model.parameters())
    log(f"[serve] flagship params {n_params} ({n_params / 1e6:.3f}M)")
    if abs(n_params / 1e6 - PARAMS_M) / PARAMS_M > 0.02:
        raise RuntimeError(f"parameter count {n_params} is not {PARAMS_M}M +-2%")
    s_fp = Speech2Token(config, None, dtype="float32", device=dev)
    if not torch.equal(s_fp.model.quantizer.state.embed, s_bf.model.quantizer.state.embed):
        raise RuntimeError("the fp32 and bf16 models were not built with the same weights")
    return config, s_bf, s_fp


def _check_output(what, codes, recon, n_q):
    if codes[0].shape != (n_q, 8, 500) or recon.shape != (8, 160_000):
        raise RuntimeError(f"{what}: tokens {codes[0].shape}, recon {recon.shape}")
    if not np.isfinite(recon).all() or codes[0].min() < 0 or codes[0].max() >= 1024:
        raise RuntimeError(f"{what}: non-finite recon or out-of-range tokens")


def _flips(a, b):
    return float((a[0] != b[0]).mean()), float((a != b).mean())


def serving_phase(config, s_bf, s_fp):
    """The three bf16 paths, launch counts per request, flips, fp32 checks.
    Returns the kernels' launch counts over the main path's requests."""
    requests = [_speech(10 + i, 8, 10.0) for i in range(3)]
    tokens, main_counts = {}, None
    for path in ("unfused", "stride1", MAIN_PATH):
        set_flags(path)
        torch.cuda.synchronize()
        reset_counts()
        outs = []
        for i, x in enumerate(requests):
            before = read_counts()
            outs.append(s_bf(x, bit_width=None))
            per_request = {k: v - before[k] for k, v in read_counts().items()}
            if per_request != EXPECT[path]:
                raise RuntimeError(f"{path} request {i}: launches {per_request}, expected {EXPECT[path]}")
        if path == "unfused":  # the constructor default, 8 kbps
            before = read_counts()
            codes, _, recon, _ = s_bf(requests[0])
            if read_counts()["rvq_encode"] - before["rvq_encode"] != 1:
                raise RuntimeError("the 8 kbps request did not launch the RVQ kernel once")
            _check_output(f"{path} 8 kbps", codes, recon, 16)
        counts = read_counts()
        log(f"[serve] {path}: {len(outs)} requests of B=8 x 10 s, launches {counts} "
            f"(per request {EXPECT[path]})")
        for i, (codes, _, recon, _) in enumerate(outs):
            _check_output(f"{path} request {i}", codes, recon, 32)
        tokens[path] = outs[0][0][0]
        if path == MAIN_PATH:
            main_counts = counts

    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = rvq.FUSED_RVQ = False
    codes_fp, _, recon_fp, _ = s_fp(requests[0], bit_width=None)
    if not np.isfinite(recon_fp).all():
        raise RuntimeError("fp32 recon is not finite")
    tokens["fp32"] = codes_fp[0]
    flips = {}
    for a, b in (("stride1", "unfused"), (MAIN_PATH, "unfused"), (MAIN_PATH, "stride1"),
                 ("unfused", "fp32"), ("stride1", "fp32"), (MAIN_PATH, "fp32")):
        q0, all_ = _flips(tokens[a], tokens[b])
        flips[f"{a} vs {b}"] = {"q0": q0, "all": all_}
        log(f"[serve] token flip rate {a} vs {b}: q0={q0:.5f} all={all_:.5f}")
        if b != "fp32" and all_ > MAX_FLIP_ALL:
            raise RuntimeError(f"{a} and {b} disagree on {all_:.3f} of the tokens")

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
    return main_counts, flips


# ---------------------------------------------------------------------------
# probe phase
# ---------------------------------------------------------------------------

PROBE_SHAPE = (256, 20_000, 128)  # the TPU probes' (B, Tp, L)
# x's first values: overflow to +-inf, subnormals, signed zeros, bf16 extremes
SPECIALS = (3.0e38, -3.0e38, 1e-40, -1e-40, 0.0, -0.0, 1.0, 3.3e38)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def probe_phase(dev, card: str):
    """Both copy kernels bit for bit against x * 2, then the probe path
    (tools/bw_probe.run) with the launch counts read around it. Returns
    (rows of the probe path, launches on it, the plain version's ms per
    dtype, the measured copy ceiling in bytes/s)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [("probe", PROBE_SHAPE), ("ragged T", (7, 4001, 128)), ("rows % chunk_rows != 0", (3, 1001, 128))]
    for dtype in (torch.bfloat16, torch.float32):
        for name, shape in cases:
            x = torch.randn(*shape, device=dev, generator=gen).to(dtype)
            x.view(-1)[: len(SPECIALS)] = torch.tensor(SPECIALS, device=dev).to(dtype)
            ref = copy_kernel.scale_reference(x)
            outs = {f"scale_copy tile={t} rows={r}": copy_kernel.scale_copy(x, t, r)
                    for t, r in ((4000, 1), (bw_probe.GPU_TILE, 1), (2000, 8))}
            outs["dma_copy"] = copy_kernel.dma_copy(x)
            outs["dma_copy chunk_rows=100"] = copy_kernel.dma_copy(x, 100)
            torch.cuda.synchronize()
            for what, out in outs.items():
                if out.dtype != ref.dtype or not torch.equal(_bits(out), _bits(ref)):
                    raise RuntimeError(f"{what} {name} {tuple(shape)} {dtype}: not bit-equal to x * 2")
            log(f"[probe] {name} {tuple(shape)} {str(dtype)[6:]}: {', '.join(outs)} bit-equal to x * 2")
            del x, ref, outs
    torch.cuda.empty_cache()

    reset_counts()
    rows = bw_probe.run(dev, log=lambda m: log(f"[probe] {m}"))
    launches = dict(copy_kernel.LAUNCHES)
    torch.cuda.synchronize()
    for kernel, n in launches.items():
        if n == 0:
            raise RuntimeError(f"the probe path launched {kernel} no time")
    plain = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(*PROBE_SHAPE, device=dev, generator=gen).to(dtype)
        plain[dtype] = timeit_amortized(lambda a, b: copy_kernel.scale_reference(a), x, 10)
        del x
    torch.cuda.empty_cache()
    best = max(rows, key=lambda r: r["gbps"])
    ceiling = best["gbps"] * 1e9
    log(f"[probe] launches on the probe path {launches}; plain x * 2: bf16 {plain[torch.bfloat16]:.4f} ms, "
        f"fp32 {plain[torch.float32]:.4f} ms")
    log(f"[probe] measured copy ceiling {best['gbps']:.1f} GB/s ({best['name']}), "
        f"{ceiling / PEAK_BYTES:.3f} of 3.35 TB/s ({card})")
    return rows, launches, plain, ceiling


# ---------------------------------------------------------------------------
# cli phase
# ---------------------------------------------------------------------------

REPLACES = {
    "scale_copy": "scripts/pallas_stream_probe.py:74, scripts/pallas_bw_probe.py:45",
    "dma_copy": "scripts/pallas_bw_probe.py:113",
}

CLI_DIR = OUT_DIR / "cli"
CLI_BATCH, CLI_BIT_WIDTH = 16, 16_000  # 32 quantizers
CLI_UTTS, CLI_SECONDS = 32, (1.0, 12.0)  # the corpus: utterances of uniformly drawn length
DECODE_PER_BATCH = {"conv1d_s1": 2, "resblock_tgn": 12, "rvq_encode": 0}  # the decoder's half of EXPECT
MIN_FP32_AGREE = 0.999


def _write_corpus(d: Path, lengths_s, sr: int, seed: int) -> dict:
    """Seeded noise utterances as PCM16 wavs and their wav.scp: {key: samples}."""
    d.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    lengths = {}
    with open(d / "wav.scp", "w") as scp:
        for i, sec in enumerate(lengths_s):
            key = f"utt{i:03d}"
            n = int(round(sec * sr))
            pcm = np.clip(np.round(rs.randn(n) * 0.1 * 32767), -32768, 32767).astype(np.int16)
            write_wav(d / f"{key}.wav", pcm, sr)
            scp.write(f"{key} {d / f'{key}.wav'}\n")
            lengths[key] = n
    return lengths


def _codecs(path: Path) -> dict:
    out = {}
    for line in path.read_text().splitlines():
        key, payload = line.split(" ", 1)
        out[key] = np.asarray(json.loads(payload))[0]  # (n_q, T)
    return out


def _run_cli(out: Path, data: str, *args) -> float:
    """cli.main on one input; returns its wall seconds (reads and writes included)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["--config_file", str(CLI_DIR / "config.yaml"), "--model_file", str(CLI_DIR / "model.pth"),
              "--output_dir", str(out), "--data_path_and_name_and_type", data, *args])
    return time.perf_counter() - t0


def _check_wavs(out: Path, want: dict, sr: int, what: str) -> None:
    for key, n in want.items():
        got_sr, wav = read_wav(out / f"{key}.wav", normalize=False)
        if got_sr != sr or wav.shape != (n,) or wav.dtype != np.int16:
            raise RuntimeError(f"cli {what}: {key}.wav is {wav.dtype}{wav.shape} at {got_sr} Hz, "
                               f"expected ({n},) at {sr} Hz")


def cli_phase(dev, config, s_fp, card: str):
    """The file-to-file entry point on the card; returns its numbers."""
    import yaml

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    (CLI_DIR / "config.yaml").write_text(yaml.safe_dump(config))
    torch.save(s_fp.model.state_dict(), CLI_DIR / "model.pth")
    rs = np.random.RandomState(20)
    lengths = _write_corpus(CLI_DIR / "corpus", rs.uniform(*CLI_SECONDS, CLI_UTTS), SR, seed=21)
    corpus_s = sum(lengths.values()) / SR
    scp = f"{CLI_DIR / 'corpus' / 'wav.scp'},speech,sound"
    bf16 = ["--dtype", "bfloat16", "--batch_size", str(CLI_BATCH), "--bit_width", str(CLI_BIT_WIDTH)]
    n_batches = -(-len(lengths) // CLI_BATCH)
    frames = {k: -(-n // 320) for k, n in lengths.items()}

    # the bf16 main path: encode + decode to codecs.txt and wavs
    set_flags(MAIN_PATH)
    reset_counts()
    wall = _run_cli(CLI_DIR / "infer", scp, *bf16)
    counts = read_counts()
    expect = {k: n_batches * v for k, v in EXPECT[MAIN_PATH].items()}
    if counts != expect:
        raise RuntimeError(f"cli inference: launches {counts}, expected {expect} ({n_batches} batches)")
    codes = _codecs(CLI_DIR / "infer" / "codecs.txt")
    if set(codes) != set(lengths):
        raise RuntimeError("cli inference: codecs.txt does not hold every key")
    for key, c in codes.items():
        if c.shape != (32, frames[key]) or c.min() < 0 or c.max() >= 1024:
            raise RuntimeError(f"cli inference: {key} tokens {c.shape}, expected (32, {frames[key]})")
    _check_wavs(CLI_DIR / "infer", lengths, SR, "inference")
    log(f"[cli] inference bf16 B={CLI_BATCH} {CLI_BIT_WIDTH} b/s: {len(lengths)} utterances, {corpus_s:.1f} audio-s "
        f"in {wall:.3f} s = {corpus_s / wall:.1f} audio-s/s end to end (model build, reads and writes included); "
        f"launches {counts} = {n_batches} batches x {EXPECT[MAIN_PATH]} ({card})")

    # its first batch against a direct dispatch of the same padded batch
    s2t = Speech2Token(str(CLI_DIR / "config.yaml"), str(CLI_DIR / "model.pth"), "bfloat16", SR, CLI_BIT_WIDTH,
                       device=dev)
    first = sorted(lengths, key=lambda k: lengths[k])[:CLI_BATCH]  # a stable sort, as the plan's
    wavs = [read_wav(CLI_DIR / "corpus" / f"{k}.wav", normalize=False)[1] for k in first]
    batch = cli._wrap_pad(wavs, cli._bucket_length(max(len(w) for w in wavs), s2t.hop_length))
    direct = s2t.collect(s2t.dispatch(batch, pcm16_ilens=[len(w) for w in wavs]))[0][0]
    for i, key in enumerate(first):
        if not np.array_equal(direct[:, i, : frames[key]], codes[key]):
            raise RuntimeError(f"cli inference: {key}'s tokens differ from a direct Speech2Token.dispatch")
    del s2t
    log(f"[cli] first batch ({len(first)} utterances): tokens equal a direct Speech2Token.dispatch")

    # a second run in the same process, to ark; then decode from codecs.txt and from the ark
    wall_ark = _run_cli(CLI_DIR / "ark", scp, *bf16, "--indices_save_type", "ark")
    ark = ArkScpReader(CLI_DIR / "ark" / "indices.scp")
    for key, c in codes.items():
        if not np.array_equal(ark[key].T.astype(np.int64), c):
            raise RuntimeError(f"cli ark: {key}'s tokens differ from codecs.txt")
    log(f"[cli] second inference run, to indices.ark/scp: {corpus_s / wall_ark:.1f} audio-s/s end to end "
        f"({wall_ark:.3f} s); tokens equal codecs.txt ({card})")
    dec_want = {k: f * 320 for k, f in frames.items()}
    walls = {}
    for name, data in (("decode_json", f"{CLI_DIR / 'infer' / 'codecs.txt'},speech,codec_json"),
                       ("decode_ark", f"{CLI_DIR / 'ark' / 'indices.scp'},speech,kaldi_ark")):
        reset_counts()
        walls[name] = _run_cli(CLI_DIR / name, data, *bf16, "--run_mod", "decode")
        dec_expect = {k: n_batches * v for k, v in DECODE_PER_BATCH.items()}
        if read_counts() != dec_expect:
            raise RuntimeError(f"cli {name}: launches {read_counts()}, expected {dec_expect}")
        _check_wavs(CLI_DIR / name, dec_want, SR, name)
    for key in lengths:
        if (CLI_DIR / "decode_json" / f"{key}.wav").read_bytes() != (CLI_DIR / "decode_ark" / f"{key}.wav").read_bytes():
            raise RuntimeError(f"cli decode: {key}.wav differs between codecs.txt and indices.ark input")
    log(f"[cli] decode from codecs.txt {walls['decode_json']:.3f} s and from indices.ark {walls['decode_ark']:.3f} s: "
        f"equal wavs, launches {n_batches} batches x {DECODE_PER_BATCH}")

    # two 24 kHz files, read and written at their own rate
    hz24 = _write_corpus(CLI_DIR / "corpus24k", (1.3, 2.7), 24_000, seed=22)
    _run_cli(CLI_DIR / "infer24k", f"{CLI_DIR / 'corpus24k' / 'wav.scp'},speech,sound", *bf16,
             "--file_sampling_rate", "24000")
    codes24 = _codecs(CLI_DIR / "infer24k" / "codecs.txt")
    n16 = {k: -(-n * SR // 24_000) for k, n in hz24.items()}  # the length after resampling to 16 kHz
    for key, n in n16.items():
        if codes24[key].shape != (32, -(-n // 320)):
            raise RuntimeError(f"cli 24 kHz: {key} tokens {codes24[key].shape}")
    # as in the JAX pipeline, the recon resampled back to 24 kHz is cut to the 16 kHz length
    _check_wavs(CLI_DIR / "infer24k", n16, 24_000, "24 kHz")
    log(f"[cli] --file_sampling_rate 24000: inputs of {list(hz24.values())} samples, tokens and wavs of "
        f"{list(n16.values())} samples, the wavs at 24 kHz (the JAX pipeline's cut)")

    # fp32 on the card against the CPU, 2 utterances of 1 s
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = rvq.FUSED_RVQ = False
    _write_corpus(CLI_DIR / "corpus_fp32", (1.0, 1.0), SR, seed=23)
    fp32 = [f"{CLI_DIR / 'corpus_fp32' / 'wav.scp'},speech,sound", "--dtype", "float32", "--batch_size", "2",
            "--bit_width", str(CLI_BIT_WIDTH)]
    _run_cli(CLI_DIR / "fp32_cuda", *fp32)
    _run_cli(CLI_DIR / "fp32_cpu", *fp32, "--device", "cpu")
    card_codes, cpu_codes = (_codecs(CLI_DIR / d / "codecs.txt") for d in ("fp32_cuda", "fp32_cpu"))
    agree = float(np.mean(np.concatenate([(card_codes[k] == cpu_codes[k]).ravel() for k in cpu_codes])))
    same = (CLI_DIR / "fp32_cuda" / "codecs.txt").read_bytes() == (CLI_DIR / "fp32_cpu" / "codecs.txt").read_bytes()
    log(f"[cli] fp32 codecs.txt card vs CPU: token agreement {agree:.6f}, byte-equal {same}")
    if agree < MIN_FP32_AGREE:
        raise RuntimeError(f"cli fp32: the card's tokens agree with the CPU's on {agree:.4f} < {MIN_FP32_AGREE}")
    return dict(corpus_s=corpus_s, wall_s=wall, audio_s_per_s=corpus_s / wall, second_wall_s=wall_ark,
                second_audio_s_per_s=corpus_s / wall_ark, batches=n_batches, launches=counts,
                decode_wall_s=walls, fp32_agree=agree, fp32_byte_equal=same)


# ---------------------------------------------------------------------------
# timing phase
# ---------------------------------------------------------------------------


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
    return timeit(lambda: s2t.dispatch(x, bit_width=None), x.device, warmup=1, iters=3)


def _row(name, ms, plain_ms, bound, **extra):
    return dict(name=name, ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1], **extra)


def _shares(row, ceiling: float) -> str:
    """A bytes-bound row's share of the published peak and of the measured
    copy ceiling (the bound stays bytes over the published peak)."""
    if row["bound_by"] != "bytes":
        return ""
    at_peak = row["bound_ms"] / row["ms"]
    return f", {at_peak:.3f} of the published peak, {at_peak * PEAK_BYTES / ceiling:.3f} of the measured ceiling"


def timing_phase(dev, s_bf, s_fp, calls, card: str, ceiling: float):
    gen = torch.Generator(device=dev).manual_seed(2)
    embed = _codebooks(gen, dev)
    x = torch.randn(64, 500, 128, device=dev, generator=gen) * 0.1
    rvq_plain = _cuda_ms(lambda: rvq_kernel.rvq_encode_reference(x, embed, 32), 5)
    rvq_ms = _cuda_ms(lambda: rvq_kernel.rvq_encode_fused(x, embed, 32), 5)
    N, n_q, bins, D = 32_000, 32, 1024, 128
    rvq_bound = _bound(N * D * 2 + n_q * bins * (D * 2 + 4) + n_q * N * 4 + N * D * 4,
                       2.0 * N * n_q * bins * D, PEAK_BF16)
    rvq_row = _row("rvq_encode N=32000 n_q=32", rvq_ms, rvq_plain, rvq_bound, library_ms=None)
    log(f"[time] rvq_encode N=32000 n_q=32: kernel {rvq_ms:.3f} ms, plain torch {rvq_plain:.3f} ms, "
        f"bound {rvq_bound[0]:.3f} ms ({rvq_bound[1]}) ({card})")

    heads, rb_convs, resblocks = calls
    conv_rows, rb_rows = [], []
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = False
    with torch.inference_mode():
        for layer in heads + rb_convs:
            row = _row(layer.name, _cuda_ms(layer.kernel, 5), _cuda_ms(layer.plain, 5), layer.bound_ms(),
                       library_ms=_cuda_ms(layer.library, 5), main_path=layer in heads)
            conv_rows.append(row)
            log(f"[time] conv1d_s1 {layer.name} B={layer.x.shape[0]} T={layer.x.shape[-1]}: kernel "
                f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, cuDNN {row['library_ms']:.3f} ms, "
                f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}){_shares(row, ceiling)} ({card})")
        for call in resblocks:
            row = _row(call.name, _cuda_ms(call.kernel, 5), _cuda_ms(call.plain, 3), call.bound_ms(),
                       library_ms=None, unfused_ms=_cuda_ms(call.unfused, 5))
            rb_rows.append(row)
            log(f"[time] resblock_tgn {call.name} B={call.x.shape[0]}: kernel {row['ms']:.3f} ms "
                f"(3 passes), plain {row['plain_ms']:.3f} ms, unfused block {row['unfused_ms']:.3f} ms, "
                f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}){_shares(row, ceiling)} ({card})")

    speech = torch.from_numpy(_speech(5, 64, 10.0)).to(dev)
    serving = {}
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = rvq.FUSED_RVQ = False
    serving["fp32-exact"] = _serve_seconds(s_fp, speech)
    for path, label in (("unfused", "bf16+rvq"), ("stride1", "bf16+rvq+stride1"),
                        (MAIN_PATH, "bf16+rvq+stride1+resblock")):
        set_flags(path)
        serving[label] = _serve_seconds(s_bf, speech)
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = rvq.FUSED_RVQ = False
    for label, t in serving.items():
        log(f"[time] serving B=64 x 10 s encode+decode {label}: {640 / t:.1f} audio-s/s "
            f"({t * 1e3:.1f} ms) ({card})")
    return rvq_row, conv_rows, rb_rows, serving


def _summed(rows, n=1):
    """One JSON entry's numbers from per-shape rows, each shape run n times per request."""
    keys = ("ms", "plain_ms", "bound_ms")
    out = {k: n * sum(r[k] for r in rows) for k in keys}
    by = {b: sum(r["bound_ms"] for r in rows if r["bound_by"] == b) for b in ("bytes", "operations")}
    out["bound_by"] = max(by, key=by.get)
    return out


def profile(dev) -> None:
    """torch.profiler over one B = 64 x 10 s request of each bf16 path."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    _, s_bf, _ = build_models(dev)
    speech = torch.from_numpy(_speech(5, 64, 10.0)).to(dev)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for path in ("unfused", MAIN_PATH):
        set_flags(path)
        for _ in range(2):
            s_bf.dispatch(speech, bit_width=None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s_bf.dispatch(speech, bit_width=None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(e.self_device_time_total for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=30)
        (OUT_DIR / f"profile_{path}.txt").write_text(table)
        log(f"[profile] {path}: wall {wall * 1e3:.1f} ms, device kernel time {busy:.1f} ms, idle share "
            f"{max(0.0, 1 - busy / (wall * 1e3)):.3f}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({card_line(CARD)})")
        log(table)


def main() -> int:
    dev = check_device()
    card = card_line(CARD)
    build_phase()
    if "--profile" in sys.argv[1:]:
        profile(dev)
        return 0
    config, s_bf, s_fp = build_models(dev)
    calls = flagship_calls(s_bf, dev)
    rvq_err = rvq_kernel_phase(dev)
    seanet_errs = seanet_kernel_phase(dev, calls)
    counts, flips = serving_phase(config, s_bf, s_fp)
    probe_rows, probe_launches, probe_plain, ceiling = probe_phase(dev, card)
    cli_stats = cli_phase(dev, config, s_fp, card)
    rvq_row, conv_rows, rb_rows, serving = timing_phase(dev, s_bf, s_fp, calls, card, ceiling)
    if "funcodec_tpu" in sys.modules or ("jax" in sys.modules and not _JAX_PRELOADED):
        raise RuntimeError("the port imported JAX or the JAX package")

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "timings.json").write_text(json.dumps(dict(
        card=card, rvq=rvq_row, conv=conv_rows, resblock=rb_rows, serving_seconds=serving,
        flips=flips, launches=counts, probe=probe_rows, probe_launches=probe_launches,
        copy_ceiling_bytes_per_s=ceiling, cli=cli_stats), indent=1))
    conv_main = _summed([r for r in conv_rows if r["main_path"]])
    conv_main["library_ms"] = sum(r["library_ms"] for r in conv_rows if r["main_path"])
    rb_main = _summed(rb_rows, n=2)  # the encoder's and the decoder's block at each width
    rb_main["library_ms"] = None
    rb_main["unfused_ms"] = 2 * sum(r["unfused_ms"] for r in rb_rows)
    kernels = [
        dict(name="rvq_encode", route="cuda", source="funcodec_tpu_torch/csrc/rvq_encode.cu",
             replaces="funcodec_tpu/quant/rvq_pallas.py:29", launches=counts["rvq_encode"],
             max_abs_err=rvq_err, ms=rvq_row["ms"], plain_ms=rvq_row["plain_ms"],
             bound_ms=rvq_row["bound_ms"], bound_by=rvq_row["bound_by"], library_ms=None),
        dict(name="conv1d_s1", route="cuda", source="funcodec_tpu_torch/csrc/conv1d_s1.cu",
             replaces="funcodec_tpu/ops/conv_pallas.py:59", launches=counts["conv1d_s1"],
             max_abs_err=seanet_errs["conv1d_s1"], **conv_main),
        dict(name="resblock_tgn", route="cuda", source="funcodec_tpu_torch/csrc/resblock_tgn.cu",
             replaces="funcodec_tpu/ops/resblock_pallas.py:86", launches=counts["resblock_tgn"],
             max_abs_err=seanet_errs["resblock_tgn"], **rb_main),
    ]
    for name, variant in (("scale_copy", "A tile=4000"), ("dma_copy", "D dma_copy")):
        row = next(r for r in probe_rows if r["name"] == variant)  # bf16 at the probe shape
        kernels.append(dict(
            name=name, route="cuda", source="funcodec_tpu_torch/csrc/copy_probe.cu",
            replaces=REPLACES[name], launches=probe_launches[name], max_abs_err=0.0, ms=row["ms"],
            plain_ms=probe_plain[torch.bfloat16], bound_ms=row["bound_ms"], bound_by="bytes",
            library_ms=row["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
