"""Chip smoke test of the PyTorch/CUDA port (funcodec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # the smoke run below
    python3 chip_smoke.py --profile   # checks, build, then a torch.profiler table of
                                      # one B = 64 x 10 s request per serving path,
                                      # of one bf16 shared training step (B = 16), of
                                      # one 16-slot LauraTTS session segment, of
                                      # one FreqCodec gr8 bf16 request (B = 64) and
                                      # of one bf16 Laura training step
                                      # (tables also in build/chip_smoke/)

Drives the port's main paths on the flagship (EnCodec 16 kHz nq32ds320,
the egs/LibriTTS/codec/conf/encodec_16k_n32_600k_step.yaml model at full
width, seeded random weights): serving through ``Speech2Token``, the GAN
train step (``train.step.make_gan_train_step``) with its discriminator, and
the training loop behind ``cli/codec_train``; then LauraTTS serving on the
shipped LauraTTS topology through ``cli/text2audio_inference``; then
FreqCodec, the second codec family, served and trained at its released
gr8 and gr1 topologies; then the LibriTTS Laura recipe (tokens, LM
training through ``cli/text2audio_train``, synthesis); data parallelism;
then the LibriTTS codec recipe's tooling (wav arks, --stat_flops, n-best
averaging, scoring) with the residual and identity quantizers, the context
loss and the semantic codec; a streaming session on the causal EnCodec;
the HiFiGAN generator, the HiFiGAN and SoundStream discriminators, the
Kaldi fbank frontend and the .ecdc coder; and the JAX package's .ckpt
weights files served and averaged.
In phases that each raise on failure:

1. checks: a CUDA card is present; TF32 is turned off for fp32 matmuls and
   cuDNN; the card's name and power limit are printed.
2. build: csrc/*.cu compiled with nvcc for sm_90a, one nvcc per source in
   parallel (time, ptxas registers / shared memory / spills per kernel; the
   fused conv's kernel, tiles, shared memory and blocks an SM per flagship
   layer).
3. kernel: each kernel against its plain torch version. RVQ encode at the
   flagship shapes (N = 32,000 tokens x 32 stages x 1024 bins x 128), a
   ragged N, n_q = 16, bins = 1000, N = 1 and n_q = 1, each launched twice
   (equal results; 51 times at the flagship shape). The fused conv at every flagship layer it serves
   (B = 64 x 10 s), a dilated causal replicate case, ragged T on every
   kernel, a T shorter than one tile and one step longer, B = 1 and 2, 24 ->
   40 channels (the first kernel) and an fp32 case, each launched twice
   (equal results). The fused resblock at the four flagship widths (B = 64 x 10 s), a
   ragged T, an fp32 case, B = 16 and B = 1 (grids smaller than the card), a
   T shorter than one tile and T = tile + 1, a capped grid, each launched
   twice (equal results); the finalize kernel against finalize_affine. bf16
   outputs are held to 2 bf16 ulps of the output's largest value.
4. serving: B = 8 x 10 s requests on three bf16 paths, each with FUSED_RVQ:
   unfused SEANet; FUSED_STRIDE1; FUSED_STRIDE1 + FUSED_RESBLOCK (the main
   path of this slice). Every kernel's launch count is read around each
   request against what the gates imply; the main path's first request
   served twice gives identical tokens. Token flip rates between the
   paths and against the fp32-exact path; the fp32 path on the card
   against the same model on the CPU for a short clip.
   Then the sync check: one B = 64 x 5.825 s main-path request (int16 in,
   PCM16 out, as the benchmark serves it) under
   torch.cuda.set_sync_debug_mode("warn") with a profiler active; every
   synchronising call must fall in a program span marked wait
   (utils/profiling.py), and the spans must lie inside the trace's events
   of their names, 0.1 ms from them in the median.
5. probe: the HBM copy probes (csrc/copy_probe.cu, ops/copy_kernel.py).
   scale_copy (several tiles and row counts) and dma_copy (several chunk
   sizes, one too large for a ring of 4 slots) held bit for bit to x * 2 in bf16 and fp32 at
   the probe shape 256 x 20,000 x 128, a ragged T and a row count that is
   not a multiple of chunk_rows; then the probe path, tools/bw_probe.run
   (every tile and block shape, dma_copy, torch.mul, copy_), whose best
   rate is the measured copy ceiling.
6. cli: the file-to-file entry point, cli/codec_inference.main, on a
   seeded corpus of 32 noise utterances of 1-12 s (16 kHz PCM16) under
   build/chip_smoke/cli/: bf16 on the main path at batch 16 and 16 kb/s
   (32 quantizers) with exact launch counts, the same run again (equal
   bytes), its first batch against a direct Speech2Token.dispatch, decode from codecs.txt, the ark round
   trip, two 24 kHz files through --file_sampling_rate, and fp32
   codecs.txt on the card against the CPU; end-to-end audio-s/s.
7. timing: each kernel against its plain version (and cuDNN / the unfused
   block) at each flagship shape, beside its bound; conv1d_s1, resblock_tgn
   and rvq_encode also against their first versions (the legacy device code,
   in turns new, old, old, new), with each bytes-bound
   row's share of the published peak and of the measured copy ceiling; the
   B = 64 x 10 s serving rate of fp32-exact, bf16 + RVQ kernel,
   + FUSED_STRIDE1 and + both SEANet flags. The per-shape rows also go to
   build/chip_smoke/timings.json (git-ignored).
8. training: the flagship and its MS-STFT discriminator built from the
   yaml with the recipe's quantizer (k-means init, dropout over [1, 2, 4,
   8, 16, 32], effective expiry) and Adam (lr 3e-4, betas 0.5, 0.9) for
   both; 4 steps of B = 16 x 2.56 s of seeded noise at 0.1 rms in each of
   fp32 train_step (the two-forward step), fp32 shared_train_step, bf16
   shared_train_step and bf16 shared_train_step with FUSED_STRIDE1 and
   FUSED_RESBLOCK: finite stats, 4 steps, the codebooks initialized after
   step 1 a prefix of the drawn depth, both modules' parameters moved,
   fp32 masters, a positive gate carry, and per step exactly the fused
   configuration's forward launches (4 convs, 24 resblock passes, 16
   finalizes; the backwards launch none, the others none at all). Then the
   generator's gradients with both SEANet flags against without (fp32 and
   bf16, no draws); each fused backward against autograd through its plain
   version at every flagship training shape (the four head convs, the
   eight residual blocks) in fp32 and bf16, timed; one fp32 two-forward
   step at B = 2 on the card against the CPU from the same weights (stats
   and per-module gradient norms); and ms a step, training audio-s/s and
   peak memory of the four configurations at B = 16 and of the bf16 shared
   step at B = 64, steady state (initialized codebooks).
9. trainer: the training entry point, cli/codec_train.main, on the flagship
   yaml (the recipe's quantizer) with a seeded corpus under
   build/chip_smoke/train/ (40 train utterances of 1.5-6 s, so that both the
   pad and the crop to 2.56 s happen; 8 valid utterances of 1.5-2.5 s):
   bf16, the three kernels on, batch 16, 2 epochs x 4 steps with exact
   launch counts (8 steps x the fused step's, and each validation batch's
   one encode + decode with rvq_encode); the checkpoint contract's files and
   finite stats; resumed to epoch 3 (the loaded state equal to
   checkpoint.pth bit for bit, step 12, epochs 1-2 unchanged); after each
   of 4 more in-place updates, validation with the fused SEANet kernels
   against without, on the same RVQ codes (no stale packed weights; codes
   of the unfused scan differ only at near-ties); one epoch from the device cache with
   stats_interval 2 (its crops equal to the host gather of the same
   offsets); latest.pth served by cli/codec_inference (tokens equal to a
   direct Speech2Token.dispatch, every codebook initialized); the loop's
   audio-s/s over its steady epoch with the host loader and with the device
   cache, against the bare step's, the checkpoint write and the validation
   wall.

10. tts: LauraTTS serving (models/{transformer,laura,tts_serving}.py,
   cli/text2audio_inference) on the shipped
   egs/LibriTTS/text2speech_laura yaml at full width (88,669,186
   parameters with a seeded 256-word list; seeded weights; the flagship
   codec's codebooks grafted in): fp32 logits on the card against the CPU
   (the prefill of three requests, 32 teacher-forced steps, syn_audio's
   codec_emb) and the incremental decode against the full forward, within
   1e-3; 8 greedy requests through decode_codec, decode_codec_batch and a
   4-slot session with slot reuse (token agreement, and the three layouts'
   teacher-forced logits within 1e-3); one zero-shot request through
   Text2Audio with the three codec kernels, launches exact (the prompt's
   encode, decode and decode_emb), each of its SEANet kernel calls against
   the plain version on its own inputs, gen and gen_only_lm against the
   kernels off; the CLI with --serving_slots 4 and --batch_size 1 on an 8-line
   text_scp under build/chip_smoke/tts/; and the timing of
   scripts/bench_tts_serving.py's workload (48 requests, caps 50-250, 16
   slots) on the session (best of 3) and on lockstep batches (one timed
   run), bf16 and fp32.
   ``--profile`` adds one 25-step segment of a 16-slot session.
11. freq: FreqCodec mag_phase at the gr8 and gr1 topologies of
   scripts/bench_freqcodec.py (a copy of its freq_config; 9,932,201 and
   9,418,793 parameters, seeded, kmeans_init off): B = 8 x 10 s requests
   on three bf16 paths (no kernel; FUSED_RVQ; + FUSED_STRIDE1 +
   FUSED_RESBLOCK) with exact launches (the main path: rvq_encode 1,
   conv1d_s1 2, the resblock kernels 0 a request: FreqCodec's residual
   blocks are 2D), each kernel call of the main path's requests against its
   plain version on its own inputs, the first request served again equal;
   flips against the fp32-exact path; fp32 on the card against the CPU
   (tokens equal but at near-ties, the decode of the same tokens within
   1e-4); conv1d_s1 at its two T = 501 shapes against its plain version and
   cuDNN; the CLI (encode, then decode) on 4 seeded utterances; encode +
   decode of B = 64 x 10 s, fp32-exact and the three bf16 paths, with peak
   memory; istft alone; 2 bf16 shared GAN steps with phase-invariant
   training at B = 16 x 2.56 s (exact launches), then ms a step.
   ``--profile`` adds one gr8 bf16 main-path request (the share of cuDNN's
   2D convs and of cuFFT).
12. laura: the LibriTTS Laura recipe (egs/LibriTTS/text2speech_laura/run.sh)
   end to end under build/chip_smoke/laura/, on a seeded corpus of 128 train
   and 16 valid noise utterances of 2-8 s with a text line of seeded
   phonemes each (12 a second, from the recipe's arpabet_tokens.txt).
   Stage 1: cli/codec_inference --run_mod encode --batch_size 8 --bit_width
   16000 --indices_save_type ark on the flagship (seeded, a .pth), bf16 with
   the three flags, launches exact (the encode mode's RVQ is the exact fp32
   scan: no rvq_encode), the valid split's SEANet kernel calls held against
   their plain versions. Stage 2: cli/text2audio_train on the shipped LauraTTS
   yaml at full width (88,395,778 parameters), fp32, 2 epochs at batch_bins
   10240, the codebook grafted from the codec's .pth: the checkpoint files,
   links and finite reporter.json, no codec kernel launch, the codebook
   unchanged, every module moved; resumed to epoch 3 (the loaded state equal
   to checkpoint.pth bit for bit, epochs 1-2 unchanged); held_out_token_nll
   on the valid set; one fp32 forward and backward on the card against the
   CPU (sampling ratio 0): the loss, stats and module gradient norms. The
   bare step at batch_bins 10240 in fp32 and in bf16 over fp32 masters: ms,
   training codec frames/s, peak memory, device kernels a step; the loop's
   steady epoch against it, the checkpoint write, the validation wall.
   Stage 3: cli/text2audio_inference --model_file exp/latest.pth on 4 lines,
   one with a zero-shot prompt from the corpus, the three flags on: launches
   exact, each codec kernel call held against its plain version.
   ``--profile`` adds one bf16 training step at about batch_bins 10240.

13. dp: data parallelism (parallel/dist.py). The flagship's bf16 shared
   steps with both SEANet flags (B = 16 x 2.56 s, the recipe's quantizer)
   at world 1 through an NCCL group, in a process of its own with torch's
   deterministic algorithms: 3 steps bit for bit the no-group path's,
   launches exact; then, with the default algorithms, steady ms a step
   with and without the group and the gradient all_reduce's ms. World 2
   through gloo on the one card (two spawned processes on cuda:0: NCCL
   refuses two ranks on one device), fp32 with TF32 off, global B = 16,
   SGD and initialized codebooks: the ranks' parameters and codebooks bit
   for bit equal and within rtol 2e-4 / atol 2e-5 of world 1's (JAX's
   data-parallel tolerance; world 1 takes the ranks' codes, each of its
   own that differs a near-tie), each rank's kernel calls against their
   plain versions, ms a step; the Laura trainer at full width, 2 steps at
   world 2 against world 1 (the ranks holding unequal token counts).
   Speech2Token with two replicas on the card: fp32-exact tokens equal to
   one replica's, bf16 main-path launches exact per replica, the first
   request's kernel calls against their plain versions, codes differing
   only at near-ties, each replica its own packed weights.
14. recipe: the codec recipe (egs/LibriTTS/codec/run.sh) end to end under
   build/chip_smoke/recipe/, and the remaining codec models, bf16 with the
   three flags, every kernel launch counted against what the gates imply
   and every kernel call held against its plain version. A seeded corpus
   of 40 + 8 utterances of 24 kHz PCM16 dumped to 16 kHz wav arks by
   cli/dump_to_wav_ark (4 shards) and scanned by calc_shape; cli/codec_train
   --stat_flops on the flagship yaml with a residual_quantizer (1,024 x 32,
   quantize dropout) and the context loss (a 6-block transformer, masked
   prediction), 2 epochs x 4 steps at B = 16 x 2.56 s, the logged cost tree
   and summary checked; cli/average_nbest over its two epochs (the fp64
   mean); cli/codec_inference on the averaged weights (encode with
   --stat_flops to codecs.txt, decode to wavs); cli/codec_eval's
   quality.json (complete, finite); CodecSemanticAug in its five PPG modes
   (forward_generator_ppg and backward at B = 16 x 2.56 s, inference_ppg at
   B = 8 x 10 s); one identity_quantizer step; codec_flops_tree equal with
   the flags on and off. Then the steady bf16 step with and without the
   context loss (6 steps a side, in turns), ms and device kernels a step.
15. streaming: models/streaming.StreamingCodecSession on the causal
   weight_norm EnCodec of scripts/bench_streaming.py (16 kHz, n_filters 32,
   dimension 128, ratios 8·5·4·2, a 2-layer LSTM, 32 x 1024 codebooks, no
   audio_normalize; 14,851,810 seeded parameters) built by
   build_codec_model. Two seeded 10 s clips at B = 2 streamed as a 2,560-sample
   first chunk (reflect pads need 2,240), then 20, 80 and 320 ms chunks in
   turns, then flush(). fp32 (TF32 off): tokens equal to
   inference_encoding(use_scale=False) but at near-ties, samples within 2e-4
   (of the output's scale) of the whole decode of the same tokens. bf16 with
   FUSED_STRIDE1 (and FUSED_RVQ, which the session's fp32 scan never
   reaches): conv1d_s1 in the first encode and the first decode chunk only
   (6 each), every count set to 0 before the stream and read after, each
   call held against its plain version; token flips against fp32 within
   the sanity bound. Then the steady round trip (encode_chunk +
   decode_chunk) of a primed fp32 session at B = 1 and 8 and chunks of 20,
   80 and 320 ms: ms (best of 20, fenced), real-time factor per stream and
   in all, device kernels a round trip.
16. extras: the HiFiGAN generator at its defaults (80 mels, 512 channels,
   x256) at B = 4 x 200 frames and each of the seven extra discriminators
   at its defaults at B = 2 x 1 s, fp32 on the card against the CPU from
   the same weights (1e-4 of each tensor's scale); two bf16 shared GAN
   steps of the flagship yaml's generator with both SEANet flags against
   HiFiGAN MSMPD + SoundStream + complex-STFT at B = 16 x 2.56 s (launches
   exact per step, each kernel call held against its plain version, finite
   stats, both modules moved), then its steady ms a step and peak memory
   beside the MS-STFT step's; WavFrontend (80 mels, LFR 7/6, a seeded CMVN
   file) at B = 8 x 10 s on the card against the CPU; compress_tokens /
   decompress_tokens of the streamed tokens (bytes, host ms, equal).
17. jax_ckpt: the JAX package's checkpoint files (flax msgpack .ckpt),
   which no JAX writes here: compat/torch_import and compat/flax_msgpack
   make them with JAX's bytes (tests/test_torch_jax_ckpt.py holds that on
   the CPU). The seeded flagship (14,855,843 parameters) to flagship.ckpt
   and back onto the card bit for bit; B = 8 x 10 s served through
   Speech2Token from .ckpt and from .pth in fp32 (flags off) and in bf16
   with the three flags, tokens and recon bit-equal; the shipped LauraTTS
   yaml at full width (88,669,186 parameters) to laura.ckpt, one seeded
   zero-shot request through Text2Audio from .ckpt and from .pth (the codec
   in bf16 with the three flags), tokens and wavs equal; cli/average_nbest
   over three seeded flagship epochs as .ckpt and as .pth, the two averages
   equal bit for bit. Every count set to 0 before the phase and read after,
   each kernel call held against its plain version; file bytes and load
   seconds printed.

The line before the last is the card's name and power limit (nvidia-smi),
the one before it a JSON object of the kernels (with each one's launches in
the fused training configuration, in the trainer phase's two-epoch run, in
the TTS phase's zero-shot request, in the FreqCodec main-path requests, in
the Laura recipe's stages 1 and 3, in the data-parallel phase, on the
codec recipe's path, in the streaming session, in the extras phase's GAN
steps and in the JAX checkpoint phase, and the backwards' times); the last
line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
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
from funcodec_tpu_torch.models.hifigan_gen import HiFiGANConfig, HiFiGANGenerator  # noqa: E402
from funcodec_tpu_torch.models.seanet import (  # noqa: E402
    SEANetConfig,
    SEANetResnetBlock,
    _resblock_layers,
    make_layer,
)
from funcodec_tpu_torch.models.streaming import StreamingCodecSession  # noqa: E402
from funcodec_tpu_torch.ops import conv_kernel, copy_kernel, resblock_kernel  # noqa: E402
from funcodec_tpu_torch.ops.fbank import WavFrontend  # noqa: E402
from funcodec_tpu_torch.ops.pad import conv_padding_total, pad1d_time, split_padding  # noqa: E402
from funcodec_tpu_torch.quant import rvq_kernel  # noqa: E402
from funcodec_tpu_torch.quant.entropy import compress_tokens, decompress_tokens  # noqa: E402
from funcodec_tpu_torch.tasks.codec import build_codec_model, build_discriminator, load_config  # noqa: E402
from funcodec_tpu_torch.tools import bw_probe  # noqa: E402
from funcodec_tpu_torch.tools.benchlib import PEAK_BYTES, card_line, timeit, timeit_amortized  # noqa: E402
from funcodec_tpu_torch.train.gan_trainer import step_generator  # noqa: E402
from funcodec_tpu_torch.train.step import (  # noqa: E402
    create_gan_train_state,
    generator_grads,
    global_norm,
    make_gan_train_step,
    make_optimizer,
)

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
# 4 head convs + 8 resblock k3 convs; or the 4 head convs and 8 blocks x (3 passes + 2 finalizes)
EXPECT = {
    "unfused": {"conv1d_s1": 0, "resblock_tgn": 0, "resblock_tgn_finalize": 0, "rvq_encode": 1},
    "stride1": {"conv1d_s1": 12, "resblock_tgn": 0, "resblock_tgn_finalize": 0, "rvq_encode": 1},
    "stride1+resblock": {"conv1d_s1": 4, "resblock_tgn": 24, "resblock_tgn_finalize": 16, "rvq_encode": 1},
}
FLAGS = {"unfused": (False, False), "stride1": (True, False), "stride1+resblock": (True, True)}
MAIN_PATH = "stride1+resblock"
COUNTERS = {"conv1d_s1": (conv_kernel, "LAUNCHES"), "resblock_tgn": (resblock_kernel, "LAUNCHES"),
            "resblock_tgn_finalize": (resblock_kernel, "FINALIZE_LAUNCHES"), "rvq_encode": (rvq_kernel, "LAUNCHES")}


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
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    copy_kernel.LAUNCHES.update(scale_copy=0, dma_copy=0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def build_phase() -> None:
    t0 = time.perf_counter()
    lib = build.load()
    rep = build.build_report()
    log(f"[build] {rep['path']} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {rep['seconds']:.2f} s, cached={rep['cached']})")
    for line in str(rep["ptxas"]).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")
    log(f"[build] dynamic shared memory per block: rvq_encode {lib.rvq_encode_smem_bytes(0)} B "
        f"(384 threads, 1 block an SM; legacy {lib.rvq_encode_smem_bytes(1)} B)")
    for ci, co, k in ((1, 32, 7), (512, 128, 7), (128, 512, 7), (32, 1, 7), (32, 16, 3), (64, 32, 3), (128, 64, 3),
                      (256, 128, 3)):
        geo = (ci, co, k, 1, (k - 1) - (k - 1) // 2, 1)  # Cin, Cout, K, dilation, left, bf16
        log(f"[build] conv1d_s1 {ci}->{co} k{k} bf16: {conv_kernel.REGIMES[lib.conv1d_s1_regime(*geo, 0)]}, "
            f"{lib.conv1d_s1_out_tile(*geo, 0)} output / {lib.conv1d_s1_chunk(*geo, 0)} input channels a tile / chunk, "
            f"{lib.conv1d_s1_smem_bytes(*geo, 0)} B shared memory, {lib.conv1d_s1_blocks_per_sm(*geo, 0)} blocks an SM "
            f"(0: not persistent); legacy {lib.conv1d_s1_smem_bytes(*geo, 1)} B")
    kinds = {0: "legacy", 1: "persistent, resident weights", 2: "persistent, streamed weights"}
    for c in (32, 64, 128, 256):
        geo = (c, c // 2, 3, 1, 1, 1)  # C, H, K, dilation, left, bf16
        log(f"[build] resblock_tgn C={c} bf16: {kinds[lib.resblock_tgn_kind(*geo, 0)]}, tile {lib.resblock_tgn_tile(*geo, 0)}, "
            f"{lib.resblock_tgn_smem_bytes(*geo, 0)} B shared memory, blocks an SM per pass "
            f"{[lib.resblock_tgn_blocks_per_sm(m, *geo, 0) for m in range(3)]}; legacy tile "
            f"{lib.resblock_tgn_tile(*geo, 1)}, {lib.resblock_tgn_smem_bytes(*geo, 1)} B")


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


RVQ_REPEATS = 50  # launches held equal to the first at the flagship shape


def rvq_kernel_phase(dev) -> float:
    """The kernel against rvq_encode_reference; returns the largest
    |quant difference| over rows whose tokens all agree."""
    gen = torch.Generator(device=dev).manual_seed(1)
    full = _codebooks(gen, dev)
    worst = 0.0
    for name, (B, T), n_q, bins in (("flagship", (64, 500), 32, 1024), ("ragged", (1, 137), 32, 1024),
                                    ("nq16", (64, 500), 16, 1024), ("bins1000", (4, 500), 32, 1000),
                                    ("one token", (1, 1), 32, 1024), ("nq1", (64, 500), 1, 1024)):
        embed = full if bins == 1024 else full[:, :bins].contiguous()
        x = torch.randn(B, T, 128, device=dev, generator=gen) * 0.1
        k_idx, k_quant = rvq_kernel.rvq_encode_fused(x, embed, n_q)
        for _ in range(RVQ_REPEATS if name == "flagship" else 1):  # a rare race shows only over many launches
            again = rvq_kernel.rvq_encode_fused(x, embed, n_q)
            if not (torch.equal(k_idx, again[0]) and torch.equal(k_quant, again[1])):
                raise RuntimeError(f"rvq_encode {name}: two launches on the same input differ")
        if int(k_idx.min()) < 0 or int(k_idx.max()) >= bins:
            raise RuntimeError(f"rvq_encode {name}: an index outside [0, {bins})")
        r_idx, r_quant = rvq_kernel.rvq_encode_reference(x, embed, n_q)
        q0, all_, rows, err = _compare(k_idx, k_quant, r_idx, r_quant)
        log(f"[kernel] rvq_encode {name}: N={B * T} n_q={n_q} bins={bins} agree q0={q0:.6f} all={all_:.6f} "
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
        self.name, self.act, self.spec, self.conv = name, act, spec, conv
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

    def legacy(self):
        """The first version of the device code (one block per tile, wmma over an im2col tile)."""
        return conv_kernel.fused_conv1d_s1(*self.args(), variant="legacy")

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

    def __init__(self, name, block, B, T, dtype, dev, seed, **kwargs):
        self.name, self.block, self.kwargs = name, block, kwargs
        self.convs = (block.block[1], block.block[3], block.shortcut)
        C = self.convs[0].spec.in_channels
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.x = torch.randn(B, C, T, device=dev, generator=gen).to(dtype)

    def kernel(self):
        return resblock_kernel.fused_resblock_tgn(self.x, *self.convs, **self.kwargs)

    def legacy(self):
        """The first version of the device code (one block per tile and sample)."""
        return resblock_kernel.fused_resblock_tgn(self.x, *self.convs, variant="legacy")

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


def _conv24x40(dev, seed):
    """A zero-padded 24 -> 40 channel k3 d3 conv: channel counts the tensor-core kernels do not take."""
    from funcodec_tpu_torch.ops.conv import ConvSpec, SConv1d

    gen = torch.Generator(device=dev).manual_seed(seed)
    return SConv1d(ConvSpec(24, 40, 3, dilation=3, pad_mode="constant"), device=dev, generator=gen).to(torch.bfloat16)


def seanet_kernel_phase(dev, calls):
    """The fused conv and resblock kernels against their plain versions."""
    heads, rb_convs, resblocks = calls
    errs = {"conv1d_s1": 0.0, "resblock_tgn": 0.0}
    bf = torch.bfloat16
    rb = [_extra_block(c, 1, False, "reflect", bf, dev, 42 + i).block[1] for i, c in enumerate((32, 64, 128, 256))]
    extra_convs = [
        ConvLayer("dilated causal replicate elu 64->32 k3 d9",
                  _extra_block(64, 9, True, "replicate", bf, dev, 40).block[1], 64, 80_000, "elu", bf, dev, 41),
        ConvLayer("ragged elu 32->16 k3 T=160003", rb[0], 64, 160_003, "elu", bf, dev, 43),
        ConvLayer("fp32 elu 128->64 k3", _extra_block(128, 1, False, "reflect", torch.float32, dev, 44).block[1],
                  8, 20_000, "elu", torch.float32, dev, 45),
        # tiles shorter than one (256 steps) and one step longer, B = 1, T % 8 != 0 on every kernel
        ConvLayer("short elu 64->32 k3 T=100", rb[1], 2, 100, "elu", bf, dev, 46),
        ConvLayer("tile+1 elu 128->64 k3 T=257", rb[2], 2, 257, "elu", bf, dev, 47),
        ConvLayer("B=1 elu 256->128 k3 T=4000", rb[3], 1, 4000, "elu", bf, dev, 48),
        ConvLayer("ragged enc_first 1->32 k7 T=16003", heads[0].conv, 4, 16_003, None, bf, dev, 49),
        ConvLayer("ragged dec_last elu 32->1 k7 T=16001", heads[3].conv, 4, 16_001, "elu", bf, dev, 50),
        ConvLayer("ragged enc_last elu 512->128 k7 T=501", heads[1].conv, 2, 501, "elu", bf, dev, 51),
        ConvLayer("B=2 dec_first 128->512 k7 T=250", heads[2].conv, 2, 250, None, bf, dev, 52),
        ConvLayer("legacy 24->40 channels gelu k3 d3", _conv24x40(dev, 53), 2, 3000, "gelu", bf, dev, 54),
    ]
    with torch.inference_mode():
        for layer in heads + rb_convs + extra_convs:
            out = layer.kernel()
            again = layer.kernel()
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise RuntimeError(f"conv1d_s1 {layer.name}: two launches on the same input differ")
            del again
            err = _held("conv1d_s1", layer.name, out, layer.plain())
            if layer.x.dtype == torch.bfloat16:
                errs["conv1d_s1"] = max(errs["conv1d_s1"], err)
        extra_blocks = [
            ResblockCall("ragged C=64 T=80003", _extra_block(64, 1, False, "reflect", torch.bfloat16, dev, 50),
                         64, 80_003, torch.bfloat16, dev, 51),
            ResblockCall("fp32 C=128 T=20000", _extra_block(128, 1, False, "reflect", torch.float32, dev, 52),
                         8, 20_000, torch.float32, dev, 53),
            # grids smaller than the card, tiles shorter than one and one step longer, a capped grid
            ResblockCall("B=16 C=32 T=16000", resblocks[0].block, 16, 16_000, torch.bfloat16, dev, 54),
            ResblockCall("B=1 C=64 T=8000", resblocks[1].block, 1, 8_000, torch.bfloat16, dev, 55),
            ResblockCall("B=1 C=256 T=400", resblocks[3].block, 1, 400, torch.bfloat16, dev, 56),
            ResblockCall("short C=32 T=100", resblocks[0].block, 2, 100, torch.bfloat16, dev, 57),
            ResblockCall("tile+1 C=32 T=257", resblocks[0].block, 2, 257, torch.bfloat16, dev, 58),
            ResblockCall("tile+1 C=128 T=129", resblocks[2].block, 2, 129, torch.bfloat16, dev, 59),
            ResblockCall("tile+1 C=256 T=65", resblocks[3].block, 2, 65, torch.bfloat16, dev, 60),
            ResblockCall("3 blocks C=64 T=4096", resblocks[1].block, 3, 4096, torch.bfloat16, dev, 61, max_blocks=3),
            ResblockCall("dilated causal C=256 T=1003",
                         _extra_block(256, 3, True, "replicate", torch.bfloat16, dev, 62), 2, 1003, torch.bfloat16, dev, 63),
            ResblockCall("legacy C=32 T=2000", resblocks[0].block, 2, 2000, torch.bfloat16, dev, 64, variant="legacy"),
        ]
        for call in resblocks + extra_blocks:
            out = call.kernel()
            again = call.kernel()
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise RuntimeError(f"resblock_tgn {call.name}: two launches on the same input differ")
            del again
            err = _held("resblock_tgn", call.name, out, call.plain())
            if call.x.dtype == torch.bfloat16:
                errs["resblock_tgn"] = max(errs["resblock_tgn"], err)
        errs["resblock_tgn_finalize"] = finalize_kernel_phase(dev, resblocks[0])
    return errs


def _finalize_case(dev, call):
    """Seeded partials of one pass at the call's shape, and the affine tensor."""
    B, C, T = call.x.shape
    lib = build.load()
    n_t = -(-T // lib.resblock_tgn_tile(C, C // 2, 3, 1, 1, 1, 0))
    gen = torch.Generator(device=dev).manual_seed(70)
    part = torch.rand(B, n_t, 4, device=dev, generator=gen, dtype=torch.float64) * 1e4
    part[:, :, 1::2] += part[:, :, 0::2] ** 2 / (C // 2 * 256)  # sumsq above sum^2 / n
    w = resblock_kernel.packed_weights(*call.convs, call.x.dtype)
    return part, torch.zeros(B, 6, C, device=dev), T, [(w["g1"], w["be1"], 0), (w["gs"], w["bes"], 4)]


def _finalize_plain(part, aff, T, pairs):
    tot = part.sum(dim=1)
    for p, (gamma, beta, slot) in enumerate(pairs):
        n = gamma.shape[0]
        aff[:, slot, :n], aff[:, slot + 1, :n] = resblock_kernel.finalize_affine(
            tot[:, 2 * p], tot[:, 2 * p + 1], T * n, gamma, beta)
    return aff


def finalize_kernel_phase(dev, call) -> float:
    """The finalize kernel against finalize_affine on seeded partials."""
    part, aff, T, pairs = _finalize_case(dev, call)
    resblock_kernel.launch_resblock_finalize(part, aff, T, pairs)
    torch.cuda.synchronize()
    ref = _finalize_plain(part, torch.zeros_like(aff), T, pairs)
    err = float((aff - ref).abs().max())
    rel = float(((aff - ref).abs() / ref.abs().clamp_min(1e-30)).max())
    log(f"[kernel] resblock_tgn_finalize {tuple(part.shape)}: max|err| {err:.3e}, relative {rel:.3e} (limit 2e-7)")
    if not torch.isfinite(aff).all() or rel > 2e-7:  # fp64 sums in another order, then one fp32 rounding
        raise RuntimeError("resblock_tgn_finalize disagrees with finalize_affine")
    return err


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


def freq_config(gr: int) -> dict:
    """FreqCodec mag_phase at the released gr8 / gr1 topology: a copy of
    scripts/bench_freqcodec.freq_config (tests/test_torch_freqcodec.py holds
    the two equal)."""
    return {
        "input_size": 3,
        "encoder": "encodec_seanet_encoder_2d",
        "encoder_conf": {
            "ratios": [[4, 1], [4, 1], [4, 2], [4, 1]],
            "norm": "time_group_norm", "causal": False, "dilation_base": 1,
            "conv_group_ratio": gr,
        },
        "quantizer": "costume_quantizer",
        "quantizer_conf": {
            "codebook_size": 1024, "num_quantizers": 32, "ema_decay": 0.99,
            "kmeans_init": False, "sampling_rate": 16000,
            "encoder_hop_length": 320, "use_ddp": True,
        },
        "decoder": "encodec_seanet_decoder_2d",
        "decoder_conf": {
            "ratios": [[4, 1], [4, 1], [4, 2], [4, 1]],
            "norm": "time_group_norm", "causal": False, "channels": 3,
            "dilation_base": 1, "conv_group_ratio": gr,
            "tr_conv_group_ratio": gr,
        },
        "model": "freq_codec",
        "model_conf": {
            "odim": 128,
            "target_sample_hz": 16000,
            "audio_normalize": True,
            "segment_dur": None, "overlap_ratio": None,
            "codec_domain": ["mag_phase", "mag_phase"],
        },
    }


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
            again = s_bf(requests[0], bit_width=None)
            if not (np.array_equal(again[0][0], outs[0][0][0]) and np.array_equal(again[2], outs[0][2])):
                raise RuntimeError("the main path served the same request twice with different results")
            log(f"[serve] {path}: the first request served again gives identical tokens and reconstruction")

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
# sync phase
# ---------------------------------------------------------------------------

SYNC_B, SYNC_SECONDS = 64, 5.825  # the benchmark's batch: 64 utterances at LibriTTS's mean length
SPAN_CLOCK_TOL_NS = 100_000  # a span's own stamps against the trace's event of the same name
SYNC_WARNING = "called a synchronizing CUDA operation"  # torch.cuda.set_sync_debug_mode("warn")'s


def sync_phase(dev, s_bf) -> dict:
    """One bf16 B = 64 x 5.825 s main-path request, int16 in and PCM16 out as
    the benchmark serves it, dispatched and collected under
    ``torch.cuda.set_sync_debug_mode("warn")`` with a profiler active: each
    synchronising call with the innermost program span it fell in (raises
    if one falls outside a span marked ``wait``); each span against the
    trace's ``funcodec::`` event of the same name (raises where a span is
    more than SPAN_CLOCK_TOL_NS outside its event or, in the median, that
    far from it: the spans and the trace must share a clock), and the
    trace's device copies of those ranges flagged as annotations (the
    benchmark counts no annotation as device work); each span's host, self
    and device ms."""
    import traceback
    import warnings

    from torch.profiler import ProfilerActivity

    from funcodec_tpu_torch.utils import profiling

    set_flags(MAIN_PATH)
    pcm = np.round(_speech(17, SYNC_B, SYNC_SECONDS) * 32767).astype(np.int16)
    ilens = [pcm.shape[1]] * SYNC_B

    def request():
        return s_bf.collect(s_bf.dispatch(pcm, bit_width=None, pcm16_ilens=ilens), need_sub_quants=False)

    for _ in range(2):  # cuDNN plans and allocations made before the checked request
        request()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("warm-up"):  # a process's first record_function is slow to enter
            pass
    torch.cuda.synchronize()
    syncs = []
    show = warnings.showwarning

    def noted(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return show(message, category, filename, lineno, file, line)
        s = profiling.current()
        stack = [f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in traceback.extract_stack(limit=8)[:-1]]
        syncs.append(dict(span=s and s.name, wait=bool(s and s.wait), at=f"{Path(filename).name}:{lineno}",
                          stack=stack))

    profiling.clear()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = noted
            torch.cuda.set_sync_debug_mode("warn")
            try:
                codes, _, recon, _ = request()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    frames = -(-pcm.shape[1] // 320)
    if codes[0].shape != (32, SYNC_B, frames) or recon.shape != pcm.shape or recon.dtype != np.int16:
        raise RuntimeError(f"sync: tokens {codes[0].shape}, recon {recon.shape} {recon.dtype}")
    got = profiling.spans()
    host_events, device_events = {}, []
    for ev in prof.profiler.kineto_results.events():
        if not ev.name().startswith(profiling.SPAN_PREFIX):
            continue
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            device_events.append(ev)
        else:
            host_events.setdefault(ev.name()[len(profiling.SPAN_PREFIX):], []).append(ev)
    offsets, out_of = [], 0
    for name in host_events:
        host_events[name].sort(key=lambda ev: ev.start_ns())
    for s in sorted(got, key=lambda s: s.t0_ns):
        ev = host_events[s.name].pop(0)
        t0, t1 = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        offsets += [(abs(s.t0_ns - t0), s.name), (abs(s.t1_ns - t1), s.name)]
        out_of = max(out_of, t0 - s.t0_ns, s.t1_ns - t1)  # the span's stamps are taken inside its event
    worst, worst_name = max(offsets)
    median = float(np.median([o for o, _ in offsets]))
    unflagged = [ev.name() for ev in device_events if not getattr(ev, "is_user_annotation", lambda: False)()]
    table = {}
    for s in got:
        row = table.setdefault(s.name, dict(n=0, host_ms=0.0, self_ms=0.0, device_ms=None, wait=s.wait))
        row["n"] += 1
        row["host_ms"] += s.host_ns * 1e-6
        row["self_ms"] += s.self_ns * 1e-6
        if s.events is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + s.device_ms()
    for name, row in table.items():
        log(f"[sync] span {name}: n {row['n']}, host {row['host_ms']:.3f} ms, self {row['self_ms']:.3f} ms, "
            f"device {row['device_ms'] if row['device_ms'] is None else round(row['device_ms'], 3)} ms"
            f"{' (wait)' if row['wait'] else ''}")
    for sync in syncs:
        log(f"[sync] synchronising call at {sync['at']} in span {sync['span']} (wait {sync['wait']})"
            + ("" if sync["wait"] else f"; stack {' <- '.join(reversed(sync['stack']))}"))
    log(f"[sync] {len(syncs)} synchronising calls in one request; spans' stamps {median / 1e3:.1f} us from the "
        f"trace's events in the median, {worst / 1e3:.1f} us at most ({worst_name}), {out_of / 1e3:.1f} us outside "
        f"them at most; {len(device_events)} device copies of the spans' ranges, {len(unflagged)} not flagged "
        f"as annotations")
    outside = [x for x in syncs if not x["wait"]]
    if outside:
        raise RuntimeError(f"sync: synchronising calls outside a wait span: {outside}")
    # a descheduled or collecting process widens a span's gap to its event, never reverses it
    if median > SPAN_CLOCK_TOL_NS or out_of > SPAN_CLOCK_TOL_NS:
        raise RuntimeError(f"sync: spans {median} ns off the trace's events of their names in the median; a span "
                           f"is {out_of} ns outside its event")
    if unflagged:
        raise RuntimeError(f"sync: device copies of the spans' ranges not flagged as annotations: {unflagged[:4]}")
    profiling.clear()
    return dict(syncs=syncs, clock_median_ns=median, clock_worst_ns=worst, clock_outside_ns=out_of,
                device_annotations=len(device_events), spans=table)


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
            outs["dma_copy 8 KB chunks"] = copy_kernel.dma_copy(x, 8192 // (128 * x.element_size()))
            outs["dma_copy 100 KB chunks (a ring of 2)"] = copy_kernel.dma_copy(x, 102_400 // (128 * x.element_size()))
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
DECODE_PER_BATCH = {"conv1d_s1": 2, "resblock_tgn": 12, "resblock_tgn_finalize": 8, "rvq_encode": 0}  # the decoder's half of EXPECT
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

    # the same run again in the warm process: the same bytes, and the spread of the host's wall time
    wall_again = _run_cli(CLI_DIR / "infer_again", scp, *bf16)
    if (CLI_DIR / "infer_again" / "codecs.txt").read_bytes() != (CLI_DIR / "infer" / "codecs.txt").read_bytes():
        raise RuntimeError("cli inference: a second run on the same corpus wrote other tokens")
    log(f"[cli] the same run again: {corpus_s / wall_again:.1f} audio-s/s ({wall_again:.3f} s), codecs.txt byte-equal")

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
    return dict(corpus_s=corpus_s, wall_s=wall, audio_s_per_s=corpus_s / wall, again_wall_s=wall_again,
                second_wall_s=wall_ark,
                second_audio_s_per_s=corpus_s / wall_ark, batches=n_batches, launches=counts,
                decode_wall_s=walls, fp32_agree=agree, fp32_byte_equal=same)


# ---------------------------------------------------------------------------
# training phase
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_SECONDS = 16, 2.56  # the yaml's batch_size and speech_max_length (40,960 samples)
TRAIN_STEPS = 4
# name: (shared_forward, compute dtype, FUSED_STRIDE1 and FUSED_RESBLOCK)
TRAIN_CONFIGS = {
    "fp32 train_step": (False, None, False),
    "fp32 shared_train_step": (True, None, False),
    "bf16 shared_train_step": (True, torch.bfloat16, False),
    "bf16 shared_train_step fused": (True, torch.bfloat16, True),
}
TRAIN_FUSED = "bf16 shared_train_step fused"
# launches of one shared step (or one generator turn) with both SEANet flags:
# the generator's encode and decode once, forward only (the backwards launch
# none; training searches codebooks with the plain fp32 scan, not rvq_encode)
TRAIN_EXPECT = {**EXPECT[MAIN_PATH], "rvq_encode": 0}
TRAIN_NONE = dict.fromkeys(TRAIN_EXPECT, 0)
GEN_PARAMS = 14_855_843  # the flagship's generator in both packages (tests/test_torch_encodec.py)
# the generator's gradients with both SEANet flags against without, relative L2
# over all of them. In fp32 the forwards agree to rounding, so a token flips only
# at a near-tie. In bf16 they round at other points: tokens flip, and the L1 of
# feature maps that nearly agree (real against fake) flips signs, so the bf16
# gradients move as far as bf16 moves them from fp32: held to 1.5 times that
# (two such noises add up to about sqrt(2) of one), and at least FUSED_GRAD_BF16_MIN
FUSED_GRAD_FP32_REL, FUSED_GRAD_BF16_FACTOR, FUSED_GRAD_BF16_MIN = 1e-2, 1.5, 0.05
# the fp32 step on the card against the CPU (TF32 off): losses, stats and gradient
# norms; the discriminator's gradient is the difference of its real and fake
# branches', which at init cancel to about 1/460 of either (CPU, fp32 against fp64:
# 3e-6), so rounding at 1e-5 of a branch is about 0.5% of it
CARD_CPU_REL, CARD_CPU_DISC_REL = 1e-3, 2e-2
# the fused backwards against autograd through their plain versions, relative to the
# largest gradient: fp32 summation order; bf16 the plain version's bf16 casts
BACKWARD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
NO_DRAWS = dict(kmeans_init=False, quantize_dropout=False, expiry_mode="reference")
STEADY = dict(kmeans_init=False)  # initialized codebooks; the recipe's dropout and expiry


def build_trainer(dev, shared: bool, dtype, seed: int = 0, group=None, optim: str = "adam", model_conf=None,
                  disc_conf=None, **quantizer):
    """The flagship generator and discriminator from the yaml (quantizer_conf
    overridden by `quantizer`, model_conf updated by `model_conf`, the
    discriminator_conf replaced by `disc_conf`), their
    optimizers (Adam, or `optim`) at optim_conf's and optim2_conf's rates, a
    train state and its step (over a data `group`, or one process)."""
    config = load_config(str(FLAGSHIP_YAML))
    config["quantizer_conf"].update(quantizer)
    config["model_conf"].update(model_conf or {})
    if disc_conf is not None:
        config["discriminator_conf"] = disc_conf
    model, disc = build_codec_model(config, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    opts = [make_optimizer(lr=c["lr"], betas=tuple(c["betas"]), name=optim)
            for c in (config["optim_conf"], config["optim2_conf"])]
    state = create_gan_train_state(model, disc, *opts)
    return state, make_gan_train_step(model, disc, *opts, shared_forward=shared, compute_dtype=dtype, group=group)


def _train_speech(dev, batch: int, seed: int = 40) -> torch.Tensor:
    return torch.from_numpy(_speech(seed, batch, TRAIN_SECONDS)).to(dev)


def _masters(state):
    return [[p.detach().clone() for p in m.parameters()] for m in (state.model, state.discriminator)]


def _floats(stats) -> dict:
    out = {k: float(v) for k, v in stats.items()}
    bad = [k for k, v in out.items() if not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"training: stats not finite: {bad}")
    return out


def _set_seanet_flags(fused: bool) -> None:
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = fused
    rvq.FUSED_RVQ = False


def training_phase(dev):
    """TRAIN_STEPS steps of each configuration on B = 16 x 2.56 s of noise,
    with the recipe's quantizer (k-means init, dropout, effective expiry).
    Returns (per-configuration results, the fused configuration's launches)."""
    speech = _train_speech(dev, TRAIN_B)
    results, fused_counts = {}, None
    options = load_config(str(FLAGSHIP_YAML))["quantizer_conf"]["rand_num_quant"]
    for name, (shared, dtype, fused) in TRAIN_CONFIGS.items():
        _set_seanet_flags(fused)
        state, step = build_trainer(dev, shared, dtype)
        n_params = sum(p.numel() for p in state.model.parameters())
        if n_params != GEN_PARAMS:
            raise RuntimeError(f"training {name}: {n_params} generator parameters, expected {GEN_PARAMS}")
        before_g, before_d = _masters(state)
        gen = torch.Generator(device=dev).manual_seed(7)
        torch.cuda.synchronize()
        reset_counts()
        per_step = []
        for i in range(TRAIN_STEPS):
            before = read_counts()
            state, stats = step(state, {"speech": speech}, gen)
            launched = {k: v - before[k] for k, v in read_counts().items()}
            if launched != (TRAIN_EXPECT if fused else TRAIN_NONE):
                raise RuntimeError(f"training {name} step {i}: launches {launched}")
            per_step.append(_floats(stats))
            if i == 0:
                # only the layers below the depth drawn for this step initialize
                inited = state.rvq_state.inited
                k = int(inited.sum())
                if k not in options or not bool(inited[:k].all()) or bool(inited[k:].any()):
                    raise RuntimeError(f"training {name}: after step 1 the initialized codebooks are "
                                       f"{inited.tolist()}, not a prefix of a depth in {options}")
                inited_after_1 = k
        torch.cuda.synchronize()
        counts = read_counts()
        if fused:
            fused_counts = counts
        after_g, after_d = _masters(state)
        moved = [any(not torch.equal(a, b) for a, b in zip(x, y)) for x, y in ((before_g, after_g), (before_d, after_d))]
        masters_fp32 = all(p.dtype == torch.float32 for m in (state.model, state.discriminator) for p in m.parameters())
        carry = float(state.gen_loss_carry)
        if state.step != TRAIN_STEPS or not all(moved) or not masters_fp32 or not carry > 0:
            raise RuntimeError(f"training {name}: step {state.step}, moved (generator, discriminator) {moved}, "
                               f"fp32 masters {masters_fp32}, gen_loss_carry {carry}")
        last = per_step[-1]
        log(f"[train] {name}: {TRAIN_STEPS} steps of B={TRAIN_B} x {TRAIN_SECONDS} s finite; codebooks initialized "
            f"after step 1: {inited_after_1}, after {TRAIN_STEPS}: {int(state.rvq_state.inited.sum())}; "
            f"generator_loss {last['generator_loss']:.4f}, multi-spectral {last['generator_multi_spectral_recon_loss']:.4f}, "
            f"discriminator_loss {last['discriminator_loss']:.4f}, grad norms g {last['generator_grad_norm']:.3f} "
            f"d {last['discriminator_grad_norm']:.3f}, carry {carry:.4f}, dead codes {last['rvq_dead_codes']:.0f}; "
            f"launches {counts}")
        results[name] = dict(stats=per_step, inited_after_1=inited_after_1, launches=counts)
        del state, step
        torch.cuda.empty_cache()
    _set_seanet_flags(False)
    return results, fused_counts


def _relative(a, b) -> float:
    """||a - b|| / ||b|| over lists of tensors."""
    return float(global_norm([x.float() - y.float() for x, y in zip(a, b)]) / global_norm(b))


def fused_grad_phase(dev):
    """The generator's gradients with both SEANet flags against without on
    one batch (no draws), in fp32 and in bf16; bf16 against fp32 as the
    yardstick of the bf16 comparison."""
    state, _ = build_trainer(dev, True, None, **NO_DRAWS)
    speech = _train_speech(dev, TRAIN_B, seed=41)
    names = [n for n, _ in state.model.named_parameters()]
    grads = {}
    for dtype in (None, torch.bfloat16):
        for fused in (False, True):
            _set_seanet_flags(fused)
            reset_counts()
            _, grads[dtype, fused] = generator_grads(state.model, state.discriminator, speech,
                                                     torch.Generator(device=dev).manual_seed(0), dtype)
            torch.cuda.synchronize()
            if read_counts() != (TRAIN_EXPECT if fused else TRAIN_NONE):
                raise RuntimeError(f"fused gradients {dtype} fused={fused}: launches {read_counts()} for one "
                                   "generator turn")
    _set_seanet_flags(False)
    out = dict(fp32=_relative(grads[None, True], grads[None, False]),
               bf16=_relative(grads[torch.bfloat16, True], grads[torch.bfloat16, False]),
               bf16_vs_fp32=_relative(grads[torch.bfloat16, False], grads[None, False]))
    out["bf16_limit"] = max(FUSED_GRAD_BF16_FACTOR * out["bf16_vs_fp32"], FUSED_GRAD_BF16_MIN)
    for mod in ("encoder", "quantizer", "decoder"):
        idx = [i for i, n in enumerate(names) if n.startswith(mod + ".")]
        if idx:
            for dtype, tag in ((None, "fp32"), (torch.bfloat16, "bf16")):
                out[f"{tag} {mod}"] = _relative([grads[dtype, True][i] for i in idx],
                                                [grads[dtype, False][i] for i in idx])
    log(f"[train] generator gradients, fused against unfused SEANet (B={TRAIN_B}, no draws), relative L2: fp32 "
        f"{out['fp32']:.3e} (limit {FUSED_GRAD_FP32_REL:.0e}), bf16 {out['bf16']:.3e} (limit {out['bf16_limit']:.3e}: "
        f"bf16 against fp32 unfused {out['bf16_vs_fp32']:.3e}); per module "
        + ", ".join(f"{k} {v:.3e}" for k, v in out.items() if " " in k))
    if not (out["fp32"] <= FUSED_GRAD_FP32_REL and out["bf16"] <= out["bf16_limit"]):
        raise RuntimeError("the fused SEANet path's generator gradients disagree with the unfused path's")
    return out


def _module_norms(model, disc, speech, gen):
    """Gradient norms of the generator turn per top-level module, and of the
    discriminator turn, fp32."""
    out, grads = generator_grads(model, disc, speech, gen)
    norms = {}
    for (name, _), g in zip(model.named_parameters(), grads):
        mod = name.split(".")[0]
        norms[mod] = norms.get(mod, 0.0) + float(g.double().square().sum())
    loss, _ = model.forward_discriminator(disc, speech, gen, torch.zeros((), device=speech.device))
    d = torch.autograd.grad(loss, list(disc.parameters()))
    norms["discriminator"] = float(global_norm(d)) ** 2
    return {k: v ** 0.5 for k, v in norms.items()}, out["stats"]


def card_cpu_phase(dev):
    """One fp32 two-forward step (no draws) at B = 2 x 2.56 s on the card and
    on the CPU from the same weights: stats and per-module gradient norms."""
    states = {"cuda": build_trainer(dev, False, None, **NO_DRAWS)}
    states["cpu"] = build_trainer(torch.device("cpu"), False, None, **NO_DRAWS)
    for m in ("model", "discriminator"):
        getattr(states["cpu"][0], m).load_state_dict(getattr(states["cuda"][0], m).state_dict())
    speech = _train_speech(torch.device("cpu"), 2, seed=42)
    got = {}
    for tag, (state, step) in states.items():
        x = speech.to(state.gen_loss_carry.device)
        t0 = time.perf_counter()
        norms, _ = _module_norms(state.model, state.discriminator, x, torch.Generator(device=x.device))
        _, stats = step(state, {"speech": x}, torch.Generator(device=x.device))
        got[tag] = (norms, _floats(stats), time.perf_counter() - t0)
    worst = {"generator": 0.0, "discriminator": 0.0}
    for key in list(got["cpu"][0]) + list(got["cpu"][1]):
        a = got["cuda"][0].get(key, got["cuda"][1].get(key))
        b = got["cpu"][0].get(key, got["cpu"][1].get(key))
        disc = key in ("discriminator", "discriminator_grad_norm")
        rel = abs(a - b) / max(abs(b), 1e-12) if abs(a - b) > 1e-7 else 0.0
        worst["discriminator" if disc else "generator"] = max(worst["discriminator" if disc else "generator"], rel)
        if rel > (CARD_CPU_DISC_REL if disc else CARD_CPU_REL):
            raise RuntimeError(f"fp32 step card vs CPU: {key} {a} against {b}")
    log(f"[train] fp32 step card vs CPU (B=2 x {TRAIN_SECONDS} s, no draws): losses, stats and generator gradient "
        f"norms agree within {worst['generator']:.3e} relative (limit {CARD_CPU_REL}), the discriminator's gradient "
        f"norms within {worst['discriminator']:.3e} (limit {CARD_CPU_DISC_REL}); norms card {got['cuda'][0]}, "
        f"CPU {got['cpu'][0]}; the CPU took {got['cpu'][2]:.1f} s")
    return dict(worst_relative=worst, card=got["cuda"][:2], cpu=got["cpu"][:2])


def _training_calls(model, dtype, dev):
    """The fused kernels' calls of one training forward at B = 16 x 2.56 s:
    the four head convs and the eight residual blocks (encoder and decoder)."""
    enc, dec = model.encoder.model, model.decoder.model
    T = int(TRAIN_SECONDS * SR)
    heads = [
        ConvLayer("enc_first 1->32 k7", enc[0], TRAIN_B, T, None, dtype, dev, 80),
        ConvLayer("enc_last elu 512->128 k7", enc[len(enc) - 1], TRAIN_B, T // 320, "elu", dtype, dev, 81),
        ConvLayer("dec_first 128->512 k7", dec[0], TRAIN_B, T // 320, None, dtype, dev, 82),
        ConvLayer("dec_last elu 32->1 k7", dec[len(dec) - 1], TRAIN_B, T, "elu", dtype, dev, 83),
    ]
    Ts = [T, T // 2, T // 8, T // 40]
    blocks = [(f"enc C={b.block[1].spec.in_channels} T={t} d={b.block[1].spec.dilation}", b, t)
              for b, t in zip(_blocks(model.encoder), Ts)]
    blocks += [(f"dec C={b.block[1].spec.in_channels} T={t} d={b.block[1].spec.dilation}", b, t)
               for b, t in zip(_blocks(model.decoder), Ts[::-1])]
    return heads, [ResblockCall(n, b, TRAIN_B, t, dtype, dev, 90 + i) for i, (n, b, t) in enumerate(blocks)]


def _grad_inputs(call, dtype):
    """(inputs that take a gradient, forward through the kernel, forward through the plain version)."""
    if isinstance(call, ConvLayer):
        x = call.x.detach().requires_grad_()
        w, b = call.w.detach().to(dtype).requires_grad_(), call.b.detach().requires_grad_()
        s = call.spec
        args = (call.left, call.right, s.dilation, s.pad_mode, call.act)
        return ([x, w, b], lambda: conv_kernel.fused_conv1d_s1(x, w, b, *args),
                lambda: conv_kernel.fused_conv1d_s1_reference(x, w, b, *args))
    x = call.x.detach().requires_grad_()
    params = [p for m in call.convs for p in m.parameters()]
    return ([x, *params], lambda: resblock_kernel.fused_resblock_tgn(x, *call.convs),
            lambda: resblock_kernel.fused_resblock_tgn_reference(x, *call.convs))


def _backward_bound(call) -> tuple:
    """The least time of a backward: bytes of g and x read and dx written
    (weights aside), and the operations the gradient needs with the forward's
    activations kept (dx and dw: twice the forward's MACs, 2 FLOP each) at
    the peak for the input's type. The port's backwards compute in fp32 and
    the resblock's replays its forward; the bound counts neither."""
    e = call.x.element_size()
    peak = PEAK_BF16 if e == 2 else PEAK_FP32
    if isinstance(call, ConvLayer):
        B, Cin, T = call.x.shape
        Cout, _, K = call.w.shape
        return _bound((B * Cout * T + 2 * B * Cin * T) * e, 4.0 * B * Cout * T * Cin * K, peak)
    B, C, T = call.x.shape
    H, K = call.convs[0].spec.out_channels, call.convs[0].spec.kernel_size
    macs = H * K * C + C * H + C * C
    return _bound(3 * B * C * T * e, 4.0 * B * T * macs, peak)


def backward_phase(dev, card: str):
    """Each fused kernel's forward against its plain version, and its backward
    against autograd through the plain version, at every flagship training
    shape, in fp32 and bf16; then the backward timed (bf16) against the plain
    version's. Returns the timing rows, the backwards' worst relative errors
    (bf16) and the forwards' worst absolute errors (both types)."""
    state, _ = build_trainer(dev, True, torch.bfloat16, **STEADY)
    model = state.model
    rows = {"conv1d_s1": [], "resblock_tgn": []}
    worst = {"conv1d_s1": 0.0, "resblock_tgn": 0.0}
    forward = {"conv1d_s1": 0.0, "resblock_tgn": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        heads, blocks = _training_calls(model, dtype, dev)
        for call in heads + blocks:
            kernel = "conv1d_s1" if isinstance(call, ConvLayer) else "resblock_tgn"
            inputs, fused, plain = _grad_inputs(call, dtype)
            y, y_ref = fused(), plain()
            forward[kernel] = max(forward[kernel], _held(kernel, f"{call.name} B={TRAIN_B} (training)",
                                                         y.detach(), y_ref.detach()))
            cot = torch.randn(y.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
            got = torch.autograd.grad(y, inputs, cot.to(y.dtype), retain_graph=True)
            want = torch.autograd.grad(y_ref, inputs, cot.to(y_ref.dtype), retain_graph=True)
            torch.cuda.synchronize()
            errs = []
            for g, r in zip(got, want):
                scale = float(r.float().abs().max())
                errs.append(float((g.float() - r.float()).abs().max()) / max(scale, 1e-30))
            err = max(errs)
            log(f"[backward] {kernel} {call.name} B={TRAIN_B} {str(dtype)[6:]}: max relative error of "
                f"{len(got)} gradients {err:.3e} (limit {BACKWARD_REL[dtype]:.0e})")
            if not all(torch.isfinite(g).all() for g in got) or err > BACKWARD_REL[dtype]:
                raise RuntimeError(f"{kernel} {call.name}: the backward disagrees with autograd of the plain version")
            if dtype == torch.bfloat16:
                worst[kernel] = max(worst[kernel], err)
                ms = _cuda_ms(lambda: torch.autograd.grad(y, inputs, cot.to(y.dtype), retain_graph=True), 5)
                plain_ms = _cuda_ms(lambda: torch.autograd.grad(y_ref, inputs, cot.to(y_ref.dtype),
                                                                retain_graph=True), 3)
                row = _row(call.name, ms, plain_ms, _backward_bound(call), library_ms=None)
                rows[kernel].append(row)
                log(f"[time] {kernel} backward {call.name} B={TRAIN_B} bf16: {ms:.3f} ms, autograd of the plain "
                    f"version {plain_ms:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}) ({card})")
            del y, y_ref, got, want
        torch.cuda.empty_cache()
    return rows, worst, forward


def training_timing(dev, card: str):
    """ms a step, training audio-s/s (B x 2.56 s over the step time) and peak
    memory, best of 3 steps after a warm-up step, in the steady state
    (codebooks initialized; the recipe's dropout and effective expiry)."""
    rows = []
    runs = [(name, cfg, TRAIN_B) for name, cfg in TRAIN_CONFIGS.items()]
    runs += [("bf16 shared_train_step", TRAIN_CONFIGS["bf16 shared_train_step"], 64),
             (TRAIN_FUSED, TRAIN_CONFIGS[TRAIN_FUSED], 64)]
    for name, (shared, dtype, fused), B in runs:
        _set_seanet_flags(fused)
        state, step = build_trainer(dev, shared, dtype, **STEADY)
        batch = {"speech": _train_speech(dev, B, seed=43)}
        gen = torch.Generator(device=dev).manual_seed(8)
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            state, stats = step(state, batch, gen)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        _floats(stats)
        peak = torch.cuda.max_memory_allocated() / 2**30
        row = dict(name=name, batch=B, ms=best * 1e3, audio_s_per_s=B * TRAIN_SECONDS / best, peak_gib=peak)
        rows.append(row)
        log(f"[time] training {name} B={B} x {TRAIN_SECONDS} s: {row['ms']:.1f} ms/step, "
            f"{row['audio_s_per_s']:.1f} audio-s/s, peak memory {peak:.2f} GiB ({card})")
        del state, step, batch
        torch.cuda.empty_cache()
    _set_seanet_flags(False)
    return rows


# ---------------------------------------------------------------------------
# trainer phase
# ---------------------------------------------------------------------------

TRAINER_DIR = OUT_DIR / "train"
# the train split pads (< 2.56 s) and crops (> 2.56 s) to speech_max_length; the
# valid split is all shorter than it, so validation draws nothing on the host
TRAINER_UTTS, TRAINER_SECONDS = 40, (1.5, 6.0)
VALID_UTTS, VALID_SECONDS = 8, (1.5, 2.5)
TRAINER_CONF = dict(batch_size=16, num_iters_per_epoch=4, max_epoch=2, keep_nbest_models=1, num_valid_dump_wavs=2,
                    num_workers=4, log_interval=4, use_tensorboard=False)
SERVE_UTTS = 4
# fused against unfused validation on the same weights (fp32 masters, the fp32
# RVQ scan in both): the resblock kernel's fp32 tolerance, of each stat's scale
# (at least 1: the quality metrics in dB may sit near 0). The two encoders' latents
# agree to rounding, which flips an RVQ code now and then at a near-tie, and one flip
# can move a stat (si_snr_db) by more than the limit. So the unfused validation
# quantizes with the fused one's codes, and a code of its own scan may differ only at
# a near-tie: the two codewords' distances to the residual within VALID_REL of its
# squared norm, at the frame's first differing stage
VALID_REL = FP32_REL_TOL["resblock_tgn"]
VALID_UPDATES = 4


def _trainer_corpus(d: Path, n: int, seconds, seed: int, sr: int = SR) -> dict:
    """Seeded sine mixtures plus noise as PCM16 wavs at `sr` and their wav.scp: {key: samples}."""
    d.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    lengths = {}
    with open(d / "wav.scp", "w") as scp:
        for i, sec in enumerate(rs.uniform(*seconds, n)):
            key, m = f"utt{i:03d}", int(round(sec * sr))
            t = np.arange(m) / sr
            w = sum(a * np.sin(2 * np.pi * f * t + ph) for a, f, ph in
                    zip(rs.uniform(0.05, 0.2, 3), rs.uniform(80, 4000, 3), rs.uniform(0, 2 * np.pi, 3)))
            write_wav(d / f"{key}.wav", (w + 0.02 * rs.randn(m)).astype(np.float32), sr)
            scp.write(f"{key} {d / f'{key}.wav'}\n")
            lengths[key] = m
    return lengths


def _train_cli(dev, config: Path, out: Path, *extra) -> list:
    return ["--config", str(config), "--output_dir", str(out), "--train_wav_scp",
            str(TRAINER_DIR / "train" / "wav.scp"), "--valid_wav_scp", str(TRAINER_DIR / "valid" / "wav.scp"),
            "--train_dtype", "bfloat16", "--device", str(dev), *extra]


def _expected(steps: int, valid_batches: int) -> dict:
    """Launches of `steps` fused training steps and `valid_batches` validation forwards (one encode + decode each)."""
    return {k: steps * TRAIN_EXPECT[k] + valid_batches * EXPECT[MAIN_PATH][k] for k in TRAIN_EXPECT}


def _same_tree(a, b, path="") -> None:
    """Raise unless two checkpoint trees hold the same structure, ints and tensors bit for bit."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise RuntimeError(f"trainer resume: keys differ at {path}")
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise RuntimeError(f"trainer resume: lengths differ at {path}")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a.cpu(), b.cpu()):
            raise RuntimeError(f"trainer resume: tensor {path} differs from checkpoint.pth")
    elif a != b:
        raise RuntimeError(f"trainer resume: {path} is {a}, checkpoint.pth holds {b}")


def _check_run(out: Path, epochs: int, what: str, best_link: bool = True) -> dict:
    """The checkpoint contract's artifacts and a finite reporter.json; returns its stats.
    A run resumed in another directory holds the best link only if its own epoch was the best."""
    best = out / "valid.generator_multi_spectral_recon_loss.best.pth"
    missing = [n for n in ("checkpoint.pth", f"{epochs}epoch.pth", "config.yaml", "reporter.json")
               if not (out / n).exists()]
    if missing or not (out / "latest.pth").is_symlink() or (best_link and not (best.is_symlink() and best.exists())):
        raise RuntimeError(f"trainer {what}: missing artifacts {missing} or links in {sorted(os.listdir(out))}")
    if len(list(out.glob("*epoch.pth"))) > 2 or len(list((out / "valid_wavs").rglob("*.wav"))) < 2:
        raise RuntimeError(f"trainer {what}: n-best pruning or validation dumps wrong: {sorted(os.listdir(out))}")
    stats = json.loads((out / "reporter.json").read_text())["stats"]
    bad = [(e, ph, k) for e, phases in stats.items() for ph, kv in phases.items() for k, v in kv.items()
           if not math.isfinite(v)]
    if bad or set(stats) != {str(e) for e in range(1, epochs + 1)}:
        raise RuntimeError(f"trainer {what}: epochs {sorted(stats)}, stats not finite: {bad[:5]}")
    return stats


def _prepared_is_current(embed: torch.Tensor) -> bool:
    """rvq_encode's cached view of the codebooks holds their current values."""
    hit = rvq_kernel._PREPARED.get(id(embed))
    return hit is not None and torch.equal(hit[2]["embed"], embed.to(torch.bfloat16))


def _stale_packs(model) -> list:
    """The fused kernels' cached packs that differ from a fresh pack of the current weights."""
    stale = []
    for name, p in model.named_parameters():
        cached = getattr(p, "_conv1d_s1_pack", None)
        if cached is not None:
            (dtype, chunk, *_), pack = cached
            fresh = conv_kernel.pack_weight(p, dtype, chunk)
            bias = pack["bias_ref"]
            if not torch.equal(pack["w"], fresh) or (bias is not None and not torch.equal(pack["bias"], bias.float())):
                stale.append(name)
    for mod_name, block in model.named_modules():
        if isinstance(block, SEANetResnetBlock) and hasattr(block.block[1], "_resblock_pack"):
            (dtype, _), pack, _ = block.block[1]._resblock_pack
            del block.block[1]._resblock_pack
            fresh = resblock_kernel.packed_weights(block.block[1], block.block[3], block.shortcut, dtype)
            if any(not torch.equal(pack[k], fresh[k]) for k in fresh):
                stale.append(mod_name)
    return stale


@contextlib.contextmanager
def _rvq_calls(forced=None):
    """Record each eval quantize inside the block (models/quantizer.py calls
    rvq_inference by name): [(input (B, T, D) fp32, codes (n_q, B, T), embed)].
    With `forced`, the i-th call returns the codewords of forced[i]'s codes
    in place of its own."""
    import funcodec_tpu_torch.models.quantizer as quantizer_mod

    calls, inner = [], quantizer_mod.rvq_inference

    def wrapper(cfg, state, x, n_q=None):
        out = inner(cfg, state, x, n_q)
        calls.append((x.float().clone(), out[1].clone(), state.embed))
        if forced is None:
            return out
        codes = forced[len(calls) - 1][1]
        subq = rvq.gather_codewords(state.embed, codes)
        return subq.sum(dim=0).to(x.dtype), codes, subq.to(x.dtype)

    quantizer_mod.rvq_inference = wrapper
    try:
        yield calls
    finally:
        quantizer_mod.rvq_inference = inner


def _code_flips(calls_a, calls_b):
    """(codes that differ, codes, the largest distance gap): at each frame's
    first differing stage, |d(r, e_a) - d(r, e_b)| / |r|^2 in fp64, r the
    residual of b's input after the stages before it (where a and b agree)."""
    flips, gap = 0, 0.0
    for (_, a, embed), (x, b, _) in zip(calls_a, calls_b):
        n_q = a.shape[0]
        a, b = a.reshape(n_q, -1), b.reshape(n_q, -1)
        differ = a != b
        flips += int(differ.sum())
        for j in differ.any(dim=0).nonzero().flatten().tolist():
            s = int(differ[:, j].int().argmax())
            r = x.reshape(-1, x.shape[-1])[j].double()
            for q in range(s):
                r = r - embed[q, b[q, j]].double()
            d = [float(((r - embed[s, c[s, j]].double()) ** 2).sum()) for c in (a, b)]
            gap = max(gap, abs(d[0] - d[1]) / max(float((r * r).sum()), 1e-30))
    return flips, sum(c[1].numel() for c in calls_b), gap


def _back_to_back_rate(trainer, state, dev, B: int, steps: int) -> float:
    """Training audio-s/s of `steps` of the trainer's own step, back to back
    on one resident batch (no loader, no stats fetch), fenced once: the loop
    without its host work, in the same process state as the loop."""
    batch = {"speech": _train_speech(dev, B, seed=45)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = trainer._train_step(state, batch, step_generator(dev, 0, state.step))
    torch.cuda.synchronize()
    return steps * B * TRAIN_SECONDS / (time.perf_counter() - t0)


def trainer_phase(dev, card: str, train_rows):
    """cli/codec_train on the flagship (bf16, the three kernels on), resumed,
    its validation fused against unfused after in-place updates, one
    epoch from the device cache, and its weights served; returns its numbers."""
    import yaml

    from funcodec_tpu_torch.cli import codec_train
    from funcodec_tpu_torch.data.dataset import collate_fn
    from funcodec_tpu_torch.data.device_cache import DeviceCachedCrops
    from funcodec_tpu_torch.data.loader import PrefetchLoader
    from funcodec_tpu_torch.data.sampler import shuffle_batches_for_epoch, unsorted_batches
    from funcodec_tpu_torch.train.checkpoint import train_state_dict

    t_phase = time.perf_counter()
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    lengths = _trainer_corpus(TRAINER_DIR / "train", TRAINER_UTTS, TRAINER_SECONDS, seed=30)
    _trainer_corpus(TRAINER_DIR / "valid", VALID_UTTS, VALID_SECONDS, seed=31)
    config = load_config(str(FLAGSHIP_YAML))
    config.update(TRAINER_CONF)
    conf = TRAINER_DIR / "config.yaml"
    conf.write_text(yaml.safe_dump(config))
    crop = config["speech_max_length"]
    n_pad = sum(n <= crop for n in lengths.values())
    if not 0 < n_pad < len(lengths):
        raise RuntimeError(f"trainer corpus: {n_pad} of {len(lengths)} utterances padded; both pad and crop must occur")
    iters, epochs = config["num_iters_per_epoch"], config["max_epoch"]
    v_batches = -(-VALID_UTTS // config["batch_size"])

    # 1. two epochs, bf16, the three kernels on
    exp = TRAINER_DIR / "exp"
    set_flags(MAIN_PATH)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer, state = codec_train.main(_train_cli(dev, conf, exp))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, expect = read_counts(), _expected(epochs * iters, epochs * v_batches)
    if counts != expect:
        raise RuntimeError(f"trainer: launches {counts}, expected {expect} ({epochs * iters} steps, "
                           f"{epochs * v_batches} validation batches)")
    stats = _check_run(exp, epochs, "run")
    walls = trainer.epoch_walls
    steady = walls[epochs]
    host_rate = steady["train_audio_s"] / steady["train_s"]
    log(f"[trainer] codec_train bf16 B={config['batch_size']}, {epochs} epochs x {iters} steps, {VALID_UTTS} valid "
        f"utterances: {wall:.2f} s (model build included); launches {counts} = {epochs * iters} steps x "
        f"{TRAIN_EXPECT} + {epochs * v_batches} validation batches x {EXPECT[MAIN_PATH]}; every stat finite; "
        f"epoch {epochs} valid multi-spectral {stats[str(epochs)]['valid']['generator_multi_spectral_recon_loss']:.4f}, "
        f"stoi {stats[str(epochs)]['valid']['stoi']:.4f}")
    back_to_back = _back_to_back_rate(trainer, state, dev, config["batch_size"], iters)
    del trainer, state

    # 2. resume to a third epoch: the loaded state is checkpoint.pth bit for bit
    saved = torch.load(exp / "checkpoint.pth", map_location="cpu", weights_only=True)
    trainer, state = codec_train.main(_train_cli(dev, conf, exp, "--max_epoch", "3", "--dry_run"))
    state, start = trainer.resume(state)
    _same_tree(train_state_dict(state), saved)
    if start != epochs + 1 or state.step != epochs * iters:
        raise RuntimeError(f"trainer resume: start epoch {start}, step {state.step}")
    del trainer, state, saved
    set_flags(MAIN_PATH)
    reset_counts()
    trainer, state = codec_train.main(_train_cli(dev, conf, exp, "--max_epoch", "3"))
    torch.cuda.synchronize()
    if read_counts() != _expected(iters, v_batches):
        raise RuntimeError(f"trainer resume: launches {read_counts()}, expected {_expected(iters, v_batches)}")
    resumed = _check_run(exp, 3, "resume")
    if state.step != 3 * iters or any(resumed[e] != stats[e] for e in stats):
        raise RuntimeError(f"trainer resume: step {state.step}, or the stats of epochs 1-{epochs} changed")
    if not _prepared_is_current(state.model.quantizer.state.embed):
        raise RuntimeError("trainer: rvq_encode's prepared codebooks are not those the last step committed")
    log(f"[trainer] resume: the loaded state equals checkpoint.pth bit for bit; step {state.step}, epochs 1-{epochs} "
        f"unchanged in reporter.json, epoch 3 trained and validated")

    # 3. stale packs: fused against unfused validation after each of a few more in-place updates
    args = codec_train.get_parser().parse_args(_train_cli(dev, conf, exp))
    train_ds, valid_ds = codec_train.build_datasets(args, config)

    def v_loader():
        return PrefetchLoader(valid_ds, unsorted_batches(valid_ds.uttids, config["batch_size"], drop_last=False),
                              collate_fn, num_workers=2)

    _set_seanet_flags(True)
    fused = trainer.validate(state, v_loader(), 100, 0)
    worst = latent = gap = 0.0
    flips = n_codes = 0
    for u in range(VALID_UPDATES):
        before = fused
        _set_seanet_flags(True)
        state, _ = trainer._train_step(state, {"speech": _train_speech(dev, config["batch_size"], seed=44 + u)},
                                       step_generator(dev, 0, state.step))
        t0 = time.perf_counter()
        with _rvq_calls() as fused_rvq:
            fused = trainer.validate(state, v_loader(), 101, 0)
        torch.cuda.synchronize()
        if u == 0:
            valid_wall = time.perf_counter() - t0
        stale = _stale_packs(state.model)
        _set_seanet_flags(False)
        with _rvq_calls(forced=fused_rvq) as unfused_rvq:
            unfused = trainer.validate(state, v_loader(), 102, 0)
        worst = max(worst, *(abs(fused[k] - unfused[k]) / max(abs(unfused[k]), 1.0) for k in unfused))
        latent = max(latent, *(_rel(f[0].cpu().numpy(), v[0].cpu().numpy()) for f, v in zip(fused_rvq, unfused_rvq)))
        n_flips, n, g = _code_flips(fused_rvq, unfused_rvq)
        flips, n_codes, gap = flips + n_flips, n_codes + n, max(gap, g)
        moved = before["generator_multi_spectral_recon_loss"] != fused["generator_multi_spectral_recon_loss"]
        if stale or not moved:
            raise RuntimeError(f"trainer: after in-place update {u + 1}, stale packs {stale}, or the stats did not move")
    log(f"[trainer] validation after each of {VALID_UPDATES} in-place updates, fused SEANet kernels against unfused "
        f"(fp32 masters, fp32 RVQ scan, the unfused one on the fused one's codes): worst of {len(unfused)} stats "
        f"{worst:.3e} of its scale, RVQ input {latent:.3e} relative L2; {flips} of {n_codes} codes of the unfused scan "
        f"differ, the largest distance gap at a first differing stage {gap:.3e} of the residual's squared norm (each "
        f"limit {VALID_REL:.0e}); no stale packs; every update moved the stats")
    if max(worst, latent, gap) > VALID_REL:
        raise RuntimeError("trainer: the fused validation disagrees with the unfused one")
    del trainer, state
    torch.cuda.empty_cache()

    # 4. one epoch from the device cache, stats every 2nd step, resumed from the run above
    cache_conf = TRAINER_DIR / "config_cache.yaml"
    cache_conf.write_text(yaml.safe_dump(dict(config, device_cache=True, stats_interval=2)))
    exp_cache = TRAINER_DIR / "exp_cache"
    exp_cache.mkdir()
    for name in ("checkpoint.pth", "reporter.json"):
        shutil.copy(exp / name, exp_cache / name)
    set_flags(MAIN_PATH)
    reset_counts()
    trainer, state = codec_train.main(_train_cli(dev, cache_conf, exp_cache, "--max_epoch", "4"))
    torch.cuda.synchronize()
    if read_counts() != _expected(iters, v_batches) or state.step != 4 * iters:
        raise RuntimeError(f"trainer device cache: launches {read_counts()}, step {state.step}")
    _check_run(exp_cache, 4, "device cache", best_link=False)
    cache_walls = trainer.epoch_walls[4]
    cache_rate = cache_walls["train_audio_s"] / cache_walls["train_s"]
    ids = list(train_ds.uttids)
    cache = DeviceCachedCrops(train_ds, ids, crop, seed=config["seed"], device=dev)
    batches = shuffle_batches_for_epoch(unsorted_batches(ids, config["batch_size"], True), config["seed"], 4)
    batches = (batches * -(-iters // len(batches)))[:iters]
    host = {u: np.asarray(train_ds.raw_item(u)[1]["speech"], np.float32) for u in ids}
    for (keys, batch), (idx, off) in zip(cache.epoch_loader(batches, 4), cache.epoch_offsets(batches, 4)):
        want = np.stack([np.pad(host[u], (0, max(0, o + crop - len(host[u]))))[o: o + crop]
                         for u, o in zip(keys, off)])
        if not np.array_equal(batch["speech"].cpu().numpy(), want):
            raise RuntimeError("trainer device cache: the card's crops differ from the host gather of the offsets")
    log(f"[trainer] device cache + stats_interval 2: 1 epoch x {iters} steps resumed at epoch 4, launches exact, "
        f"{cache.nbytes() / 1e6:.1f} MB staged (padding overhead {cache.padding_overhead:.2f}x); its crops equal the "
        f"host gather of the same offsets")
    del trainer, state, cache
    torch.cuda.empty_cache()

    # 5. the trained weights served through the inference CLI (bf16 main path)
    serve = TRAINER_DIR / "serve"
    keys = sorted(lengths)[:SERVE_UTTS]
    (TRAINER_DIR / "serve.scp").write_text("".join(f"{k} {TRAINER_DIR / 'train' / f'{k}.wav'}\n" for k in keys))
    set_flags(MAIN_PATH)
    reset_counts()
    cli.main(["--config_file", str(exp / "config.yaml"), "--model_file", str(exp / "latest.pth"), "--output_dir",
              str(serve), "--data_path_and_name_and_type", f"{TRAINER_DIR / 'serve.scp'},speech,sound", "--dtype",
              "bfloat16", "--batch_size", str(SERVE_UTTS), "--bit_width", str(CLI_BIT_WIDTH), "--device", str(dev)])
    if read_counts() != EXPECT[MAIN_PATH]:
        raise RuntimeError(f"trainer serve: launches {read_counts()} for one batch")
    codes = _codecs(serve / "codecs.txt")
    s2t = Speech2Token(str(exp / "config.yaml"), str(exp / "latest.pth"), "bfloat16", SR, CLI_BIT_WIDTH, device=dev)
    order = sorted(keys, key=lambda k: lengths[k])
    wavs = [read_wav(TRAINER_DIR / "train" / f"{k}.wav", normalize=False)[1] for k in order]
    batch = cli._wrap_pad(wavs, cli._bucket_length(max(len(w) for w in wavs), s2t.hop_length))
    direct = s2t.collect(s2t.dispatch(batch, pcm16_ilens=[len(w) for w in wavs]))[0][0]
    for i, key in enumerate(order):
        if not np.array_equal(direct[:, i, : codes[key].shape[1]], codes[key]):
            raise RuntimeError(f"trainer serve: {key}'s tokens differ from a direct Speech2Token.dispatch")
    inited = s2t.model.quantizer.state.inited
    if not bool(inited.all()):
        raise RuntimeError(f"trainer serve: codebooks initialized {inited.tolist()}")
    del s2t
    log(f"[trainer] latest.pth served by cli/codec_inference (bf16, the three kernels): {SERVE_UTTS} utterances, "
        f"tokens equal a direct Speech2Token.dispatch; all {inited.numel()} codebooks initialized")

    # 6. the loop's numbers beside the bare step's
    bare = next(r for r in train_rows if r["name"] == TRAIN_FUSED and r["batch"] == config["batch_size"])
    out = dict(launches=counts, wall_s=wall, epochs={str(e): w for e, w in walls.items()},
               host_loader_audio_s_per_s=host_rate, device_cache_audio_s_per_s=cache_rate,
               bare_step_audio_s_per_s=bare["audio_s_per_s"], host_loader_ratio=host_rate / bare["audio_s_per_s"],
               device_cache_ratio=cache_rate / bare["audio_s_per_s"], checkpoint_s=steady["checkpoint_s"],
               checkpoint_bytes=steady["checkpoint_bytes"], valid_s=steady["valid_s"],
               valid_fused_s=valid_wall, valid_worst_relative=worst, valid_rvq_input_relative=latent,
               valid_code_flips=flips, valid_codes=n_codes, valid_flip_gap=gap, back_to_back_audio_s_per_s=back_to_back,
               phase_s=time.perf_counter() - t_phase)
    log(f"[time] trainer loop, bf16 + the SEANet kernels, B={config['batch_size']} x {crop / SR} s, steady epoch "
        f"({iters} steps): host loader {host_rate:.1f} audio-s/s ({steady['train_s']:.3f} s), device cache + "
        f"stats_interval 2 {cache_rate:.1f} audio-s/s ({cache_walls['train_s']:.3f} s); the bare step "
        f"{bare['audio_s_per_s']:.1f} audio-s/s (ratio {out['host_loader_ratio']:.3f} / {out['device_cache_ratio']:.3f}), "
        f"the trainer's step back to back after the run {back_to_back:.1f} audio-s/s (ratio "
        f"{host_rate / back_to_back:.3f} / {cache_rate / back_to_back:.3f}); "
        f"checkpoint.pth write {steady['checkpoint_s']:.3f} s for {steady['checkpoint_bytes'] / 2**20:.1f} MiB; "
        f"validation {steady['valid_s']:.3f} s ({VALID_UTTS} utterances, 2 dumps scored); phase "
        f"{out['phase_s']:.1f} s ({card})")
    _set_seanet_flags(False)
    return out


# ---------------------------------------------------------------------------
# tts phase
# ---------------------------------------------------------------------------

TTS_YAML = REPO / "egs/LibriTTS/text2speech_laura/conf/text2audio_codec_lm_nq2_uni_rel_pos.yaml"
TTS_DIR = OUT_DIR / "tts"
TTS_VOCAB = 256  # a seeded word list: token-id text inputs (the repo holds no T5 embeddings)
TTS_PARAMS = 88_669_186  # the shipped yaml with the 256-word list, both packages (tests/test_torch_laura.py)
# card against CPU (fp32, TF32 off), and one decode layout against another: logits
# differ by summation order only, expected at about 1e-5 of their O(1) scale
TTS_LOGIT_TOL = 1e-3
TTS_FORCED = 32  # teacher-forced decode steps
TTS_GREEDY = 48  # groups each request of the decode-mode check generates
# one zero-shot request: the prompt's encode, then decode (AR tokens) and decode_emb (non-AR embeddings)
TTS_EXPECT = {k: EXPECT[MAIN_PATH][k] + DECODE_PER_BATCH[k] for k in EXPECT[MAIN_PATH]}
TTS_CLI_SECONDS = 2  # the CLI config's audio_max_duration: 50 groups a request (random weights never emit eos)
# scripts/bench_tts_serving.py's workload: text length 40, caps uniform over 50..250 groups, 16 slots
TTS_BENCH = dict(requests=48, text=40, caps=(50, 100, 150, 200, 250), slots=16, segment=25, single=250)
TTS_REPS_OTHER = 1  # timed runs of the lockstep and batch-1 rows after their warm-up (the session's: best of 3)


def _tts_text(rs, n: int) -> np.ndarray:
    return rs.randint(0, TTS_VOCAB, n).astype(np.int64)


def _prompt_tokens(codec, rs, seconds: float, nq: int) -> np.ndarray:
    """(P, nq) codec tokens of seeded noise (the zero-shot prompt's encode)."""
    wav = (0.1 * rs.randn(int(seconds * SR))).astype(np.float32)
    token_id, *_ = codec(wav[None], need_recon=False, run_mod="encode", bit_width=None)
    return np.asarray(token_id[0])[:nq, 0, :].T.astype(np.int64)


def build_tts(dev, codec):
    """The shipped LauraTTS yaml at full width with seeded weights, a seeded
    256-word list, the codec's codebooks grafted into quantizer_codebook."""
    import yaml

    from funcodec_tpu_torch.tasks.text2audio import build_laura_model

    config = yaml.safe_load(TTS_YAML.read_text())
    tokens = [f"w{i:03d}" for i in range(TTS_VOCAB)]
    model = build_laura_model(config, token_list=tokens, device=dev)
    with torch.no_grad():
        model.quantizer_codebook.embed.copy_(codec.model.quantizer.state.embed)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != TTS_PARAMS:
        raise RuntimeError(f"LauraTTS parameters {n_params}, expected {TTS_PARAMS}")
    return config, tokens, model


def _forced_b1(model, ids, prompt, forced) -> torch.Tensor:
    """The prefill logits and len(forced) teacher-forced step logits of one
    request in the batch-1 layout: (1 + S, nq * V)."""
    dev = model.device
    cont = None if prompt is None else prompt[None]
    emb, shift = model.batch_prefix(ids[None], np.array([len(ids)]), cont, None if cont is None else [len(prompt)])
    logits, cache, attend, rel = model.prefill(emb, shift, len(forced))
    out = [logits]
    f = torch.as_tensor(forced, device=dev)
    plen = torch.tensor([0 if prompt is None else len(prompt)], device=dev)
    for i in range(len(forced)):
        logits, cache = model.lm_step(cache, f[None, i], plen + i, attend, rel, len(forced))
        out.append(logits)
    return torch.cat(out)


def _padded(model, reqs):
    """(text, text_lengths, prompts, prompt_lengths) of (ids, prompt or None) requests, as a batch."""
    from funcodec_tpu_torch.models.laura import pad_requests

    return pad_requests([ids for ids, _ in reqs], [p for _, p in reqs], model.cfg.predict_nq, model.cfg.ignore_id)


def _forced_batch(model, reqs, forced) -> torch.Tensor:
    """The same for all requests in one left-aligned batch: (B, 1 + S, nq * V)."""
    S = forced.shape[1]
    text, tl, prompts, pl = _padded(model, reqs)
    emb, shift = model.batch_prefix(text, tl, prompts, pl)
    logits, cache, attend, rel = model.prefill(emb, shift, S)
    out = [logits]
    f = torch.as_tensor(forced, device=model.device)
    plen = torch.as_tensor(pl, device=model.device)
    for i in range(S):
        logits, cache = model.lm_step(cache, f[:, i], plen + i, attend, rel, S)
        out.append(logits)
    return torch.stack(out, 1)


def _forced_session(model, reqs, forced, slots: int, budget: int) -> torch.Tensor:
    """The same through a LauraServingSession's slots, in waves of `slots`
    requests that reuse the slots (stale keys of the last wave in place)."""
    from funcodec_tpu_torch.models.tts_serving import LauraServingSession

    S = forced.shape[1]
    sess = LauraServingSession(model, num_slots=slots, max_new=S, prefix_budget=budget, sampling=False)
    f = torch.as_tensor(forced, device=model.device)
    rows = []
    with torch.inference_mode():
        for w in range(0, len(reqs), slots):
            sess._slot_uid = [None] * slots
            for b in range(w, w + slots):
                sess.submit(f"r{b}", reqs[b][0], 0, prompt=reqs[b][1])
            sess._admit_ready()
            out = [sess.logits.clone()]
            write = torch.ones(slots, dtype=torch.bool, device=model.device)
            for i in range(S):
                logits, sess.cache = model.lm_step(sess.cache, f[w: w + slots, i], None, sess.valid_key[:, None, :],
                                                   sess._rel_proj, S, write_mask=write)
                out.append(logits.float())
            rows.append(torch.stack(out, 1))
    return torch.cat(rows)


def _first_diff(a: np.ndarray, b: np.ndarray):
    n = min(len(a), len(b))
    bad = np.nonzero((a[:n] != b[:n]).any(-1))[0]
    return int(bad[0]) if len(bad) else (None if len(a) == len(b) else n)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def tts_parity(dev, model, model_cpu, codec) -> dict:
    """Card against CPU logits (prefill, teacher-forced steps, syn_audio's
    codec_emb), incremental decode against the full forward."""
    rs = np.random.RandomState(50)
    reqs = [(_tts_text(rs, 12), None), (_tts_text(rs, 40), None), (_tts_text(rs, 40), _prompt_tokens(codec, rs, 3.0, 2))]
    forced = rs.randint(0, 1024, (TTS_FORCED, 2))
    worst = dict(prefill=0.0, steps=0.0, codec_emb=0.0, full_forward=0.0)
    with torch.inference_mode():
        for ids, prompt in reqs:
            card = _forced_b1(model, ids, prompt, forced)
            cpu = _forced_b1(model_cpu, ids, prompt, forced)
            d = (card.cpu() - cpu).abs()
            worst["prefill"] = max(worst["prefill"], float(d[0].max()))
            worst["steps"] = max(worst["steps"], float(d[1:].max()))
            # the full forward over [prefix, forced groups], causal (speech_lengths 1: no
            # bidirectional prefix, as the cached decode's prefill)
            P = 0 if prompt is None else len(prompt)
            tokens = np.concatenate([prompt if P else np.zeros((0, 2), np.int64), forced])[None]
            text_h, tl = model.encode_text(torch.as_tensor(ids[None], device=dev), torch.tensor([len(ids)], device=dev))
            inputs, lengths = model.build_llm_io(text_h, tl, codec=torch.as_tensor(tokens, device=dev),
                                                 codec_lengths=torch.tensor([P + TTS_FORCED], device=dev))
            full = model._lm_forward(inputs, lengths, torch.ones_like(tl))[0]
            start = len(ids) + 2 + P - 1  # the prefix's last position
            worst["full_forward"] = max(worst["full_forward"],
                                        float((full[start: start + TTS_FORCED + 1] - card).abs().max()))
            e_card = model.syn_audio(tokens, ids[None], [len(ids)], lambda e: e, continual_length=P)
            e_cpu = model_cpu.syn_audio(tokens, ids[None], [len(ids)], lambda e: e, continual_length=P)
            worst["codec_emb"] = max(worst["codec_emb"], float((e_card.cpu() - e_cpu).abs().max()))
    log(f"[tts] fp32 card vs CPU (TF32 off), text 12 / 40 / 40 + a 3 s prompt ({len(reqs[2][1])} groups): max|dlogits| "
        f"prefill {worst['prefill']:.3e}, {TTS_FORCED} teacher-forced steps {worst['steps']:.3e}; syn_audio codec_emb "
        f"{worst['codec_emb']:.3e}; card incremental decode vs full forward {worst['full_forward']:.3e} "
        f"(limit {TTS_LOGIT_TOL})")
    if max(worst.values()) > TTS_LOGIT_TOL:
        raise RuntimeError(f"tts parity: {worst} above {TTS_LOGIT_TOL}")
    return worst


def tts_modes(dev, model, codec) -> dict:
    """8 requests, greedy, fp32: decode_codec, decode_codec_batch (B = 8) and a
    4-slot session with slot reuse; token agreement, and the three layouts'
    teacher-forced logits within TTS_LOGIT_TOL."""
    from funcodec_tpu_torch.models.tts_serving import LauraServingSession

    rs = np.random.RandomState(51)
    reqs = [(_tts_text(rs, int(rs.randint(10, 41))), _prompt_tokens(codec, rs, 1.0, 2) if i % 2 else None)
            for i in range(8)]
    budget = max(len(ids) + 2 + (0 if p is None else len(p)) for ids, p in reqs)
    single = [model.decode_codec(ids[None], [len(ids)], max_length=TTS_GREEDY, sampling=False, continual=p)[0]
              for ids, p in reqs]
    text, tl, prompts, pl = _padded(model, reqs)
    batch = model.decode_codec_batch(text, tl, max_length=TTS_GREEDY, sampling=False, continual=prompts,
                                     continual_lengths=pl)
    sess = LauraServingSession(model, num_slots=4, max_new=TTS_GREEDY, prefix_budget=budget, sampling=False)
    for b, (ids, p) in enumerate(reqs):
        sess.submit(f"r{b}", ids, 0, prompt=p)
    served = sess.drain()
    served = [served[f"r{b}"] for b in range(8)]
    out = {}
    for name, rows in (("batch", batch), ("session", served)):
        agree = np.mean([(np.asarray(a) == s).all(-1).mean() if len(a) == len(s) else 0.0
                         for a, s in zip(rows, single)])
        firsts = [_first_diff(np.asarray(a)[pl[b]:], s[pl[b]:]) for b, (a, s) in enumerate(zip(rows, single))]
        firsts = [f for f in firsts if f is not None]
        out[name] = dict(token_agreement=float(agree), first_diff_step=min(firsts) if firsts else None)
    gen = np.stack([s[pl[b]: pl[b] + TTS_FORCED] for b, s in enumerate(single)])  # teacher-force the b1 tokens
    with torch.inference_mode():
        f_single = torch.stack([_forced_b1(model, ids, p, gen[b]) for b, (ids, p) in enumerate(reqs)])
        f_batch = _forced_batch(model, reqs, gen)
    f_sess = _forced_session(model, reqs, gen, 4, budget)
    out["forced_max_abs"] = dict(batch=float((f_batch - f_single).abs().max()),
                                 session=float((f_sess - f_single).abs().max()))
    # a segment of decode steps makes no host synchronisation (torch raises on one in "error" mode)
    sess = LauraServingSession(model, num_slots=4, max_new=TTS_GREEDY, prefix_budget=budget, sampling=0.8)
    for b, (ids, p) in enumerate(reqs[:4]):
        sess.submit(f"r{b}", ids, b, prompt=p)
    sess._admit_ready()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        sess._segment(5)
    finally:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("default")
    log(f"[tts] decode modes, 8 requests (text 10-40, 1 s prompts on 4), greedy fp32, {TTS_GREEDY} groups: against "
        f"decode_codec, decode_codec_batch B=8 token agreement {out['batch']['token_agreement']:.4f} (first differing "
        f"step {out['batch']['first_diff_step']}), 4-slot session with slot reuse {out['session']['token_agreement']:.4f} "
        f"(first differing step {out['session']['first_diff_step']}); teacher-forced logits ({TTS_FORCED} steps) max|d| "
        f"batch {out['forced_max_abs']['batch']:.3e}, session {out['forced_max_abs']['session']:.3e} "
        f"(limit {TTS_LOGIT_TOL}); a 5-step session segment (top-p 0.8) ran under torch.cuda.set_sync_debug_mode('error')")
    if max(out["forced_max_abs"].values()) > TTS_LOGIT_TOL:
        raise RuntimeError(f"tts decode modes: teacher-forced logits differ by {out['forced_max_abs']}")
    return out


def _write_tts_files(model, tokens, codec_config, codec_fp) -> None:
    import yaml

    shutil.rmtree(TTS_DIR, ignore_errors=True)
    TTS_DIR.mkdir(parents=True)
    config = yaml.safe_load(TTS_YAML.read_text())
    config["audio_max_duration"] = TTS_CLI_SECONDS
    (TTS_DIR / "laura.yaml").write_text(yaml.safe_dump(config))
    (TTS_DIR / "tokens.txt").write_text("".join(f"{t}\n" for t in tokens))
    torch.save(model.state_dict(), TTS_DIR / "laura.pth")
    (TTS_DIR / "codec.yaml").write_text(yaml.safe_dump(codec_config))
    torch.save(codec_fp.model.state_dict(), TTS_DIR / "codec.pth")


PLAIN = {"conv1d_s1": conv_kernel.fused_conv1d_s1_reference, "resblock_tgn": resblock_kernel.fused_resblock_tgn_reference}


@contextlib.contextmanager
def _recorded_seanet_calls():
    """Record the arguments of every SEANet kernel wrapper call made inside
    the block (ops/conv.py and models/seanet.py call the wrappers by name):
    [(kernel, wrapper, x, args, kwargs)], x cloned."""
    import funcodec_tpu_torch.models.seanet as seanet_mod

    calls = []

    def recording(kernel, fn):
        def wrapper(x, *args, **kwargs):
            calls.append((kernel, fn, x.detach().clone(), args, kwargs))
            return fn(x, *args, **kwargs)

        return wrapper

    conv_fn, rb_fn = conv_ops.fused_conv1d_s1, seanet_mod.fused_resblock_tgn
    conv_ops.fused_conv1d_s1 = recording("conv1d_s1", conv_fn)
    seanet_mod.fused_resblock_tgn = recording("resblock_tgn", rb_fn)
    try:
        yield calls
    finally:
        conv_ops.fused_conv1d_s1, seanet_mod.fused_resblock_tgn = conv_fn, rb_fn


def _held_calls(calls, what: str = "tts") -> dict:
    """Each recorded call's wrapper against its plain version on the same
    inputs (_held: 2 bf16 ulps, or FP32_REL_TOL of the output's scale for
    fp32 inputs); these launches are not counted."""
    worst = {}  # only the kernels that were called: no error for a kernel that was not
    with torch.inference_mode():
        for i, (kernel, fn, x, args, kwargs) in enumerate(calls):
            out = fn(x, *args, **kwargs)
            if out is None:
                raise RuntimeError(f"{what} {kernel} call {i}: the wrapper did not launch at {tuple(x.shape)}")
            worst[kernel] = max(worst.get(kernel, 0.0), _held(kernel, f"{what} call {i} B={x.shape[0]} C={x.shape[1]} "
                                                     f"T={x.shape[2]}", out, PLAIN[kernel](x, *args, **kwargs)))
    return worst


def tts_kernels(dev, tokens) -> dict:
    """One zero-shot request through Text2Audio (bf16 codec) with the three
    kernels on, launches exact; every SEANet kernel call of the request
    (prompt encode, decode, decode_emb) held against its plain version on
    its own inputs; gen and gen_only_lm against the same tokens with the
    kernels off, within twice the bf16-against-fp32 distance."""
    from funcodec_tpu_torch.cli.text2audio_inference import Text2Audio

    pipe = Text2Audio(str(TTS_DIR / "laura.yaml"), str(TTS_DIR / "laura.pth"), str(TTS_DIR / "codec.yaml"),
                      str(TTS_DIR / "codec.pth"), token_list=str(TTS_DIR / "tokens.txt"), token_type="word",
                      sampling=False, device=dev)
    pipe.codec = Speech2Token(str(TTS_DIR / "codec.yaml"), str(TTS_DIR / "codec.pth"), dtype="bfloat16", device=dev)
    rs = np.random.RandomState(52)
    text = " ".join(tokens[i] for i in rs.randint(0, TTS_VOCAB, 20))
    item = dict(text=text, prompt_audio=(0.1 * rs.randn(2 * SR)).astype(np.float32))
    groups = 50
    set_flags(MAIN_PATH)
    with _recorded_seanet_calls() as calls:
        _sync(dev)
        reset_counts()
        out_k = pipe(item["text"], prompt_audio=item["prompt_audio"], max_length=groups)
        counts = read_counts()
    if counts != TTS_EXPECT:
        raise RuntimeError(f"tts zero-shot request: launches {counts}, expected {TTS_EXPECT}")
    held = _held_calls(calls)
    feats, cont_k = pipe._prep_item(item)
    toks = pipe.model.decode_codec(feats, [feats.shape[1]], max_length=groups, sampling=False, continual=cont_k)
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = rvq.FUSED_RVQ = False
    _, cont_p = pipe._prep_item(item)
    prompt_flips = _flips(cont_k.T, cont_p.T)
    out_p = pipe._synthesize_tokens(toks, feats, len(cont_k))
    pipe.codec = Speech2Token(str(TTS_DIR / "codec.yaml"), str(TTS_DIR / "codec.pth"), dtype="float32", device=dev)
    out_f = pipe._synthesize_tokens(toks, feats, len(cont_k))
    res = dict(launches=counts, held_calls=len(calls), max_abs_err=held,
               prompt_flips=dict(q0=prompt_flips[0], all=prompt_flips[1]))
    for tag in ("gen", "gen_only_lm"):
        if not (out_k[tag].shape == out_p[tag].shape == (groups * 320,)) or not np.isfinite(out_k[tag]).all():
            raise RuntimeError(f"tts {tag}: {out_k[tag].shape} / {out_p[tag].shape}, expected ({groups * 320},)")
        yard = _rel(out_p[tag], out_f[tag])
        err = _rel(out_k[tag], out_p[tag])
        res[tag] = dict(kernels_vs_plain=err, bf16_vs_fp32=yard)
        if err > max(2 * yard, 1e-4):
            raise RuntimeError(f"tts {tag}: kernels vs plain {err:.3e} above twice bf16 vs fp32 ({yard:.3e})")
    if prompt_flips[1] > MAX_FLIP_ALL:
        raise RuntimeError(f"tts prompt tokens: kernels vs plain flip {prompt_flips[1]:.3f}")
    log(f"[tts] zero-shot request (text 20 words, 2 s prompt = {len(cont_k)} groups, {groups} groups, bf16 codec, "
        f"the three kernels): launches {counts} exact; its {len(calls)} SEANet kernel calls (the encode's in bf16, the "
        f"decodes' in fp32 over bf16 weights) each within its limit of the plain version on the same inputs (max|err| "
        f"conv1d_s1 {held['conv1d_s1']:.3e}, resblock_tgn {held['resblock_tgn']:.3e}); prompt token flips vs plain q0 {prompt_flips[0]:.4f} all "
        f"{prompt_flips[1]:.4f}; relative L2 vs plain, same tokens: gen {res['gen']['kernels_vs_plain']:.3e} "
        f"(bf16 vs fp32 {res['gen']['bf16_vs_fp32']:.3e}), gen_only_lm {res['gen_only_lm']['kernels_vs_plain']:.3e} "
        f"(bf16 vs fp32 {res['gen_only_lm']['bf16_vs_fp32']:.3e})")
    return res


def tts_cli(dev, tokens) -> dict:
    """cli/text2audio_inference.main on a seeded 8-line text_scp of words,
    prompts on half the lines, with --serving_slots 4 and --batch_size 1."""
    from funcodec_tpu_torch.cli import text2audio_inference as tcli

    rs = np.random.RandomState(53)
    lines, prompts = [], []
    for i in range(8):
        lines.append(f"s{i} " + " ".join(tokens[j] for j in rs.randint(0, TTS_VOCAB, int(rs.randint(10, 41)))))
        if i % 2:
            pcm = np.clip(np.round(rs.randn(SR) * 0.1 * 32767), -32768, 32767).astype(np.int16)
            write_wav(TTS_DIR / f"prompt{i}.wav", pcm, SR)
            prompts.append(f"s{i} {TTS_DIR / f'prompt{i}.wav'}")
    (TTS_DIR / "text.scp").write_text("\n".join(lines) + "\n")
    (TTS_DIR / "prompt.scp").write_text("\n".join(prompts) + "\n")
    cap = TTS_CLI_SECONDS * 25
    walls = {}
    for name, extra in (("serving_slots_4", ["--serving_slots", "4"]), ("batch_size_1", ["--batch_size", "1"])):
        out = TTS_DIR / name
        _sync(dev)
        t0 = time.perf_counter()
        tcli.main(["--output_dir", str(out), "--config_file", str(TTS_DIR / "laura.yaml"), "--model_file",
                   str(TTS_DIR / "laura.pth"), "--codec_config_file", str(TTS_DIR / "codec.yaml"),
                   "--codec_model_file", str(TTS_DIR / "codec.pth"), "--text_scp", str(TTS_DIR / "text.scp"),
                   "--token_list", str(TTS_DIR / "tokens.txt"), "--token_type", "word", "--prompt_wav_scp",
                   str(TTS_DIR / "prompt.scp"), "--device", str(dev), *extra])
        walls[name] = time.perf_counter() - t0
        if not (out / "tts_eval.json").exists():
            raise RuntimeError(f"tts cli {name}: no tts_eval.json")
        for i in range(8):
            n = {}
            for tag in ("gen", "gen_only_lm"):
                sr, wav = read_wav(out / f"s{i}_{tag}.wav", normalize=False)
                n[tag] = wav.shape[0]
                if sr != SR or wav.shape[0] % 320 or not 0 < wav.shape[0] <= cap * 320:
                    raise RuntimeError(f"tts cli {name}: s{i}_{tag}.wav has {wav.shape[0]} samples at {sr} Hz")
            if n["gen"] != n["gen_only_lm"]:
                raise RuntimeError(f"tts cli {name}: s{i}'s gen and gen_only_lm lengths differ: {n}")
    log(f"[tts] cli/text2audio_inference: 8 lines (4 with 1 s prompts), top-k 25, <= {cap} groups, 16 wavs and "
        f"tts_eval.json each with --serving_slots 4 ({walls['serving_slots_4']:.1f} s) and --batch_size 1 "
        f"({walls['batch_size_1']:.1f} s); every wav 320 samples a group")
    return walls


def _timed(fn, dev, warm=None, reps: int = 3) -> float:
    """Best of `reps` wall seconds of fn() after a warm-up (`warm`, a shorter
    run of the same shapes, or fn itself), fenced with synchronize."""
    (warm or fn)()
    _sync(dev)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def tts_timing(dev, model, codec_fp, card: str) -> dict:
    """scripts/bench_tts_serving.py's workload (greedy) on the session and on
    lockstep decode_codec_batch, bf16 and fp32, and batch-1 / prefill /
    syn_audio times."""
    import copy

    from funcodec_tpu_torch.models.tts_serving import LauraServingSession

    cfg = TTS_BENCH
    rs = np.random.RandomState(54)
    n, lt, slots = cfg["requests"], cfg["text"], cfg["slots"]
    caps = rs.choice(np.asarray(cfg["caps"]), n)
    texts = [_tts_text(rs, lt) for _ in range(n)]
    useful = int(caps.sum())
    rows = {}
    for dtype in ("float32", "bfloat16"):
        m = model if dtype == "float32" else copy.deepcopy(model).to(torch.bfloat16)
        sess = LauraServingSession(m, num_slots=slots, max_new=max(cfg["caps"]), prefix_budget=lt + 2,
                                   sampling=False, segment_steps=cfg["segment"])

        def serve(count=n, cap=None):
            sess.stats = dict.fromkeys(sess.stats, 0)
            for i in range(count):
                sess.submit(f"u{i}", texts[i], i, max_new=cap or int(caps[i]))
            got = sess.drain()
            if cap is None and sum(len(v) for v in got.values()) != useful:
                raise RuntimeError("tts timing: the session's groups are not the caps' sum (an eos under greedy)")

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        wall_s = _timed(serve, dev, warm=lambda: serve(slots, cfg["segment"]))
        peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
        steps_s = sess.stats["slot_steps"] // slots
        plans = [(list(range(i, min(i + slots, n))), int(caps[i: i + slots].max())) for i in range(0, n, slots)]

        def lockstep(plan=plans):
            for idx, cap in plan:
                m.decode_codec_batch(np.stack([texts[j] for j in idx]), np.full(len(idx), lt), max_length=cap,
                                     sampling=False)

        warm = [(plans[0][0], cfg["segment"])]
        lockstep(warm)
        syncs0 = m.host_syncs
        wall_l = _timed(lockstep, dev, warm=lambda: lockstep(warm), reps=TTS_REPS_OTHER)
        syncs_l = (m.host_syncs - syncs0 - 1) / (TTS_REPS_OTHER * len(plans))  # the warm-up batch syncs once
        steps_l = sum(cap for _, cap in plans)
        G = cfg["single"]

        def single(length=G):
            m.decode_codec(texts[0][None], [lt], max_length=length, sampling=False)

        single(cfg["segment"])
        syncs0 = m.host_syncs
        wall_1 = _timed(single, dev, warm=lambda: single(cfg["segment"]), reps=TTS_REPS_OTHER)
        syncs_1 = (m.host_syncs - syncs0 - 1) / TTS_REPS_OTHER

        def prefill():
            with torch.inference_mode():
                emb, shift = m.batch_prefix(texts[0][None], [lt])
                m.prefill(emb, shift, G)

        wall_p = _timed(prefill, dev)
        toks = np.zeros((1, G, 2), np.int64)
        wall_syn = _timed(lambda: m.syn_audio(toks, texts[0][None], [lt], lambda e: e), dev)
        wall_syn_dec = _timed(lambda: m.syn_audio(toks, texts[0][None], [lt],
                                                  lambda e: codec_fp(e, run_mod="decode_emb")[2]), dev)
        row = dict(
            session_groups_per_s=useful / wall_s, session_ms_per_step=1e3 * wall_s / steps_s, session_steps=steps_s,
            session_wall_s=wall_s, session_host_syncs=sess.stats["host_syncs"],
            session_host_syncs_per_step=sess.stats["host_syncs"] / steps_s,
            session_slot_utilisation=sess.stats["live_steps"] / sess.stats["slot_steps"],
            lockstep_groups_per_s=useful / wall_l, lockstep_ms_per_step=1e3 * wall_l / steps_l, lockstep_steps=steps_l,
            lockstep_wall_s=wall_l, lockstep_host_syncs_per_batch=syncs_l, lockstep_host_syncs_per_step=syncs_l * len(
                plans) / steps_l,
            single_ms_per_group=1e3 * wall_1 / G, single_host_syncs=syncs_1, single_host_syncs_per_step=syncs_1 / G,
            prefill_ms=1e3 * wall_p, syn_audio_ms=1e3 * wall_syn, syn_audio_decode_emb_ms=1e3 * wall_syn_dec,
            session_peak_gib=peak, useful_groups=useful)
        rows[dtype] = row
        log(f"[time] tts {dtype}, {n} requests (text {lt}, caps {min(cfg['caps'])}-{max(cfg['caps'])}, {useful} "
            f"groups), greedy: session {slots} slots seg {cfg['segment']}: {row['session_groups_per_s']:.1f} groups/s, "
            f"{row['session_ms_per_step']:.3f} ms/step ({steps_s} steps, slot utilisation "
            f"{row['session_slot_utilisation']:.3f}, {sess.stats['host_syncs']} host syncs); lockstep "
            f"decode_codec_batch B={slots} in arrival order: {row['lockstep_groups_per_s']:.1f} groups/s, "
            f"{row['lockstep_ms_per_step']:.3f} ms/step ({steps_l} steps, {syncs_l:.1f} host syncs a batch); "
            f"batch-1 {G} groups {row['single_ms_per_group']:.3f} ms/group ({syncs_1:.0f} host syncs); prefill "
            f"{row['prefill_ms']:.2f} ms; syn_audio {row['syn_audio_ms']:.2f} ms (+ decode_emb "
            f"{row['syn_audio_decode_emb_ms']:.2f} ms); session peak memory {peak:.2f} GiB ({card})")
        del sess, m
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def tts_phase(dev, card: str) -> dict:
    """LauraTTS serving on the card: build, parity, decode modes, the codec
    kernels on the TTS path, the CLI, timing."""
    t_phase = t_lap = time.perf_counter()
    walls = {}

    def lap(name: str) -> None:
        nonlocal t_lap
        now = time.perf_counter()
        walls[name], t_lap = now - t_lap, now

    codec_config = _flagship_config()
    codec_fp = Speech2Token(codec_config, None, dtype="float32", device=dev)
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = rvq.FUSED_RVQ = False
    config, tokens, model = build_tts(dev, codec_fp)
    log(f"[tts] {TTS_YAML.name} at full width: {TTS_PARAMS} parameters (the 256-word list and the frozen 32 x 1024 x "
        f"128 codebook, grafted from the flagship codec, included)")
    from funcodec_tpu_torch.tasks.text2audio import build_laura_model

    model_cpu = build_laura_model(config, token_list=tokens, device="cpu")
    model_cpu.load_state_dict(model.state_dict())
    codec_cpu = Speech2Token(codec_config, None, dtype="float32", device="cpu")
    codec_cpu.model.load_state_dict(codec_fp.model.state_dict())
    lap("build")
    parity = tts_parity(dev, model, model_cpu, codec_cpu)
    del model_cpu, codec_cpu
    lap("parity")
    modes = tts_modes(dev, model, codec_fp)
    lap("modes")
    _write_tts_files(model, tokens, codec_config, codec_fp)
    kernels = tts_kernels(dev, tokens)
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = rvq.FUSED_RVQ = False
    lap("kernels")
    cli_walls = tts_cli(dev, tokens)
    lap("cli")
    timing = tts_timing(dev, model, codec_fp, card)
    lap("timing")
    out = dict(parity=parity, modes=modes, kernels=kernels, cli_wall_s=cli_walls, timing=timing,
               phase_s=time.perf_counter() - t_phase, part_s=walls)
    log(f"[tts] phase {out['phase_s']:.1f} s: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f" ({card})")
    return out


# ---------------------------------------------------------------------------
# Laura training phase: the LibriTTS Laura recipe end to end
# ---------------------------------------------------------------------------

LAURA_DIR = OUT_DIR / "laura"
LAURA_TOKENS = REPO / "egs/LibriTTS/text2speech_laura/conf/arpabet_tokens.txt"  # the recipe's 78-entry list
LAURA_PARAMS = 88_395_778  # TTS_YAML with LAURA_TOKENS (84,201,474 trainable: all but the frozen codebook)
LAURA_UTTS = {"train": 128, "valid": 16}
LAURA_SECONDS = (2.0, 8.0)  # utterances of uniformly drawn length
LAURA_PHONES_PER_S = 12
LAURA_EPOCHS = 2
LAURA_ENCODE_B = 8  # run.sh stage 1: --batch_size 8 --bit_width 16000
# one batch of stage 1 (--run_mod encode): the encoder's kernels; the encode mode's RVQ search is the exact
# fp32 scan in both packages, so no rvq_encode
LAURA_ENCODE = {"conv1d_s1": 2, "resblock_tgn": 12, "resblock_tgn_finalize": 8, "rvq_encode": 0}
LAURA_SYN_LINES = 4  # stage 3: text lines, the second with a zero-shot prompt from the valid corpus
LAURA_CPU_UTTS = 2  # the card-against-CPU step's batch
# card against CPU, fp32 with TF32 off, one forward and backward from the same weights and batch: the loss
# and its stats differ by summation order (relative to each stat's scale, floor 1); an accuracy by at most
# one position; each module's gradient norm relative
LAURA_STAT_REL, LAURA_GRAD_REL = 1e-4, 1e-3
LAURA_MODULES = ("text_encoder", "text_enc_out_layer", "token_embedding", "lm_embedding", "codec_lm",
                 "codec_encoder", "codec_encoder_out_layer")


def _laura_corpus(split: str, seed: int, phones) -> dict:
    """Seeded noise utterances (wav.scp) and a text line of seeded phonemes for each: {key: samples}."""
    rs = np.random.RandomState(seed)
    seconds = rs.uniform(*LAURA_SECONDS, LAURA_UTTS[split])
    lengths = _write_corpus(LAURA_DIR / split, seconds, SR, seed=seed + 1)
    with open(LAURA_DIR / split / "text", "w") as f:
        for (key, n), sec in zip(lengths.items(), seconds):
            f.write(f"{key} " + " ".join(phones[i] for i in rs.randint(0, len(phones), round(LAURA_PHONES_PER_S * sec)))
                    + "\n")
    return lengths


def laura_tokens(dev, lengths: dict) -> dict:
    """Recipe stage 1: cli/codec_inference --run_mod encode on each split (bf16, the three flags), launches
    exact; the valid split's SEANet kernel calls held against their plain versions; the ark's tokens."""
    frames = {k: -(-n // 320) for k, n in lengths.items()}
    out = dict(launches={}, wall_s={})
    for split in ("train", "valid"):
        n_batches = -(-LAURA_UTTS[split] // LAURA_ENCODE_B)
        set_flags(MAIN_PATH)
        with _recorded_seanet_calls() as calls:
            _sync(dev)
            reset_counts()
            t0 = time.perf_counter()
            cli.main(["--config_file", str(LAURA_DIR / "codec.yaml"), "--model_file", str(LAURA_DIR / "codec.pth"),
                      "--output_dir", str(LAURA_DIR / f"tokens_{split}"), "--data_path_and_name_and_type",
                      f"{LAURA_DIR / split / 'wav.scp'},speech,sound", "--run_mod", "encode", "--batch_size",
                      str(LAURA_ENCODE_B), "--bit_width", "16000", "--indices_save_type", "ark", "--dtype",
                      "bfloat16", "--device", str(dev)])
            out["wall_s"][split] = time.perf_counter() - t0
            counts = read_counts()
        expect = {k: n_batches * v for k, v in LAURA_ENCODE.items()}
        if counts != expect:
            raise RuntimeError(f"laura stage 1 {split}: launches {counts}, expected {expect} ({n_batches} batches)")
        out["launches"][split] = counts
        if split == "valid":
            out["max_abs_err"] = _held_calls(calls, "laura stage 1")
            out["held_calls"] = len(calls)
        del calls
        ark = ArkScpReader(LAURA_DIR / f"tokens_{split}" / "indices.scp")
        for key in (k for k in frames if k.startswith(split)):
            tok = ark[key]
            if tok.shape != (frames[key], 32) or tok.min() < 0 or tok.max() >= 1024 or (tok != np.round(tok)).any():
                raise RuntimeError(f"laura stage 1 {split}: {key} tokens {tok.shape}, expected ({frames[key]}, 32)")
    log(f"[laura] stage 1, cli/codec_inference --run_mod encode --batch_size {LAURA_ENCODE_B} --bit_width 16000 "
        f"--indices_save_type ark, bf16 with the three flags: {LAURA_UTTS['train']} + {LAURA_UTTS['valid']} "
        f"utterances in {out['wall_s']['train']:.2f} + {out['wall_s']['valid']:.2f} s; launches {out['launches']} "
        f"exact ({LAURA_ENCODE} a batch: the encode mode's RVQ is the exact fp32 scan); the valid split's "
        f"{out['held_calls']} SEANet kernel calls each within its limit of the plain version (max|err| "
        f"{out['max_abs_err']})")
    return out


def _laura_args(dev, exp: Path, *extra) -> list:
    return ["--config", str(TTS_YAML), "--output_dir", str(exp), "--train_text", str(LAURA_DIR / "train" / "text"),
            "--train_codec", str(LAURA_DIR / "tokens_train" / "indices.scp"), "--valid_text",
            str(LAURA_DIR / "valid" / "text"), "--valid_codec", str(LAURA_DIR / "tokens_valid" / "indices.scp"),
            "--token_list", str(LAURA_TOKENS), "--token_type", "word", "--codec_init_param",
            str(LAURA_DIR / "codec.pth"), "--codec_config", str(LAURA_DIR / "codec.yaml"), "--device", str(dev),
            *extra]


def _laura_model(dev, config, tokens):
    """The model cli/text2audio_train builds (seed 0), the codec's codebooks grafted."""
    from funcodec_tpu_torch.cli.text2audio_train import graft_codebooks
    from funcodec_tpu_torch.tasks.text2audio import build_laura_model

    model = build_laura_model(config, token_list=tokens, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(0))
    return graft_codebooks(model, str(LAURA_DIR / "codec.pth"))


def _laura_batches(config, tokens, split: str):
    """(dataset, length_batches at batch_bins, lengths) of a split, as cli/text2audio_train builds them."""
    from funcodec_tpu_torch.data.dataset import CodecDataset
    from funcodec_tpu_torch.data.sampler import length_batches
    from funcodec_tpu_torch.data.text import Text2AudioPreprocessor

    pre = Text2AudioPreprocessor(train=False, audio_max_duration=config["audio_max_duration"],
                                 codec_token_rate=config["codec_token_rate"], token_list=tokens, token_type="word")
    ds = CodecDataset([(str(LAURA_DIR / split / "text"), "text", "text"),
                       (str(LAURA_DIR / f"tokens_{split}" / "indices.scp"), "codec", "kaldi_ark")], preprocess=pre)
    lens = {u: len(ds[u][1]["codec"]) + len(ds[u][1]["text"]) for u in ds.uttids}
    return ds, length_batches(ds.uttids, lens, config["batch_bins"]), lens


def _collated(ds, keys):
    from funcodec_tpu_torch.data.dataset import collate_fn

    return collate_fn([ds[u] for u in keys], int_pad_value=-1)[1]


def _module_moved(model, before: dict) -> dict:
    """{top-level module: whether any of its parameters differs from `before` (a CPU state_dict)}."""
    moved = {m: False for m in LAURA_MODULES}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        if top in moved and not torch.equal(p.detach().cpu(), before[name]):
            moved[top] = True
    return moved


def _check_laura_run(exp: Path, epochs: int, what: str) -> dict:
    """The checkpoint contract's files and links and a finite reporter.json; returns its stats."""
    missing = [n for n in ("checkpoint.pth", f"{epochs}epoch.pth", "reporter.json") if not (exp / n).exists()]
    best = exp / "valid.loss.best.pth"
    if missing or not (exp / "latest.pth").is_symlink() or not (best.is_symlink() and best.exists()):
        raise RuntimeError(f"laura {what}: missing {missing} or links in {sorted(os.listdir(exp))}")
    if os.readlink(exp / "latest.pth") != f"{epochs}epoch.pth":
        raise RuntimeError(f"laura {what}: latest.pth points at {os.readlink(exp / 'latest.pth')}")
    stats = json.loads((exp / "reporter.json").read_text())["stats"]
    bad = [(e, ph, k) for e, phases in stats.items() for ph, kv in phases.items() for k, v in kv.items()
           if not math.isfinite(v)]
    if bad or set(stats) != {str(e) for e in range(1, epochs + 1)}:
        raise RuntimeError(f"laura {what}: epochs {sorted(stats)}, stats not finite: {bad[:5]}")
    return stats


def laura_train(dev, config, tokens, embed: torch.Tensor, card: str) -> dict:
    """Recipe stage 2: cli/text2audio_train on the shipped yaml at full width, fp32, 2 epochs: the
    parameter count, the artifacts, finite stats, no codec kernel launch, the codebook equal to the codec's,
    every module moved; then resumed to epoch 3 (the loaded state equal to checkpoint.pth bit for bit,
    epochs 1-2 unchanged)."""
    from funcodec_tpu_torch.cli import text2audio_train
    from funcodec_tpu_torch.train.checkpoint import train_state_dict
    from funcodec_tpu_torch.train.laura_trainer import LauraTrainer

    exp = LAURA_DIR / "exp"
    before = {k: v.cpu() for k, v in _laura_model(dev, config, tokens).state_dict().items()}
    set_flags(MAIN_PATH)
    _sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    trainer, state = text2audio_train.main(_laura_args(dev, exp, "--max_epoch", str(LAURA_EPOCHS)))
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    n_params = sum(p.numel() for p in state.model.parameters())
    n_train = sum(p.numel() for p in state.model.parameters() if p.requires_grad)
    if n_params != LAURA_PARAMS:
        raise RuntimeError(f"laura stage 2: {n_params} parameters, expected {LAURA_PARAMS}")
    if any(counts.values()):
        raise RuntimeError(f"laura stage 2: the codec kernels launched during LM training: {counts}")
    stats = _check_laura_run(exp, LAURA_EPOCHS, "stage 2")
    if not torch.equal(state.model.quantizer_codebook.embed, embed):
        raise RuntimeError("laura stage 2: the frozen codebook is not the codec's quantizer.rq.model.embed")
    moved = _module_moved(state.model, before)
    if not all(moved.values()):
        raise RuntimeError(f"laura stage 2: modules that did not move: {[m for m, v in moved.items() if not v]}")
    walls = trainer.epoch_walls
    steady = walls[LAURA_EPOCHS]
    steps = state.step
    log(f"[laura] stage 2, cli/text2audio_train on {TTS_YAML.name} at full width ({n_params:,} parameters, "
        f"{n_train:,} trainable; fp32, batch_bins {config['batch_bins']}): {LAURA_EPOCHS} epochs, {steps} steps in "
        f"{wall:.2f} s (model build and data included); every stat finite (epoch {LAURA_EPOCHS} train loss "
        f"{stats[str(LAURA_EPOCHS)]['train']['loss']:.4f}, valid loss "
        f"{stats[str(LAURA_EPOCHS)]['valid']['loss']:.4f}); "
        f"no codec kernel launch {counts}; the codebook equals the codec's; every module moved {sorted(moved)}")
    loop = dict(frames=steady["train_frames"], seconds=steady["train_s"], steps=steady["train_steps"],
                frames_per_s=steady["train_frames"] / steady["train_s"], checkpoint_s=steady["checkpoint_s"],
                checkpoint_mib=steady["checkpoint_bytes"] / 2**20, valid_s=steady["valid_s"])
    log(f"[laura] the loop's epoch {LAURA_EPOCHS}: {loop['steps']} steps, {loop['frames']} codec frames in "
        f"{loop['seconds']:.3f} s = {loop['frames_per_s']:.1f} training frames/s; checkpoint.pth "
        f"{loop['checkpoint_mib']:.1f} MiB written in {loop['checkpoint_s']:.3f} s; validation "
        f"{loop['valid_s']:.3f} s ({card})")

    # resume to a third epoch: the loaded state is checkpoint.pth bit for bit
    saved = torch.load(exp / "checkpoint.pth", map_location="cpu", weights_only=True)
    _same_tree(train_state_dict(state), saved)
    fresh = LauraTrainer(_laura_model(dev, config, tokens), trainer.opt)
    loaded, start = fresh.resume(fresh.init_state())
    _same_tree(train_state_dict(loaded), saved)
    if start != LAURA_EPOCHS + 1 or loaded.step != steps:
        raise RuntimeError(f"laura resume: start epoch {start}, step {loaded.step}")
    del trainer, state, fresh, loaded, saved
    torch.cuda.empty_cache()
    reset_counts()
    trainer, state = text2audio_train.main(_laura_args(dev, exp, "--max_epoch", str(LAURA_EPOCHS + 1)))
    resumed = _check_laura_run(exp, LAURA_EPOCHS + 1, "resume")
    per_epoch = steps // LAURA_EPOCHS
    if state.step != steps + per_epoch or any(resumed[e] != stats[e] for e in stats) or any(read_counts().values()):
        raise RuntimeError(f"laura resume: step {state.step}, or the stats of epochs 1-{LAURA_EPOCHS} changed, "
                           f"or a codec kernel launched {read_counts()}")
    if not torch.equal(state.model.quantizer_codebook.embed, embed):
        raise RuntimeError("laura resume: the frozen codebook changed")
    log(f"[laura] resume: the loaded state equals checkpoint.pth bit for bit; step {state.step}, epochs "
        f"1-{LAURA_EPOCHS} unchanged in reporter.json, epoch {LAURA_EPOCHS + 1} trained and validated")
    return dict(wall_s=wall, steps=steps, parameters=n_params, trainable=n_train, stats=stats, loop=loop,
                launches=counts, model=state.model, trainer=trainer)


def _laura_grads(model, batch, gen):
    """(loss, stats, {module: gradient norm}) of one forward and backward, fp32."""
    loss, stats = model(batch["text"], batch["text_lengths"], batch["codec"], batch["codec_lengths"], gen)
    names, params = zip(*[(n, p) for n, p in model.named_parameters() if p.requires_grad])
    grads = torch.autograd.grad(loss, params)
    sq = {}
    for n, g in zip(names, grads):
        top = n.split(".")[0]
        sq[top] = sq.get(top, 0.0) + float(g.double().square().sum())
    stats = {k: float(v.detach()) for k, v in stats.items()}
    return float(loss.detach()), stats, {k: math.sqrt(v) for k, v in sq.items()}


def laura_card_cpu(dev, config, tokens, model, ds, lens) -> dict:
    """One fp32 forward and backward of the trained weights on the card and on the CPU, at the two shortest
    valid utterances, sampling ratio 0 (no draws; the shipped yaml has no SpecAug)."""
    import dataclasses

    from funcodec_tpu_torch.tasks.text2audio import build_laura_model
    from funcodec_tpu_torch.train.laura_trainer import LauraTrainer, LauraTrainerOptions

    cpu = build_laura_model(config, token_list=tokens, device="cpu")
    cpu.load_state_dict(model.state_dict())
    keys = sorted(lens, key=lambda u: lens[u])[:LAURA_CPU_UTTS]
    host = _collated(ds, keys)
    out = []
    for m in (model, cpu):
        m.cfg = dataclasses.replace(m.cfg, codec_sampling_ratio=0.0)
        batch = LauraTrainer(m, LauraTrainerOptions()).to_device(host)
        out.append(_laura_grads(m, batch, torch.Generator(device=m.device)))
    model.cfg = dataclasses.replace(model.cfg, codec_sampling_ratio=config["model_conf"]["codec_sampling_ratio"])
    (l_card, s_card, g_card), (l_cpu, s_cpu, g_cpu) = out
    positions = LAURA_CPU_UTTS * (batch["codec"].shape[1] + 1)  # an accuracy's mean runs over the padded groups
    stat_err = max(abs(s_card[k] - s_cpu[k]) / max(abs(s_cpu[k]), 1.0) for k in s_cpu if not k.startswith("out_acc"))
    acc_err = max(abs(s_card[k] - s_cpu[k]) for k in s_cpu if k.startswith("out_acc"))
    grad_err = max(abs(g_card[k] - g_cpu[k]) / g_cpu[k] for k in g_cpu)
    log(f"[laura] fp32 card vs CPU, one forward and backward at {LAURA_CPU_UTTS} utterances (ratio 0): loss "
        f"{l_card:.6f} / {l_cpu:.6f}; worst stat {stat_err:.3e} of its scale (limit {LAURA_STAT_REL:.0e}), accuracy "
        f"{acc_err:.3e} (limit one position, {1 / positions:.3e}); worst module gradient norm {grad_err:.3e} "
        f"relative (limit {LAURA_GRAD_REL:.0e}) over {sorted(g_cpu)}")
    if stat_err > LAURA_STAT_REL or acc_err > 1.0 / positions + 1e-7 or grad_err > LAURA_GRAD_REL:
        raise RuntimeError("laura: the card's fp32 step disagrees with the CPU's")
    return dict(loss_card=l_card, loss_cpu=l_cpu, stat_rel=stat_err, acc_abs=acc_err, grad_norm_rel=grad_err,
                grad_norms_card=g_card, grad_norms_cpu=g_cpu)


def _device_kernels(fn, ranges: tuple = ()) -> tuple:
    """(device kernels one fn() launches, their summed device ms), from torch.profiler. With
    `ranges`, a third item: {name: (kernels, device ms)} of the kernels launched inside each
    record_function range of that name, found through the profiler's launch correlation (each
    kernel hangs on the op that launched it), so in the same profiled run as the total."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    _sync(CARD)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(CARD)
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.name not in ranges]
    total = (len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3)
    if not ranges:
        return total
    parts = {name: [0, 0.0] for name in ranges}

    def add(e, part):
        part[0] += len(e.kernels)
        part[1] += sum(k.duration for k in e.kernels) / 1e3
        for child in e.cpu_children:
            add(child, part)

    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in parts:
            add(e, parts[e.name])
    return (*total, {name: tuple(v) for name, v in parts.items()})


def _kernel_launches(fn) -> int:
    """Device kernels one fn() launches, counted by torch.profiler."""
    return _device_kernels(fn)[0]


def laura_step_timing(dev, config, tokens, ds, batches, lens, card: str) -> dict:
    """The bare step at batch_bins (the split's batch with the most padded bins), fp32 and bf16 over fp32
    masters: ms (best of 3 after a warm-up), training codec frames/s, peak memory, launches a step."""
    from funcodec_tpu_torch.train.laura_trainer import LauraTrainer, LauraTrainerOptions

    keys = max(batches, key=lambda b: len(b) * max(lens[u] for u in b))
    host = _collated(ds, keys)
    frames = int(host["codec_lengths"].sum())
    rows = {}
    for dtype in ("float32", "bfloat16"):
        model = _laura_model(dev, config, tokens)
        trainer = LauraTrainer(model, LauraTrainerOptions(train_dtype=dtype))
        state = trainer.init_state()
        batch = trainer.to_device(host)
        gen = torch.Generator(device=dev)

        def step():
            nonlocal state
            state, _ = trainer.train_step(state, batch, gen.manual_seed(state.step))

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        seconds = _timed(step, dev)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = _kernel_launches(step)
        shape = (tuple(batch["text"].shape), tuple(batch["codec"].shape))
        rows[dtype] = dict(ms=seconds * 1e3, frames=frames, frames_per_s=frames / seconds, peak_gib=peak,
                           launches=launches, batch=len(keys), shapes=shape)
        log(f"[laura] bare step {dtype}{' over fp32 masters' if dtype == 'bfloat16' else ''}, batch_bins "
            f"{config['batch_bins']}: {len(keys)} utterances (text {shape[0]}, codec {shape[1]}, {frames} frames): "
            f"{seconds * 1e3:.2f} ms = {frames / seconds:.1f} training frames/s, peak {peak:.2f} GiB, "
            f"{launches} device kernels a step ({card})")
        del model, trainer, state, batch
        torch.cuda.empty_cache()
    return rows


def laura_synthesis(dev, exp: Path, tokens, phones, valid_lengths) -> dict:
    """Recipe stage 3: cli/text2audio_inference with --model_file exp/latest.pth on 4 text lines, the second
    with a zero-shot prompt from the valid corpus, the three flags on: launches exact, each codec kernel call
    held against its plain version, every wav the decode's length."""
    import yaml

    from funcodec_tpu_torch.cli import text2audio_inference as tcli

    syn = LAURA_DIR / "syn"
    syn.mkdir(parents=True, exist_ok=True)
    config = yaml.safe_load(TTS_YAML.read_text())
    config["audio_max_duration"] = TTS_CLI_SECONDS  # the decode's cap: barely trained weights emit no eos
    (syn / "laura.yaml").write_text(yaml.safe_dump(config))
    rs = np.random.RandomState(60)
    lines = [f"syn{i} " + " ".join(phones[j] for j in rs.randint(0, len(phones), int(rs.randint(20, 61))))
             for i in range(LAURA_SYN_LINES)]
    (syn / "text").write_text("\n".join(lines) + "\n")
    prompt_key = sorted(valid_lengths)[0]
    (syn / "prompt.scp").write_text(f"syn1 {LAURA_DIR / 'valid' / f'{prompt_key}.wav'}\n")
    cap = TTS_CLI_SECONDS * config["codec_token_rate"]
    set_flags(MAIN_PATH)
    with _recorded_seanet_calls() as calls, _recorded_rvq_calls() as rvq_calls:
        _sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        tcli.main(["--output_dir", str(syn / "out"), "--config_file", str(syn / "laura.yaml"), "--model_file",
                   str(exp / "latest.pth"), "--codec_config_file", str(LAURA_DIR / "codec.yaml"),
                   "--codec_model_file", str(LAURA_DIR / "codec.pth"), "--text_scp", str(syn / "text"),
                   "--token_list", str(LAURA_TOKENS), "--token_type", "word", "--prompt_wav_scp",
                   str(syn / "prompt.scp"), "--device", str(dev)])
        _sync(dev)
        wall = time.perf_counter() - t0
        counts = read_counts()
    # every line: the AR tokens' decode and the dense embeddings' decode_emb; the prompt: one encode
    expect = {k: 2 * LAURA_SYN_LINES * DECODE_PER_BATCH[k] + EXPECT[MAIN_PATH][k] - DECODE_PER_BATCH[k]
              for k in EXPECT[MAIN_PATH]}
    if counts != expect:
        raise RuntimeError(f"laura stage 3: launches {counts}, expected {expect}")
    held = _held_calls(calls, "laura stage 3")
    held["rvq_encode"] = _held_rvq(rvq_calls, "laura stage 3 prompt")
    n_seanet, n_rvq = len(calls), len(rvq_calls)
    del calls, rvq_calls
    prompt_groups = -(-valid_lengths[prompt_key] // 320)
    for i in range(LAURA_SYN_LINES):
        for tag in ("gen", "gen_only_lm"):
            sr, wav = read_wav(syn / "out" / f"syn{i}_{tag}.wav", normalize=False)
            if sr != SR or wav.shape[0] % 320 or not 0 < wav.shape[0] <= cap * 320 or not np.isfinite(wav).all():
                raise RuntimeError(f"laura stage 3: syn{i}_{tag}.wav has {wav.shape[0]} samples at {sr} Hz")
    if not (syn / "out" / "tts_eval.json").exists():
        raise RuntimeError("laura stage 3: no tts_eval.json")
    log(f"[laura] stage 3, cli/text2audio_inference --model_file exp/latest.pth: {LAURA_SYN_LINES} lines (one with "
        f"a {prompt_groups}-group zero-shot prompt from the valid corpus), top-k 25, <= {cap} groups, in {wall:.2f} s; "
        f"launches {counts} exact; its {n_seanet} SEANet and {n_rvq} rvq_encode calls each within its limit of the "
        f"plain version (max|err| {held}); 8 wavs and tts_eval.json")
    return dict(wall_s=wall, launches=counts, max_abs_err=held, held_calls=n_seanet + n_rvq)


def laura_phase(dev, card: str) -> dict:
    """The LibriTTS Laura recipe on the card: tokens, training, synthesis; the bare step's numbers."""
    import yaml

    from funcodec_tpu_torch.utils.tts_quality import held_out_token_nll

    t_phase = t_lap = time.perf_counter()
    walls = {}

    def lap(name: str) -> None:
        nonlocal t_lap
        now = time.perf_counter()
        walls[name], t_lap = now - t_lap, now

    shutil.rmtree(LAURA_DIR, ignore_errors=True)
    LAURA_DIR.mkdir(parents=True)
    tokens = [t.strip() for t in LAURA_TOKENS.read_text().splitlines() if t.strip()]
    phones = [t for t in tokens if t not in ("<blank>", "<unk>")]
    lengths = _laura_corpus("train", 61, phones)
    valid_lengths = _laura_corpus("valid", 62, phones)
    codec_config = _flagship_config()
    codec = Speech2Token(codec_config, None, dtype="float32", device=dev)
    (LAURA_DIR / "codec.yaml").write_text(yaml.safe_dump(codec_config))
    torch.save(codec.model.state_dict(), LAURA_DIR / "codec.pth")
    embed = codec.model.quantizer.state.embed.detach().clone()
    del codec
    lap("corpus")
    stage1 = laura_tokens(dev, {**lengths, **valid_lengths})
    lap("stage1")
    config = yaml.safe_load(TTS_YAML.read_text())
    stage2 = laura_train(dev, config, tokens, embed, card)
    model, trainer = stage2.pop("model"), stage2.pop("trainer")
    v_ds, v_batches, v_lens = _laura_batches(config, tokens, "valid")
    nll = held_out_token_nll(model, [trainer.to_device(_collated(v_ds, b)) for b in v_batches])
    updates = stage2["steps"] + stage2["steps"] // LAURA_EPOCHS  # the resumed epoch's too
    log(f"[laura] held_out_token_nll on the valid set: {nll['token_nll']:.4f} nats a token (ppl "
        f"{nll['token_ppl']:.1f}, {nll['n_tokens']} tokens; random weights after {updates} updates at the warmup's "
        f"rate: ln 1025 = {math.log(1025):.4f})")
    lap("stage2")
    card_cpu = laura_card_cpu(dev, config, tokens, model, v_ds, v_lens)
    del model, trainer
    torch.cuda.empty_cache()
    lap("card_cpu")
    t_ds, t_batches, t_lens = _laura_batches(config, tokens, "train")
    step = laura_step_timing(dev, config, tokens, t_ds, t_batches, t_lens, card)
    lap("step")
    stage3 = laura_synthesis(dev, LAURA_DIR / "exp", tokens, phones, valid_lengths)
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = rvq.FUSED_RVQ = False
    lap("stage3")
    loop = stage2["loop"]
    ratio = loop["frames_per_s"] / step["float32"]["frames_per_s"]
    log(f"[laura] the loop's steady epoch {loop['frames_per_s']:.1f} frames/s = {ratio:.3f} of the bare fp32 step's "
        f"{step['float32']['frames_per_s']:.1f} (its batches are smaller than the timed one's)")
    launches = {k: stage1["launches"]["train"][k] + stage1["launches"]["valid"][k] + stage3["launches"][k]
                for k in EXPECT[MAIN_PATH]}
    max_err = {k: max(stage1["max_abs_err"].get(k, 0.0), stage3["max_abs_err"].get(k, 0.0))
               for k in stage3["max_abs_err"]}
    out = dict(stage1=stage1, stage2=stage2, held_out_token_nll=nll, card_vs_cpu=card_cpu, step=step,
               loop_to_step=ratio, stage3=stage3, launches=launches, max_abs_err=max_err,
               phase_s=time.perf_counter() - t_phase, part_s=walls)
    log(f"[laura] phase {out['phase_s']:.1f} s: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; main-path launches (stages 1 and 3) {launches} ({card})")
    return out


# ---------------------------------------------------------------------------
# timing phase
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# FreqCodec phase
# ---------------------------------------------------------------------------

FREQ_PARAMS = {8: 9_932_201, 1: 9_418_793}  # encoder + decoder, both packages (tests/test_torch_freqcodec.py)
FREQ_B, FREQ_TIME_B, FREQ_SECONDS = 8, 64, 10.0
FREQ_FRAMES = 501  # 10 s: the center 512 / 160 STFT's 1,001 frames, the encoder's time stride 2
# (FUSED_STRIDE1 and FUSED_RESBLOCK, FUSED_RVQ) of each bf16 serving path
FREQ_PATHS = {"none": (False, False), "rvq": (False, True), "rvq+stride1+resblock": (True, True)}
FREQ_MAIN = "rvq+stride1+resblock"
# per request: the fused conv takes the 1D tail only (the encoder's ELU + 512 -> 128 k7, the
# decoder's 128 -> 512 k7); the 2D resblocks never reach the resblock kernel
FREQ_EXPECT = {
    "none": {"conv1d_s1": 0, "resblock_tgn": 0, "resblock_tgn_finalize": 0, "rvq_encode": 0},
    "rvq": {"conv1d_s1": 0, "resblock_tgn": 0, "resblock_tgn_finalize": 0, "rvq_encode": 1},
    FREQ_MAIN: {"conv1d_s1": 2, "resblock_tgn": 0, "resblock_tgn_finalize": 0, "rvq_encode": 1},
}
# one shared training step with both SEANet flags: the generator's encode and decode once
FREQ_TRAIN_EXPECT = {**FREQ_EXPECT[FREQ_MAIN], "rvq_encode": 0}
FREQ_TRAIN_B, FREQ_TRAIN_STEPS, FREQ_TIMED_STEPS = 16, 2, 2
# fp32 card against CPU: a differing code only where its two codewords' distances to the
# residual differ by at most this share of the residual's squared norm; the reconstruction
# of the same tokens within this relative L2
FREQ_NEAR_TIE, FREQ_RECON_REL = 1e-4, 1e-4
FREQ_DIR = OUT_DIR / "freq"


def _freq_flags(path: str) -> None:
    seanet, fused_rvq = FREQ_PATHS[path]
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = seanet
    rvq.FUSED_RVQ = fused_rvq


@contextlib.contextmanager
def _recorded_rvq_calls():
    """Record every rvq_encode wrapper call inside the block (quant/rvq.py
    calls rvq_kernel.rvq_encode_fused by name): [(x, embed, n_q)], x cloned."""
    calls, inner = [], rvq_kernel.rvq_encode_fused

    def wrapper(x, embed, n_q, **kwargs):
        calls.append((x.clone(), embed, n_q))
        return inner(x, embed, n_q, **kwargs)

    rvq_kernel.rvq_encode_fused = wrapper
    try:
        yield calls
    finally:
        rvq_kernel.rvq_encode_fused = inner


def _held_rvq(calls, what: str) -> float:
    """Each recorded rvq_encode call against its plain version on the same
    inputs (the flagship's agreement limits); the worst max|dquant| on
    agreeing rows. These launches are not counted."""
    worst = 0.0
    with torch.inference_mode():
        for i, (x, embed, n_q) in enumerate(calls):
            k_idx, k_quant = rvq_kernel.rvq_encode_fused(x, embed, n_q)
            r_idx, r_quant = rvq_kernel.rvq_encode_reference(x, embed, n_q)
            q0, all_, rows, err = _compare(k_idx, k_quant, r_idx, r_quant)
            log(f"[kernel] {what} rvq_encode call {i} x {tuple(x.shape)}: agree q0={q0:.6f} all={all_:.6f} "
                f"rows={rows:.6f} max|dquant| {err:.3e}")
            if q0 < MIN_AGREE_Q0 or all_ < MIN_AGREE_ALL or err > MAX_QUANT_ERR or not torch.isfinite(k_quant).all():
                raise RuntimeError(f"{what}: rvq_encode disagrees with its plain version")
            worst = max(worst, err)
    return worst


def build_freq(dev, gr: int, dtype: str, seed: int = 0):
    s2t = Speech2Token(freq_config(gr), None, dtype=dtype, device=dev)
    n = sum(p.numel() for p in s2t.model.parameters())
    if n != FREQ_PARAMS[gr]:
        raise RuntimeError(f"freq gr{gr}: {n} parameters, expected {FREQ_PARAMS[gr]}")
    return s2t


def _freq_output(what, codes, recon, batch, seconds):
    n = int(seconds * SR)
    frames = -(-(n // 160 + 1) // 2)
    if codes[0].shape != (32, batch, frames) or recon.shape != (batch, n):
        raise RuntimeError(f"freq {what}: tokens {codes[0].shape}, recon {recon.shape}")
    if not np.isfinite(recon).all() or codes[0].min() < 0 or codes[0].max() >= 1024:
        raise RuntimeError(f"freq {what}: non-finite recon or out-of-range tokens")


def freq_serving(dev, gr: int, s_bf, s_fp) -> dict:
    """B = 8 x 10 s requests on the three bf16 paths with exact launch counts;
    on the main path every kernel call of the requests against its plain
    version on its own inputs, and the first request served again: the same
    tokens, and a reconstruction that moves less than bf16 moves it from
    fp32 (cuDNN's transposed 2D convs may sum in another order from run to
    run); the flip rates against the fp32-exact path."""
    requests = [_speech(70 + i, FREQ_B, FREQ_SECONDS) for i in range(2)]
    _freq_flags("none")
    codes_fp, _, recon_fp, _ = s_fp(requests[0], bit_width=None)
    _freq_output(f"gr{gr} fp32", codes_fp, recon_fp, FREQ_B, FREQ_SECONDS)
    tokens, res = {}, {}
    for path in FREQ_PATHS:
        _freq_flags(path)
        with _recorded_seanet_calls() as seanet_calls, _recorded_rvq_calls() as rvq_calls:
            torch.cuda.synchronize()
            reset_counts()
            outs = []
            for i, x in enumerate(requests):
                before = read_counts()
                outs.append(s_bf(x, bit_width=None))
                per_request = {k: v - before[k] for k, v in read_counts().items()}
                if per_request != FREQ_EXPECT[path]:
                    raise RuntimeError(f"freq gr{gr} {path} request {i}: launches {per_request}, "
                                       f"expected {FREQ_EXPECT[path]}")
            counts = read_counts()
        for i, (codes, _, recon, _) in enumerate(outs):
            _freq_output(f"gr{gr} {path} request {i}", codes, recon, FREQ_B, FREQ_SECONDS)
        tokens[path] = outs[0][0][0]
        if path == FREQ_MAIN:
            if any(x.shape[-1] != FREQ_FRAMES for _, _, x, _, _ in seanet_calls):
                raise RuntimeError(f"freq gr{gr}: a conv1d_s1 call off T = {FREQ_FRAMES}")
            held = _held_calls(seanet_calls, f"freq gr{gr}")
            held["rvq_encode"] = _held_rvq(rvq_calls, f"freq gr{gr}")
            again = s_bf(requests[0], bit_width=None)
            token_diff = int((again[0][0] != outs[0][0][0]).sum())
            rerun, yard = _rel(again[2], outs[0][2]), _rel(outs[0][2], recon_fp)
            log(f"[freq] gr{gr} {path}: the first request served again: {token_diff} tokens differ; recon relative "
                f"L2 {rerun:.3e} from the first serving (bf16 vs fp32 {yard:.3e})")
            if token_diff or rerun > yard:
                raise RuntimeError(f"freq gr{gr}: the main path served the same request twice with different results")
            res.update(launches=counts, held_calls=len(seanet_calls) + len(rvq_calls), rerun_recon_rel_l2=rerun,
                       recon_bf16_vs_fp32_rel_l2=yard, max_abs_err={k: held[k] for k in ("conv1d_s1", "rvq_encode")})
        log(f"[freq] gr{gr} {path}: {len(requests)} requests of B={FREQ_B} x {FREQ_SECONDS} s, launches {counts} (per request "
            f"{FREQ_EXPECT[path]})")
    _freq_flags("none")
    res["flips_vs_fp32"] = {}
    for path in FREQ_PATHS:
        q0, all_ = _flips(tokens[path], codes_fp[0])
        res["flips_vs_fp32"][path] = {"q0": q0, "all": all_}
        if all_ > MAX_FLIP_ALL:
            raise RuntimeError(f"freq gr{gr}: bf16 {path} and fp32 disagree on {all_:.3f} of the tokens")
    q0, all_ = _flips(tokens[FREQ_MAIN], tokens["none"])
    res["flips_main_vs_none"] = {"q0": q0, "all": all_}
    log(f"[freq] gr{gr} main path: {res['held_calls']} kernel calls each within its limit of the plain version on "
        f"the same inputs (max|err| conv1d_s1 {res['max_abs_err']['conv1d_s1']:.3e}, rvq_encode "
        f"{res['max_abs_err']['rvq_encode']:.3e}); token flips fp32 vs bf16 "
        + ", ".join(f"{p} q0 {v['q0']:.5f} all {v['all']:.5f}" for p, v in res["flips_vs_fp32"].items())
        + f"; main vs none q0 {q0:.5f} all {all_:.5f}")
    return res


def freq_card_cpu(dev, gr: int, s_fp) -> dict:
    """fp32 on the card (TF32 off) against the CPU, same weights, one 2 s clip:
    tokens equal but at near-ties (_code_flips), and the decode of the CPU's
    tokens within FREQ_RECON_REL relative L2."""
    s_cpu = Speech2Token(freq_config(gr), None, dtype="float32", device="cpu")
    s_cpu.model.load_state_dict(s_fp.model.state_dict())
    _freq_flags("none")
    clip = _speech(98, 1, 2.0)
    with _rvq_calls() as card_calls:
        c_gpu, _, r_gpu, _ = s_fp(clip, bit_width=None)
    with _rvq_calls() as cpu_calls:
        c_cpu, _, r_cpu, _ = s_cpu(clip, bit_width=None)
    card_calls = [tuple(t.cpu() for t in c) for c in card_calls]
    flips, n, gap = _code_flips(card_calls, cpu_calls)
    btq = np.ascontiguousarray(np.transpose(c_cpu[0], (1, 2, 0)))
    d_gpu = s_fp(btq, run_mod="decode", bit_width=None)[2]
    d_cpu = s_cpu(btq, run_mod="decode", bit_width=None)[2]
    rel = _rel(d_gpu, d_cpu)
    log(f"[freq] gr{gr} fp32 card vs CPU on 2 s: {flips} of {n} codes differ (largest distance gap at a first "
        f"differing stage {gap:.3e} of the residual's squared norm, limit {FREQ_NEAR_TIE:.0e}); max|drecon| "
        f"{float(np.abs(r_gpu - r_cpu).max()):.3e}; the CPU tokens decoded on both: relative L2 {rel:.3e} "
        f"(limit {FREQ_RECON_REL:.0e})")
    if gap > FREQ_NEAR_TIE or rel > FREQ_RECON_REL or not np.isfinite(r_gpu).all():
        raise RuntimeError(f"freq gr{gr}: fp32 on the card disagrees with the CPU")
    return dict(code_flips=flips, codes=n, flip_gap=gap, decode_rel_l2=rel,
                recon_max_abs_diff=float(np.abs(r_gpu - r_cpu).max()))


def _peak_seconds(fn, dev) -> tuple:
    """(best of 3 wall seconds after a warm-up, fenced; peak device memory GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = timeit(fn, dev, warmup=1, iters=3)
    return t, torch.cuda.max_memory_allocated() / 2**30


def freq_conv_rows(dev, s_bf, card: str) -> list:
    """conv1d_s1 at the two FreqCodec shapes (B = 64, T = 501, the served
    model's own weights): held against the plain version, then timed
    against it and against cuDNN, beside the bound, and at T = 500 (rows
    16-byte aligned, where T = 501's are 2-byte aligned on every other
    channel) in the same call."""
    enc, dec = s_bf.model.encoder.model, s_bf.model.decoder.model
    layers = [ConvLayer("freq enc_last elu 512->128 k7", enc[len(enc) - 1], FREQ_TIME_B, FREQ_FRAMES, "elu",
                        torch.bfloat16, dev, 14),
              ConvLayer("freq dec_first 128->512 k7", dec[0], FREQ_TIME_B, FREQ_FRAMES, None, torch.bfloat16, dev, 15)]
    rows = []
    with torch.inference_mode():
        for layer in layers:
            err = _held("conv1d_s1", f"{layer.name} B={FREQ_TIME_B} T={FREQ_FRAMES}", layer.kernel(), layer.plain())
            even = ConvLayer(layer.name, layer.conv, FREQ_TIME_B, FREQ_FRAMES - 1, layer.act, torch.bfloat16, dev, 16)
            row = _row(layer.name, _cuda_ms(layer.kernel, 20), _cuda_ms(layer.plain, 5), layer.bound_ms(),
                       library_ms=_cuda_ms(layer.library, 20), max_abs_err=err, t_minus_1_ms=_cuda_ms(even.kernel, 20),
                       regime=conv_kernel.REGIMES[build.load().conv1d_s1_regime(
                           layer.x.shape[1], layer.w.shape[0], layer.spec.kernel_size, layer.spec.dilation,
                           layer.left, conv_kernel.DTYPES[layer.x.dtype], conv_kernel.VARIANTS["auto"])])
            rows.append(row)
            log(f"[freq] conv1d_s1 {layer.name} B={FREQ_TIME_B} T={FREQ_FRAMES}: kernel {row['ms']:.4f} ms "
                f"({row['regime']}; at T={FREQ_FRAMES - 1} {row['t_minus_1_ms']:.4f} ms), plain "
                f"{row['plain_ms']:.3f} ms, cuDNN {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}) ({card})")
    return rows


def freq_timing(dev, gr: int, s_bf, s_fp, card: str) -> dict:
    """B = 64 x 10 s encode + decode: fp32-exact and the three bf16 paths,
    best of 3 after a warm-up, with peak memory."""
    speech = torch.from_numpy(_speech(75, FREQ_TIME_B, FREQ_SECONDS)).to(dev)
    audio_s = FREQ_TIME_B * FREQ_SECONDS
    out = {}
    _freq_flags("none")
    runs = [("fp32-exact", "none", s_fp)] + [(f"bf16 {p}", p, s_bf) for p in FREQ_PATHS]
    for label, path, s2t in runs:
        _freq_flags(path)
        t, peak = _peak_seconds(lambda: s2t.dispatch(speech, bit_width=None), dev)
        out[label] = dict(seconds=t, audio_s_per_s=audio_s / t, peak_gib=peak)
        log(f"[freq] gr{gr} B={FREQ_TIME_B} x {FREQ_SECONDS} s encode+decode {label}: {audio_s / t:.1f} audio-s/s "
            f"({t * 1e3:.1f} ms), peak {peak:.2f} GiB ({card})")
    _freq_flags("none")
    return out


def freq_istft_row(dev, card: str) -> dict:
    """istft alone at the decode's shape: (64, 257, 1001) complex64 -> (64, 160,000)."""
    from funcodec_tpu_torch.ops.stft import istft

    gen = torch.Generator(device=dev).manual_seed(16)
    spec = torch.complex(torch.randn(64, 257, 1001, device=dev, generator=gen),
                         torch.randn(64, 257, 1001, device=dev, generator=gen))
    ms = _cuda_ms(lambda: istft(spec, 512, 160, length=160_000), 10)
    nbytes = spec.numel() * 8 + 64 * 160_000 * 4
    frames = 64 * 1001
    bound = _bound(nbytes, frames * (2.5 * 512 * math.log2(512) + 2 * 512), PEAK_FP32)
    log(f"[freq] istft (64, 257, 1001) -> (64, 160000): {ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}) ({card})")
    return dict(ms=ms, bound_ms=bound[0], bound_by=bound[1])


def freq_training(dev, card: str) -> dict:
    """gr8 with phase-invariant training and its MS-STFT discriminator: bf16
    shared steps at B = 16 x 2.56 s with both SEANet flags, exact launches
    and finite stats (pit_disc_loss among them) for FREQ_TRAIN_STEPS steps,
    then ms a step over FREQ_TIMED_STEPS more, and peak memory."""
    config = freq_config(8)
    config["model_conf"]["phase_invariant_training"] = True
    model, disc = build_codec_model(config, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    opts = [make_optimizer(lr=3e-4, betas=(0.5, 0.9)) for _ in range(2)]
    state = create_gan_train_state(model, disc, *opts)
    step = make_gan_train_step(model, disc, *opts, shared_forward=True, compute_dtype=torch.bfloat16)
    speech = _train_speech(dev, FREQ_TRAIN_B, seed=46)
    gen = torch.Generator(device=dev).manual_seed(9)
    _set_seanet_flags(True)
    before_d = [p.detach().clone() for p in disc.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stats = []
    for i in range(FREQ_TRAIN_STEPS):
        before = read_counts()
        state, s = step(state, {"speech": speech}, gen)
        per_step = {k: v - before[k] for k, v in read_counts().items()}
        if per_step != FREQ_TRAIN_EXPECT:
            raise RuntimeError(f"freq training step {i}: launches {per_step}, expected {FREQ_TRAIN_EXPECT}")
        stats.append(_floats(s))
    counts = read_counts()
    if not stats[0].get("pit_disc_loss", 0.0) > 0 or not any(
            not torch.equal(a, p) for a, p in zip(before_d, disc.parameters())):
        raise RuntimeError("freq training: no positive pit_disc_loss on the first step (its disc turn runs "
                           "ungated), or the discriminator did not move")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FREQ_TIMED_STEPS):
        state, _ = step(state, {"speech": speech}, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / FREQ_TIMED_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    _set_seanet_flags(False)
    log(f"[freq] training gr8 PIT, bf16 shared_train_step, both SEANet flags, B={FREQ_TRAIN_B} x {TRAIN_SECONDS} s: "
        f"{FREQ_TRAIN_STEPS} steps, launches {counts} (per step {FREQ_TRAIN_EXPECT}), stats finite (step 0: "
        f"generator_loss {stats[0]['generator_loss']:.4f}, discriminator_loss {stats[0]['discriminator_loss']:.4f}, "
        f"pit_disc_loss {stats[0]['pit_disc_loss']:.4f}); {ms:.1f} ms a step over {FREQ_TIMED_STEPS} more "
        f"({FREQ_TRAIN_B * TRAIN_SECONDS / ms * 1e3:.1f} training audio-s/s), peak {peak:.2f} GiB ({card})")
    return dict(launches=counts, stats=stats, ms_per_step=ms, peak_gib=peak)


def freq_cli(dev, s_fp) -> dict:
    """cli/codec_inference.main on 4 seeded utterances of 1-3 s: bf16 encode on
    the main path (one conv1d_s1 a batch; the encode mode's token search is
    the greedy fp32 scan, not rvq_encode), then decode of its codecs.txt (one
    conv1d_s1 a batch); the frames the CLI writes (ceil(n / 320), its hop)
    and the decoded lengths (320 a frame, less the ISTFT's 160 for the
    longest of a batch; the CLI cuts the others at 320 a frame)."""
    FREQ_DIR.mkdir(parents=True, exist_ok=True)
    import yaml

    (FREQ_DIR / "config.yaml").write_text(yaml.safe_dump(freq_config(8)))
    torch.save(s_fp.model.state_dict(), FREQ_DIR / "model.pth")
    want = _write_corpus(FREQ_DIR, (1.0, 1.4375, 2.5625, 3.0), SR, 77)
    common = ["--config_file", str(FREQ_DIR / "config.yaml"), "--model_file", str(FREQ_DIR / "model.pth"),
              "--batch_size", "2", "--bit_width", "16000", "--dtype", "bfloat16", "--device", str(dev)]
    _freq_flags(FREQ_MAIN)
    reset_counts()
    cli.main(["--output_dir", str(FREQ_DIR / "enc"), "--run_mod", "encode", "--data_path_and_name_and_type",
              f"{FREQ_DIR / 'wav.scp'},speech,sound", *common])
    enc_counts = read_counts()
    reset_counts()
    cli.main(["--output_dir", str(FREQ_DIR / "dec"), "--run_mod", "decode", "--data_path_and_name_and_type",
              f"{FREQ_DIR / 'enc' / 'codecs.txt'},speech,codec_json", *common])
    dec_counts = read_counts()
    _freq_flags("none")
    batches = 2
    expect = {"conv1d_s1": batches, "resblock_tgn": 0, "resblock_tgn_finalize": 0, "rvq_encode": 0}
    if enc_counts != expect or dec_counts != expect:
        raise RuntimeError(f"freq cli: launches encode {enc_counts}, decode {dec_counts}")
    codes = _codecs(FREQ_DIR / "enc" / "codecs.txt")
    for key, n in want.items():
        frames = -(-n // 320)
        if codes[key].shape != (32, frames):
            raise RuntimeError(f"freq cli: {key} tokens {codes[key].shape}, expected (32, {frames})")
        sr, wav = read_wav(FREQ_DIR / "dec" / f"{key}.wav", normalize=False)
        if sr != SR or not frames * 320 - 160 <= wav.shape[0] <= frames * 320:
            raise RuntimeError(f"freq cli: {key}.wav has {wav.shape[0]} samples at {sr} Hz")
    log(f"[freq] cli/codec_inference: 4 utterances of 1-3 s, bf16 encode on the main path (launches {enc_counts}) "
        f"then decode of codecs.txt (launches {dec_counts}); tokens (1, 32, ceil(n / 320)) and wavs of "
        f"320 x frames (- 160) samples")
    return dict(encode_launches=enc_counts, decode_launches=dec_counts)


def freq_phase(dev, card: str) -> dict:
    """FreqCodec gr8 and gr1 at full width, seeded weights: serving, fp32 card
    against CPU, timing, conv1d_s1 at T = 501, istft, training, the CLI."""
    t0 = time.perf_counter()
    res = {"serving": {}, "card_vs_cpu": {}, "timing": {}}
    for gr in (8, 1):
        s_bf, s_fp = build_freq(dev, gr, "bfloat16"), build_freq(dev, gr, "float32")
        if not torch.equal(s_fp.model.quantizer.state.embed, s_bf.model.quantizer.state.embed):
            raise RuntimeError(f"freq gr{gr}: the fp32 and bf16 models were not built with the same weights")
        log(f"[freq] gr{gr}: {FREQ_PARAMS[gr]} parameters (encoder + decoder), 32 x 1024 codebooks")
        res["serving"][gr] = freq_serving(dev, gr, s_bf, s_fp)
        res["card_vs_cpu"][gr] = freq_card_cpu(dev, gr, s_fp)
        if gr == 8:
            res["conv_rows"] = freq_conv_rows(dev, s_bf, card)
            res["cli"] = freq_cli(dev, s_fp)
        res["timing"][gr] = freq_timing(dev, gr, s_bf, s_fp, card)
        del s_bf, s_fp
        torch.cuda.empty_cache()
    res["istft"] = freq_istft_row(dev, card)
    res["training"] = freq_training(dev, card)
    torch.cuda.empty_cache()
    res["launches"] = {k: sum(r["launches"][k] for r in res["serving"].values()) for k in COUNTERS}
    res["max_abs_err"] = {k: max(r["max_abs_err"][k] for r in res["serving"].values())
                          for k in ("conv1d_s1", "rvq_encode")}
    log(f"[freq] phase wall {time.perf_counter() - t0:.1f} s; main-path launches over both models' requests "
        f"{res['launches']}")
    return res


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


def _ab_ms(new, old, iters: int):
    """(new ms, old ms, the four readings): new, old, old, new in turns; each the mean of the two."""
    t = [_cuda_ms(fn, iters) for fn in (new, old, old, new)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def _ab_text(ab) -> str:
    return " / ".join(f"{v:.4f}" for v in ab[2])


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
    rvq_ab = _ab_ms(lambda: rvq_kernel.rvq_encode_fused(x, embed, 32),
                    lambda: rvq_kernel.rvq_encode_fused(x, embed, 32, variant="legacy"), 10)
    rvq_ms = rvq_ab[0]
    N, n_q, bins, D = 32_000, 32, 1024, 128
    rvq_bound = _bound(N * D * 2 + n_q * bins * (D * 2 + 4) + n_q * N * 4 + N * D * 4,
                       2.0 * N * n_q * bins * D, PEAK_BF16)
    rvq_row = _row("rvq_encode N=32000 n_q=32", rvq_ms, rvq_plain, rvq_bound, library_ms=None, legacy_ms=rvq_ab[1])
    log(f"[time] rvq_encode N=32000 n_q=32: kernel {rvq_ms:.3f} ms (wgmma; new, old, old, new: "
        f"{_ab_text(rvq_ab)}), the first, CUDA-core version {rvq_ab[1]:.3f} ms, plain torch {rvq_plain:.3f} ms, "
        f"bound {rvq_bound[0]:.3f} ms ({rvq_bound[1]}) ({card})")

    heads, rb_convs, resblocks = calls
    conv_rows, rb_rows = [], []
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = False
    with torch.inference_mode():
        for layer in heads + rb_convs:
            ab = _ab_ms(layer.kernel, layer.legacy, 10)
            row = _row(layer.name, ab[0], _cuda_ms(layer.plain, 5), layer.bound_ms(),
                       library_ms=_cuda_ms(layer.library, 10), legacy_ms=ab[1], main_path=layer in heads,
                       regime=conv_kernel.REGIMES[build.load().conv1d_s1_regime(
                           layer.x.shape[1], layer.w.shape[0], layer.spec.kernel_size, layer.spec.dilation,
                           layer.left, conv_kernel.DTYPES[layer.x.dtype], conv_kernel.VARIANTS["auto"])])
            conv_rows.append(row)
            log(f"[time] conv1d_s1 {layer.name} B={layer.x.shape[0]} T={layer.x.shape[-1]}: kernel "
                f"{row['ms']:.4f} ms ({row['regime']}; new, old, old, new: {_ab_text(ab)}), the first version "
                f"{row['legacy_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, cuDNN {row['library_ms']:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}){_shares(row, ceiling)} ({card})")
        for call in resblocks:
            ab = _ab_ms(call.kernel, call.legacy, 5)
            row = _row(call.name, ab[0], _cuda_ms(call.plain, 3), call.bound_ms(),
                       library_ms=None, unfused_ms=_cuda_ms(call.unfused, 5), legacy_ms=ab[1])
            rb_rows.append(row)
            log(f"[time] resblock_tgn {call.name} B={call.x.shape[0]}: kernel {row['ms']:.3f} ms "
                f"(3 passes + 2 finalizes; new, old, old, new: {_ab_text(ab)}), the first version "
                f"{row['legacy_ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, unfused block {row['unfused_ms']:.3f} ms, "
                f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}){_shares(row, ceiling)} ({card})")

        part, aff, T, pairs = _finalize_case(dev, resblocks[0])
        fin_row = _row(f"resblock_tgn_finalize {tuple(part.shape)}, 2 affines",
                       _cuda_ms(lambda: resblock_kernel.launch_resblock_finalize(part, aff, T, pairs), 20),
                       _cuda_ms(lambda: _finalize_plain(part, aff, T, pairs), 5),
                       _bound(part.numel() * 8 + 4 * aff.shape[0] * 48 * 4, 4.0 * part.numel(), PEAK_FP32),
                       library_ms=None)
        log(f"[time] {fin_row['name']}: kernel {fin_row['ms']:.4f} ms, plain {fin_row['plain_ms']:.4f} ms, "
            f"bound {fin_row['bound_ms']:.5f} ms ({fin_row['bound_by']}) ({card})")

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
    return rvq_row, conv_rows, rb_rows, fin_row, serving


def _summed(rows, n=1):
    """One JSON entry's numbers from per-shape rows, each shape run n times per request."""
    keys = ("ms", "plain_ms", "bound_ms")
    out = {k: n * sum(r[k] for r in rows) for k in keys}
    by = {b: sum(r["bound_ms"] for r in rows if r["bound_by"] == b) for b in ("bytes", "operations")}
    out["bound_by"] = max(by, key=by.get)
    return out


PROFILE_FAMILIES = {
    "resblock_tgn": ("resblock_tgn_persistent", "resblock_tgn_streamed", "resblock_tgn_kernel"),
    "resblock_tgn_finalize": ("resblock_tgn_finalize",),
    "rvq_encode": ("rvq_encode",),
    "conv1d_s1": ("conv1d_s1",),
    "cufft": ("fft",),  # the STFT / ISTFT's kernels
}
# operators whose device time (every kernel they launch) is summed by name
PROFILE_OPS = {
    "cuDNN convolutions (forward and transposed)": ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose"),
    "group norm": ("aten::native_group_norm",),
    "reflect pad": ("aten::reflection_pad1d", "aten::reflection_pad2d"),
    "dtype and layout copies": ("aten::copy_",),
    "cuDNN LSTM": ("aten::_cudnn_rnn",),
}


def _profiled(run, what: str, tag: str) -> None:
    """torch.profiler over one run(): the table of device time by kernel, the
    fused kernels summed over their template instances, the idle share."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device_events) / 1e3
    averages = prof.key_averages()
    table = averages.table(sort_by="self_device_time_total", row_limit=30)
    for family, names in PROFILE_FAMILIES.items():  # one kernel's template instances, summed
        rows = [e for e in device_events if any(n in e.name for n in names)]
        if rows:
            ms = sum(e.self_device_time_total for e in rows) / 1e3
            log(f"[profile] {what}: {family}: {ms:.2f} ms in {len(rows)} launches, "
                f"{ms / max(busy, 1e-9):.3f} of the device kernel time")
    for label, ops in PROFILE_OPS.items():
        rows = [e for e in averages if e.key in ops]
        if rows:
            ms = sum(e.self_device_time_total for e in rows) / 1e3
            log(f"[profile] {what}: {label}: {ms:.2f} ms in {sum(e.count for e in rows)} calls, "
                f"{ms / max(busy, 1e-9):.3f} of the device kernel time")
    (OUT_DIR / f"profile_{tag}.txt").write_text(table)
    log(f"[profile] {what}: wall {wall * 1e3:.1f} ms, {len(device_events)} device kernels, {busy:.1f} ms of device "
        f"kernel time, idle share "
        f"{max(0.0, 1 - busy / (wall * 1e3)):.3f}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({card_line(CARD)})")
    log(table)


def profile(dev) -> None:
    """torch.profiler over one B = 64 x 10 s request of each bf16 path, then
    over one bf16 shared training step at B = 16 x 2.56 s without and with
    the fused SEANet kernels."""
    _, s_bf, _ = build_models(dev)
    speech = torch.from_numpy(_speech(5, 64, 10.0)).to(dev)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for path in ("unfused", MAIN_PATH):
        set_flags(path)
        for _ in range(2):
            s_bf.dispatch(speech, bit_width=None)
        _profiled(lambda: s_bf.dispatch(speech, bit_width=None), path, path)
    del s_bf, speech
    torch.cuda.empty_cache()
    for fused in (False, True):
        _set_seanet_flags(fused)
        state, step = build_trainer(dev, True, torch.bfloat16, **STEADY)
        batch = {"speech": _train_speech(dev, TRAIN_B, seed=43)}
        gen = torch.Generator(device=dev).manual_seed(8)
        for _ in range(2):
            state, _ = step(state, batch, gen)
        tag = "train_bf16_shared" + ("_fused" if fused else "")
        _profiled(lambda: step(state, batch, gen), f"bf16 shared_train_step B={TRAIN_B}{' fused' if fused else ''}",
                  tag)
        del state, step
        torch.cuda.empty_cache()
    _set_seanet_flags(False)
    tts_profile(dev)
    s_freq = build_freq(dev, 8, "bfloat16")
    speech = torch.from_numpy(_speech(75, FREQ_TIME_B, FREQ_SECONDS)).to(dev)
    _freq_flags(FREQ_MAIN)
    for _ in range(2):
        s_freq.dispatch(speech, bit_width=None)
    _profiled(lambda: s_freq.dispatch(speech, bit_width=None), f"FreqCodec gr8 bf16 {FREQ_MAIN} B={FREQ_TIME_B}",
              "freqcodec_gr8_bf16")
    _freq_flags("none")
    laura_profile(dev)


def laura_profile(dev) -> None:
    """torch.profiler over one bf16 Laura training step at full width and about batch_bins 10240 (20
    utterances of 96 phonemes and 400 codec frames, seeded), after two warm-up steps."""
    import yaml

    from funcodec_tpu_torch.tasks.text2audio import build_laura_model
    from funcodec_tpu_torch.train.laura_trainer import LauraTrainer, LauraTrainerOptions

    config = yaml.safe_load(TTS_YAML.read_text())
    tokens = [t.strip() for t in LAURA_TOKENS.read_text().splitlines() if t.strip()]
    model = build_laura_model(config, token_list=tokens, device=dev)
    trainer = LauraTrainer(model, LauraTrainerOptions(train_dtype="bfloat16"))
    state = trainer.init_state()
    rs = np.random.RandomState(63)
    B, Lt, Lc = 20, 96, 400
    batch = trainer.to_device(dict(text=rs.randint(2, len(tokens), (B, Lt)), text_lengths=np.full(B, Lt),
                                   codec=rs.randint(0, 1024, (B, Lc, 32)), codec_lengths=np.full(B, Lc)))
    gen = torch.Generator(device=dev)

    def step():
        nonlocal state
        state, _ = trainer.train_step(state, batch, gen.manual_seed(state.step))

    for _ in range(2):
        step()
    _profiled(step, f"Laura bf16 training step, B={B} x (text {Lt}, codec {Lc})", "laura_train_bf16")


def tts_profile(dev) -> None:
    """torch.profiler over one 25-step segment of a 16-slot LauraTTS session
    (text 40, greedy) in fp32 and bf16, after admission and a warm segment."""
    import copy

    from funcodec_tpu_torch.models.tts_serving import LauraServingSession

    codec_fp = Speech2Token(_flagship_config(), None, dtype="float32", device=dev)
    _, _, model = build_tts(dev, codec_fp)
    del codec_fp
    rs = np.random.RandomState(55)
    texts = [_tts_text(rs, 40) for _ in range(16)]
    for dtype in ("float32", "bfloat16"):
        m = model if dtype == "float32" else copy.deepcopy(model).to(torch.bfloat16)
        sess = LauraServingSession(m, num_slots=16, max_new=250, prefix_budget=42, sampling=False, segment_steps=25)
        for i, t in enumerate(texts):
            sess.submit(f"u{i}", t, i)
        sess.poll()
        sess.poll()
        _profiled(sess.poll, f"tts session segment, 16 slots x 25 steps, {dtype}", f"tts_session_{dtype}")
        del sess, m
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# data-parallel phase
# ---------------------------------------------------------------------------

DP_DIR = OUT_DIR / "dp"
DP_STEPS = 3  # checked steps of each GAN run
DP_TIMED = 3  # steps timed after them
DP_W1_TIMED = 6  # steady steps timed at world 1, with and without the group
DP_LAURA_STEPS = 2
DP_LAURA_B, DP_LAURA_TEXT, DP_LAURA_CODEC = 8, 64, 200
DP_RTOL, DP_ATOL = 2e-4, 2e-5  # tests/test_dp_exactness.py's tolerance
# world 2 against world 1 trains with SGD, as tests/test_dp_exactness.py does: Adam turns
# the sign of a near-zero gradient's rounding noise into a step of its whole rate. Its
# quantizer is STEADY (initialized codebooks; the recipe's dropout and expiry draws): at
# 1024 codes over B x 128 frames, k-means init forks on near-ties that the latents'
# rounding (B = 8 against 16) flips; its global draws are held exactly by
# tests/test_torch_dp.py on the CPU, and world 1 through NCCL runs it bit for bit
DP_OPTIM = "sgd"
DP_SERVE_REQUESTS = 2
DP_RANKS_TIMEOUT_S = 600


class ScanCodes:
    """Inside `with`, the codes of every nearest-codeword search of RVQ
    training (quant/rvq.py calls nearest_codebook_indices by name: the EMA
    scan's layers, k-means' Lloyd iterations) go to `codes`, (N,) int32 on
    the host. With `forced` (such a list, over the global rows), the i-th
    search returns forced[i] in place of its own, and `flips` and `gap`
    count its own codes that differ and the largest distance gap at one of
    them in fp64, |d(x, e_forced) - d(x, e_own)| over the scale of the
    fp32 distances, (|x| + max(|e_forced|, |e_own|))^2 (a deep layer's
    residual is far shorter than its codewords)."""

    def __init__(self, forced=None):
        self.forced, self.codes, self.flips, self.gap = forced, [], 0, 0.0
        self._inner = None

    def _search(self, x, embed):
        own = self._inner(x, embed)
        if self.forced is None:
            self.codes.append(own.cpu())
            return own
        f = self.forced[len(self.codes)].to(own.device)
        self.codes.append(f)
        differ = (own != f).nonzero().flatten()
        if differ.numel():
            xs = x[differ].double()
            e_f, e_o = embed[f[differ].long()].double(), embed[own[differ].long()].double()
            d_f, d_o = ((xs - e_f) ** 2).sum(-1), ((xs - e_o) ** 2).sum(-1)
            scale = (xs.norm(dim=-1) + torch.maximum(e_f.norm(dim=-1), e_o.norm(dim=-1))) ** 2
            self.flips += differ.numel()
            self.gap = max(self.gap, float(((d_f - d_o).abs() / scale.clamp_min(1e-30)).max()))
        return f

    def __enter__(self):
        self._inner, rvq.nearest_codebook_indices = rvq.nearest_codebook_indices, self._search
        return self

    def __exit__(self, *exc):
        rvq.nearest_codebook_indices = self._inner


def dp_gan(dev, dtype, speech, group=None, timed: int = 0, record: bool = False, optim: str = "adam",
           scan=None, **quantizer):
    """DP_STEPS shared steps of the flagship with both SEANet flags (the
    recipe's quantizer unless `quantizer` overrides it, the yaml's Adam
    unless `optim`) on `speech` (this rank's rows), step i drawing from
    step_generator(dev, 0, i), each step's launches TRAIN_EXPECT, inside
    the context `scan` (a ScanCodes); then `timed` more steps, timed.
    Returns (the state's tensors on the host after the checked steps (as
    _gan_tensors), their stats, ms a timed step or None, the first step's
    SEANet kernel calls when `record`)."""
    expect = TRAIN_EXPECT
    _set_seanet_flags(True)
    state, step = build_trainer(dev, True, dtype, group=group, optim=optim, **quantizer)
    stats, calls = [], []
    with scan or contextlib.nullcontext():
        for i in range(DP_STEPS):
            before = read_counts()
            with (_recorded_seanet_calls() if record and i == 0 else contextlib.nullcontext([])) as rec:
                state, s = step(state, {"speech": speech}, step_generator(dev, 0, i))
            calls += rec
            launched = {k: v - before[k] for k, v in read_counts().items()}
            if launched != expect:
                raise RuntimeError(f"dp step {i} ({group.backend if group else 'no group'}): launches {launched}, "
                                   f"expected {expect}")
            stats.append(_floats(s))
    checked = _gan_tensors(state)
    ms = None
    if timed:
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(DP_STEPS, DP_STEPS + timed):
            state, _ = step(state, {"speech": speech}, step_generator(dev, 0, i))
        _sync(dev)
        ms = (time.perf_counter() - t0) / timed * 1e3
    _set_seanet_flags(False)
    return checked, stats, ms, calls


def _gan_tensors(state) -> dict:
    """The generator's (codebooks included) and the discriminator's state, on the host."""
    return {**{f"model.{k}": v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
            **{f"disc.{k}": v.detach().cpu().clone() for k, v in state.discriminator.state_dict().items()}}


def _same_on_ranks(tensors, group) -> bool:
    """Whether every rank holds rank 0's tensors bit for bit: their bytes in
    one buffer, rank 0's broadcast and compared."""
    mine = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors])
    theirs = mine.clone()
    torch.distributed.broadcast(theirs, 0)
    return bool(torch.equal(mine, theirs))


def _dp_close(got: dict, want: dict, what: str) -> dict:
    """Each tensor of `got` within DP_RTOL / DP_ATOL of `want`'s: element by
    element, but each codeword of the codebook sums and codebooks (``embed``,
    ``embed_avg``) as one vector, ||g - w|| <= DP_ATOL sqrt(D) + DP_RTOL ||w||:
    a codeword of norm 70-590 carries its latents' rounding (about 1e-6 of
    its norm between B = 8 and B = 16 on the card) into entries that cancel
    to 1e-4 of it. Returns {"parameters", "codebooks"}: the largest share of
    the tolerance."""
    worst = {"parameters": 0.0, "codebooks": 0.0}
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        if not w.numel():
            continue
        if k.endswith(("rq.model.embed", "rq.model.embed_avg")):
            r = float(((g - w).norm(dim=-1) / (DP_ATOL * w.shape[-1] ** 0.5 + DP_RTOL * w.norm(dim=-1))).max())
        else:
            r = float(((g - w).abs() / (DP_ATOL + DP_RTOL * w.abs())).max())
        if not r <= 1.0:
            raise RuntimeError(f"{what} {k}: {r:.3f} of the tolerance (rtol {DP_RTOL}, atol {DP_ATOL})")
        part = "codebooks" if ".rq.model." in k else "parameters"
        worst[part] = max(worst[part], r)
    return worst


def _dp_stats_close(got, want, what: str) -> float:
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            r = abs(g[k] - w[k]) / (DP_ATOL + DP_RTOL * abs(w[k]))
            if not r <= 1.0:
                raise RuntimeError(f"{what} step {i} {k}: {g[k]} against {w[k]}")
            worst = max(worst, r)
    return worst


def _dp_laura_batch(n_tokens: int) -> dict:
    """DP_LAURA_B seeded rows (token-id text, 32-group codec) of ragged
    lengths, so that the ranks' halves hold unequal token counts."""
    rs = np.random.RandomState(66)
    return dict(text=rs.randint(2, n_tokens, (DP_LAURA_B, DP_LAURA_TEXT)),
                text_lengths=rs.randint(DP_LAURA_TEXT // 2, DP_LAURA_TEXT + 1, DP_LAURA_B),
                codec=rs.randint(0, 1024, (DP_LAURA_B, DP_LAURA_CODEC, 32)),
                codec_lengths=rs.randint(DP_LAURA_CODEC // 2, DP_LAURA_CODEC + 1, DP_LAURA_B))


def dp_laura(dev, group=None):
    """DP_LAURA_STEPS fp32 Laura trainer steps at full width (the shipped
    yaml, the recipe's token list, seeded weights; SGD at lr 1e-2 with clip
    5, as tests/test_dp_exactness.py's Laura run) on _dp_laura_batch,
    bucketed whole and cut to this rank's rows. Returns (state, stats, this
    rank's codec tokens)."""
    import yaml

    from funcodec_tpu_torch.tasks.text2audio import build_laura_model
    from funcodec_tpu_torch.train.laura_trainer import LauraTrainer, LauraTrainerOptions

    tokens = [t.strip() for t in LAURA_TOKENS.read_text().splitlines() if t.strip()]
    model = build_laura_model(yaml.safe_load(TTS_YAML.read_text()), token_list=tokens, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(0))
    options = LauraTrainerOptions(optim=DP_OPTIM, optim_conf={"lr": 1e-2}, scheduler=None, grad_clip=5.0)
    trainer = LauraTrainer(model, options, group=group)
    state = trainer.init_state()
    host = _dp_laura_batch(len(tokens))
    stats = []
    for i in range(DP_LAURA_STEPS):
        batch = trainer.to_device(host)
        state, s = trainer.train_step(state, batch, step_generator(dev, 0, i))
        stats.append(_floats(s))
    return state, stats, int(batch["codec_lengths"].sum())


def _dp_rank(rank: int, world: int, init_method: str, device: str, out_dir: str) -> None:
    """One rank of the phase's gloo group, all on one card (NCCL refuses two
    ranks on one device; gloo moves CUDA tensors through the host). fp32
    with TF32 off: the flagship's GAN steps (SGD, initialized codebooks)
    on its half of the batch with its codebook searches' codes recorded,
    its kernel calls held against their plain versions, then the Laura
    steps; rank 0 saves the states, every rank its codes and numbers."""
    from funcodec_tpu_torch.parallel import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    group = dist.init_process_group(dev, init_method=init_method, world_size=world, rank=rank, backend="gloo",
                                    timeout_s=DP_RANKS_TIMEOUT_S)
    try:
        speech = dist.local_rows(_train_speech(dev, TRAIN_B), group)
        reset_counts()
        scan = ScanCodes()
        gan, stats, ms, calls = dp_gan(dev, None, speech, group=group, timed=DP_TIMED, record=True, optim=DP_OPTIM,
                                       scan=scan, **STEADY)
        counts = read_counts()
        held = _held_calls(calls, f"dp rank {rank}")
        same_gan = _same_on_ranks(list(gan.values()), group)
        if rank == 0:
            torch.save(gan, Path(out_dir) / "gan_rank0.pt")
        torch.save(scan.codes, Path(out_dir) / f"codes_rank{rank}.pt")
        del calls, gan
        torch.cuda.empty_cache()
        lstate, lstats, ltokens = dp_laura(dev, group)
        laura = {k: v.detach().cpu().clone() for k, v in lstate.model.state_dict().items()}
        same_laura = _same_on_ranks(list(laura.values()), group)
        if rank == 0:
            torch.save(laura, Path(out_dir) / "laura_rank0.pt")
        result = dict(rank=rank, rows=int(speech.shape[0]), stats=stats, ms=ms, launches=counts, held=held,
                      same_gan=same_gan, laura_stats=lstats, same_laura=same_laura, laura_tokens=ltokens,
                      jax_imported="jax" in sys.modules or "funcodec_tpu" in sys.modules)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group(group)


def _dp_world1(rank: int, world: int, init_method: str, device: str, out_dir: str) -> None:
    """World 1 through NCCL against no group, in a process of its own with
    torch's deterministic algorithms (cuBLAS' fixed workspace comes from the
    parent's environment; warn_only: reflection_pad1d's backward has no
    deterministic version, and its atomics add at most two terms an
    element, which commute): otherwise the bf16 step's backward is not
    bit-reproducible from run to run, with or without a group. The bf16
    shared steps with both SEANet flags and the recipe's quantizer,
    launches exact, first without a group, then with; saves what it
    found."""
    from funcodec_tpu_torch.parallel import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device(device)
    speech = _train_speech(dev, TRAIN_B, seed=47)
    ref_tensors, ref_stats, _, _ = dp_gan(dev, torch.bfloat16, speech)
    group = dist.init_process_group(dev, init_method=init_method, world_size=world, rank=rank)
    try:
        reset_counts()
        got, stats, _, _ = dp_gan(dev, torch.bfloat16, speech, group=group)
        _sync(dev)
        counts = read_counts()
        differ = [k for k in ref_tensors if not torch.equal(ref_tensors[k], got[k])]
        result = dict(backend=group.backend, launches=counts, n_tensors=len(ref_tensors), differ=differ,
                      stats_equal=stats == ref_stats, cublas_workspace=os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
                      generator_values=sum(v.numel() for k, v in ref_tensors.items() if k.startswith("model.")),
                      jax_imported="jax" in sys.modules or "funcodec_tpu" in sys.modules)
        (Path(out_dir) / "world1.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group(group)


def _replica_packs(s2t) -> list:
    """Per replica: the data_ptr of its first fused conv's packed weight, of
    its first resblock pack and of its prepared codebooks (None where absent)."""
    out = []
    for m in s2t.replicas:
        conv = next((p._conv1d_s1_pack[1]["w"].data_ptr() for p in m.parameters() if hasattr(p, "_conv1d_s1_pack")),
                    None)
        rb = next((mod._resblock_pack[1]["w1"].data_ptr() for mod in m.modules() if hasattr(mod, "_resblock_pack")),
                  None)
        hit = rvq_kernel._PREPARED.get(id(m.quantizer.state.embed))
        out.append((conv, rb, None if hit is None else hit[2]["arranged"].data_ptr()))
    return out


def _merged_rvq_calls(calls):
    """The replicas' recorded RVQ calls of one request as one call (rows joined)."""
    return [(torch.cat([c[0] for c in calls]), torch.cat([c[1] for c in calls], dim=1), calls[0][2])]


def dp_serving(dev, config) -> dict:
    """Speech2Token with two replicas on one card against one replica on
    B = 8 x 10 s requests: fp32-exact tokens equal; bf16 on the main path
    with FUSED_RVQ, exact launches (each replica a request's, on its 4
    rows), the first request's kernel calls held against their plain
    versions, codes that differ only at near-ties (_code_flips, VALID_REL),
    and each replica's own packed weights and prepared codebooks."""
    requests = [_speech(80 + i, 8, 10.0) for i in range(DP_SERVE_REQUESTS)]
    res = {}
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = rvq.FUSED_RVQ = False
    one, two = (Speech2Token(config, None, dtype="float32", device=dev),
                Speech2Token(config, None, dtype="float32", data_parallel=2, devices=[dev, dev]))
    for i, x in enumerate(requests):
        a, b = one(x, bit_width=None), two(x, bit_width=None)
        if not np.array_equal(a[0][0], b[0][0]) or a[2].shape != b[2].shape:
            raise RuntimeError(f"dp serving fp32 request {i}: two replicas' tokens differ from one replica's")
    res["fp32_recon_max_abs_diff"] = float(np.abs(a[2] - b[2]).max())
    del one, two
    one, two = (Speech2Token(config, None, dtype="bfloat16", device=dev),
                Speech2Token(config, None, dtype="bfloat16", data_parallel=2, devices=[dev, dev]))
    set_flags(MAIN_PATH)
    one(requests[0], bit_width=None)  # packs built
    flips = n_codes = 0
    gap = 0.0
    counts = dict.fromkeys(COUNTERS, 0)  # the two replicas' requests
    for i, x in enumerate(requests):
        with _rvq_calls() as c1:
            a = one(x, bit_width=None)
        _sync(dev)
        reset_counts()
        with _rvq_calls() as c2, (_recorded_seanet_calls() if i == 0 else contextlib.nullcontext([])) as sc, \
                (_recorded_rvq_calls() if i == 0 else contextlib.nullcontext([])) as rc:
            b = two(x, bit_width=None)
        launched = read_counts()
        if i == 0:
            held = _held_calls(sc, "dp replica")
            held["rvq_encode"] = _held_rvq(rc, "dp replica")
            del sc, rc
        counts = {k: counts[k] + launched[k] for k in counts}
        want = {k: 2 * v for k, v in EXPECT[MAIN_PATH].items()}
        if launched != want or len(c2) != 2:
            raise RuntimeError(f"dp serving bf16 request {i}: launches {launched} over {len(c2)} replica calls, "
                               f"expected {want} over 2")
        _check_output(f"dp serving request {i}", b[0], b[2], 32)
        n_f, n, g = _code_flips(c1, _merged_rvq_calls(c2))
        flips, n_codes, gap = flips + n_f, n_codes + n, max(gap, g)
    packs = _replica_packs(two)
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = rvq.FUSED_RVQ = False
    if any(p is None for pk in packs for p in pk) or any(x == y for x, y in zip(*packs)):
        raise RuntimeError(f"dp serving: the replicas' packed weights / prepared codebooks {packs} are missing or "
                           "shared")
    if gap > VALID_REL:
        raise RuntimeError(f"dp serving: {flips} of {n_codes} bf16 codes differ between one and two replicas, "
                           f"the largest distance gap {gap:.3e} is past {VALID_REL:.0e}")
    log(f"[dp] Speech2Token(data_parallel=2, devices=[{dev}, {dev}]) on {DP_SERVE_REQUESTS} requests of B=8 x 10 s: "
        f"fp32-exact tokens equal to one replica's (recon max|diff| {res['fp32_recon_max_abs_diff']:.3e}); bf16 main "
        f"path with FUSED_RVQ: launches {counts} (each replica a request's on its 4 rows), {flips} of {n_codes} codes "
        f"differ from one replica's (largest distance gap {gap:.3e}, limit {VALID_REL:.0e}); the first request's "
        f"kernel calls against their plain versions: max|err| {held}; each replica its own packed weights and "
        f"prepared codebooks")
    res.update(launches=counts, code_flips=flips, codes=n_codes, flip_gap=gap, max_abs_err=held)
    return res


def _allreduce_ms(params, group, iters: int = 20) -> float:
    """ms of one all_reduce_mean of gradients shaped like `params`."""
    from funcodec_tpu_torch.parallel.dist import all_reduce_mean

    grads = [torch.randn_like(p) for p in params]
    return _cuda_ms(lambda: all_reduce_mean(grads, group), iters)


def dp_phase(dev, card: str) -> dict:
    """Data parallelism (parallel/dist.py) on the one card: the flagship's
    bf16 fused GAN steps at world 1 through an NCCL group against no group
    (bit for bit, exact launches; ms a step of each and of the gradient
    all_reduce); fp32 at world 2 through gloo on the card against world 1
    (ranks bit for bit, within JAX's DP tolerance), with the Laura trainer
    at full width; two serving replicas on the card."""
    from funcodec_tpu_torch.parallel import dist

    t0 = time.perf_counter()
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    res = {}
    speech = _train_speech(dev, TRAIN_B, seed=47)

    # 1. world 1: an NCCL group of one against no group, bit for bit (a deterministic process of its
    # own), then the steady step's ms with and without the group and the gradient all_reduce's here
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # read by the spawned process's cuBLAS
    try:
        dist.spawn_ranks(_dp_world1, 1, (dist.file_init_method(DP_DIR), str(dev), str(DP_DIR)),
                         timeout_s=DP_RANKS_TIMEOUT_S)
    finally:
        del os.environ["CUBLAS_WORKSPACE_CONFIG"]
    w1 = json.loads((DP_DIR / "world1.json").read_text())
    if w1["differ"] or not w1["stats_equal"] or w1["jax_imported"]:
        raise RuntimeError(f"dp world 1 ({w1['backend']}): {len(w1['differ'])} of {w1['n_tensors']} tensors differ "
                           f"from no group's ({w1['differ'][:4]}), stats equal: {w1['stats_equal']}")
    group = dist.init_process_group(dev, init_method=dist.file_init_method(DP_DIR), world_size=1, rank=0)
    try:
        state, _ = build_trainer(dev, True, torch.bfloat16, **STEADY)
        ar = dict(generator=_allreduce_ms(list(state.model.parameters()), group),
                  discriminator=_allreduce_ms(list(state.discriminator.parameters()), group))
        del state
        torch.cuda.empty_cache()
        steady = {}
        for name, g in (("no group", None), (f"{group.backend} world 1", group)):
            _, _, ms, _ = dp_gan(dev, torch.bfloat16, speech, group=g, timed=DP_W1_TIMED, **STEADY)
            steady[name] = ms
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group(group)
    log(f"[dp] world 1 through {w1['backend']}: bf16 shared steps with both SEANet flags at B={TRAIN_B} x "
        f"{TRAIN_SECONDS} s, the recipe's quantizer, deterministic algorithms: {DP_STEPS} steps bit for bit the "
        f"no-group path's ({w1['n_tensors']} tensors, stats equal), launches {w1['launches']} ({TRAIN_EXPECT} a "
        f"step); default algorithms, steady ms a step over {DP_W1_TIMED}: "
        + ", ".join(f"{k} {v:.2f}" for k, v in steady.items())
        + f"; all_reduce_mean of the gradients {ar['generator']:.3f} ms (generator) + {ar['discriminator']:.3f} ms "
          f"(discriminator) ({card})")
    res["world1"] = dict(w1, ms_per_step=steady, allreduce_ms=ar)

    # 2. world 2 through gloo on the card (spawned ranks), against world 1 fp32
    ranks_dev = str(dev)
    t_spawn = time.perf_counter()
    dist.spawn_ranks(_dp_rank, 2, (dist.file_init_method(DP_DIR), ranks_dev, str(DP_DIR)),
                     timeout_s=DP_RANKS_TIMEOUT_S)
    spawn_s = time.perf_counter() - t_spawn
    ranks = [json.loads((DP_DIR / f"rank{r}.json").read_text()) for r in range(2)]
    if any(r["jax_imported"] for r in ranks):
        raise RuntimeError("a dp rank imported JAX")
    want_launches = {k: (DP_STEPS + DP_TIMED) * v for k, v in TRAIN_EXPECT.items()}
    for r in ranks:
        if not (r["same_gan"] and r["same_laura"]) or r["launches"] != want_launches:
            raise RuntimeError(f"dp rank {r['rank']}: states equal to rank 0's: GAN {r['same_gan']}, Laura "
                               f"{r['same_laura']}; launches {r['launches']}, expected {want_launches}")
    reset_counts()
    # world 1 searches its codebooks itself but takes the ranks' codes (their rows joined), so that
    # a code flipped at a near-tie (the latents differ in rounding) does not fork the trajectories
    rank_codes = [torch.load(DP_DIR / f"codes_rank{r}.pt", weights_only=True) for r in range(2)]
    forced = ScanCodes([torch.cat(c) for c in zip(*rank_codes)])
    one, one_stats, one_ms, _ = dp_gan(dev, None, _train_speech(dev, TRAIN_B), timed=DP_TIMED, optim=DP_OPTIM,
                                       scan=forced, **STEADY)
    if len(forced.codes) != len(forced.forced) or forced.gap > VALID_REL:
        raise RuntimeError(f"dp GAN: world 1 made {len(forced.codes)} codebook searches against the ranks' "
                           f"{len(forced.forced)}; {forced.flips} of its own codes differ from the ranks', the "
                           f"largest distance gap {forced.gap:.3e} (limit {VALID_REL:.0e})")
    gan_worst = _dp_close(torch.load(DP_DIR / "gan_rank0.pt", weights_only=True), one, "dp GAN")
    gan_stats_worst = _dp_stats_close(ranks[0]["stats"], one_stats, "dp GAN")
    del one
    torch.cuda.empty_cache()
    lone, lone_stats, _ = dp_laura(dev)
    laura_worst = _dp_close(torch.load(DP_DIR / "laura_rank0.pt", weights_only=True),
                            {k: v.detach().cpu() for k, v in lone.model.state_dict().items()}, "dp Laura")
    laura_stats_worst = _dp_stats_close(ranks[0]["laura_stats"], lone_stats, "dp Laura")
    if ranks[0]["laura_tokens"] == ranks[1]["laura_tokens"]:
        raise RuntimeError("dp Laura: the ranks' rows hold equal codec token counts; the denominators go untested")
    del lone
    torch.cuda.empty_cache()
    held = {k: max(r["held"][k] for r in ranks) for k in ranks[0]["held"]}
    log(f"[dp] world 2 through gloo on one card (two processes on {ranks_dev}; NCCL refuses two ranks on one "
        f"device), fp32, TF32 off, global B={TRAIN_B}: GAN ranks bit for bit equal, {DP_STEPS} steps within "
        f"{gan_worst['parameters']:.3f} (parameters), {gan_worst['codebooks']:.3f} (codebooks, each codeword) and "
        f"{gan_stats_worst:.3f} (stats) of the rtol {DP_RTOL} / atol {DP_ATOL} "
        f"tolerance of world 1 (SGD at the yaml's rates; world 1 on the ranks' codes of its {len(forced.codes)} "
        f"codebook searches: {forced.flips} of its own differ, the largest distance gap {forced.gap:.3e}, limit "
        f"{VALID_REL:.0e}); launches per rank {ranks[0]['launches']}; each rank's first-step kernel calls "
        f"against their plain versions: max|err| {held}; ms a step (steps {DP_STEPS + 1}-{DP_STEPS + DP_TIMED}): "
        f"gloo world 2 on one card {ranks[0]['ms']:.1f} (rank 1 {ranks[1]['ms']:.1f}), world 1 no group "
        f"{one_ms:.1f}. Laura at full width, {DP_LAURA_STEPS} steps at B={DP_LAURA_B} (ranks' codec tokens "
        f"{[r['laura_tokens'] for r in ranks]}): ranks bit for bit equal, within "
        f"{laura_worst['parameters']:.3f} (states) and "
        f"{laura_stats_worst:.3f} (stats) of the tolerance; ranks' wall {spawn_s:.1f} s ({card})")
    res["world2"] = dict(backend="gloo", device=ranks_dev, ranks=ranks, gan_worst=gan_worst, searches=len(forced.codes),
                         code_flips=forced.flips, flip_gap=forced.gap,
                         gan_stats_worst=gan_stats_worst, laura_worst=laura_worst,
                         laura_stats_worst=laura_stats_worst, world1_fp32_ms=one_ms, held=held, ranks_s=spawn_s)

    # 3. serving replicas on the card
    res["serving"] = dp_serving(dev, _flagship_config())
    res["launches"] = {k: w1["launches"][k] + res["serving"]["launches"][k] for k in COUNTERS}
    res["max_abs_err"] = {k: max(held.get(k, 0.0), res["serving"]["max_abs_err"].get(k, 0.0))
                          for k in res["serving"]["max_abs_err"]}
    res["phase_s"] = time.perf_counter() - t0
    log(f"[dp] phase {res['phase_s']:.1f} s; launches (the NCCL world-1 steps and the replicas' requests) "
        f"{res['launches']}")
    return res


# ---------------------------------------------------------------------------
# recipe phase: the codec recipe's tooling, the residual and identity
# quantizers, the context loss and CodecSemanticAug
# ---------------------------------------------------------------------------

RECIPE_DIR = OUT_DIR / "recipe"
RECIPE_FILE_SR = 24_000  # the corpus's file rate; dump_to_wav_ark resamples it to SR
RECIPE_CONF = dict(TRAINER_CONF, keep_nbest_models=2)  # both epochs kept for average_nbest
# the context loss at ContextConfig's defaults (6 blocks, 8 heads, 2,048 units, odim 128)
RECIPE_CONTEXT = {"model": "transformer", "ce_loss_weight": 1.0,
                  "mask_conf": {"mask_ratio_range": [0.0, 0.05], "num_mask": 2}}
RECIPE_ENCODE_B = 8  # the valid split in one batch
PPG_DIM, PPG_DS_RATE, PPG_FRAMES_PER_S = 86, 2, 100
PPG_MODES = ("residual", "addition", "concat", "supervision", "ptts")
# the PPG layers' stride-1 convs with K > 1, which FUSED_STRIDE1 runs in conv1d_s1: the
# downsampling stack's first conv in every mode, the concat fusion's conv, and (training
# only: inference runs no classifier) the supervision classifier's first two convs
PPG_CONVS = {"train": {"residual": 1, "addition": 1, "concat": 2, "supervision": 3, "ptts": 1},
             "infer": {"residual": 1, "addition": 1, "concat": 2, "supervision": 1, "ptts": 1}}
PPG_INFER_B, PPG_INFER_SECONDS = 8, 10.0
RECIPE_TIMED = 6  # steady steps timed a side, in turns of 3 (without, with, with, without)
QUALITY_KEYS = {"lsd_db", "mel_distortion", "si_snr_db", "stoi", "nsim"}
NO_LAUNCHES = dict.fromkeys(COUNTERS, 0)


def _launches(base: dict, n: int = 1, **extra) -> dict:
    return {k: n * v + extra.get(k, 0) for k, v in base.items()}


def _held_part(what: str, expect: dict, fn, held: dict, tag: str = "recipe"):
    """fn() with its kernel calls recorded; its launches must equal `expect`. Then
    each recorded call is held against its plain version (_held_calls, _held_rvq),
    and the counters are set back to what fn() left, so that those launches do not
    count. Returns fn()'s result."""
    _sync(CARD)
    before = read_counts()
    with _recorded_seanet_calls() as calls, _recorded_rvq_calls() as rvq_calls:
        result = fn()
        _sync(CARD)
    after = read_counts()
    launched = {k: after[k] - before[k] for k in after}
    if launched != expect:
        raise RuntimeError(f"{tag} {what}: launches {launched}, expected {expect}")
    errs = _held_calls(calls, f"{tag} {what}") if calls else {}
    if rvq_calls:
        errs["rvq_encode"] = _held_rvq(rvq_calls, f"{tag} {what}")
    for name, (mod, attr) in COUNTERS.items():
        setattr(mod, attr, after[name])
    for k, v in errs.items():
        held["max_abs_err"][k] = max(held["max_abs_err"].get(k, 0.0), v)
    held["calls"] += len(calls) + len(rvq_calls)
    held["launches"][what] = launched
    return result


class _Messages(logging.Handler):
    """Collects the log records' messages; INFO reaches it while it is attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        root = logging.getLogger()
        self._level = root.level
        root.addHandler(self)
        root.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        root = logging.getLogger()
        root.removeHandler(self)
        root.setLevel(self._level)

    def tree(self) -> str:
        trees = [m.strip("\n") for m in self.messages if "serving-path cost tree" in m]
        if len(trees) != 1:
            raise RuntimeError(f"--stat_flops: {len(trees)} cost trees logged, expected 1")
        return trees[0]


def _recipe_config() -> dict:
    """The flagship yaml with the recipe's model: a residual_quantizer of the
    yaml's codebooks with quantize dropout, and the context loss."""
    config = load_config(str(FLAGSHIP_YAML))
    config.update(RECIPE_CONF)
    q = config["quantizer_conf"]
    config["quantizer"] = "residual_quantizer"
    config["quantizer_conf"] = {"codebook_size": q["codebook_size"], "num_quantizers": q["num_quantizers"],
                                "quantize_dropout": True}
    config["model_conf"].update(context_loss_weight=1.0, context_loss_conf=RECIPE_CONTEXT)
    return config


def recipe_data(held: dict) -> dict:
    """Step 1: the seeded 24 kHz corpus dumped to 16 kHz wav arks by
    cli/dump_to_wav_ark, and calc_shape's scan of it."""
    from funcodec_tpu_torch.cli import dump_to_wav_ark
    from funcodec_tpu_torch.data.wav_io import read_2column_text
    from funcodec_tpu_torch.utils.shape_utils import calc_shape

    def run():
        out = {}
        for split, n, seconds, seed in (("train", TRAINER_UTTS, TRAINER_SECONDS, 60),
                                        ("valid", VALID_UTTS, VALID_SECONDS, 61)):
            raw = _trainer_corpus(RECIPE_DIR / "raw" / split, n, seconds, seed, sr=RECIPE_FILE_SR)
            dump = RECIPE_DIR / "dump" / split
            wrote = dump_to_wav_ark.main(["--wav_scp", str(RECIPE_DIR / "raw" / split / "wav.scp"), "--out_dir",
                                          str(dump), "--sample_rate", str(SR), "--nj", "4"])
            kept, dropped = calc_shape(str(RECIPE_DIR / "raw"), split, str(RECIPE_DIR / "shape"), num_workers=4)
            shapes = {k: int(v) for k, v in read_2column_text(RECIPE_DIR / "shape" / split / "speech_shape").items()}
            lengths = {k: int(v) for k, v in read_2column_text(dump / "length.txt").items()}
            want = {k: -(-m * SR // RECIPE_FILE_SR) for k, m in raw.items()}  # resample_poly's output length
            if wrote != n or (kept, dropped) != (n, 0) or shapes != raw or lengths != want or \
                    len(list(dump.glob("wav.*.ark"))) != 4:
                raise RuntimeError(f"recipe data {split}: {wrote} dumped, calc_shape ({kept}, {dropped}); "
                                   f"the shapes or 16 kHz lengths disagree with the corpus")
            out[split] = lengths
        return out

    lengths = _held_part("data", NO_LAUNCHES, run, held)
    log(f"[recipe] cli/dump_to_wav_ark --nj 4: {len(lengths['train'])} + {len(lengths['valid'])} utterances of "
        f"{RECIPE_FILE_SR} Hz PCM16 to {SR} Hz wav arks (4 shards each), length.txt equal to resample_poly's "
        f"lengths; calc_shape's speech_shape equal to the corpus'")
    return lengths


def recipe_train(dev, lengths: dict, held: dict):
    """Step 2: cli/codec_train with --stat_flops, bf16, the three kernels, on the dumped arks."""
    import yaml

    from funcodec_tpu_torch.cli import codec_train
    from funcodec_tpu_torch.models.quantizer import ResidualQuantizer
    from funcodec_tpu_torch.utils.misc import codec_flops_tree, model_summary

    config = _recipe_config()
    conf = RECIPE_DIR / "config.yaml"
    conf.write_text(yaml.safe_dump(config))
    exp = RECIPE_DIR / "exp"
    iters, epochs = config["num_iters_per_epoch"], config["max_epoch"]
    v_batches = -(-len(lengths["valid"]) // config["batch_size"])
    args = ["--config", str(conf), "--output_dir", str(exp), "--train_wav_scp",
            str(RECIPE_DIR / "dump" / "train" / "wav.scp"), "--valid_wav_scp",
            str(RECIPE_DIR / "dump" / "valid" / "wav.scp"), "--train_dtype", "bfloat16", "--device", str(dev),
            "--stat_flops"]
    t0 = time.perf_counter()
    with _Messages() as logged:
        trainer, state = _held_part("codec_train", _expected(epochs * iters, epochs * v_batches),
                                      lambda: codec_train.main(args), held)
    wall = time.perf_counter() - t0
    model = state.model
    stats = _check_run(exp, epochs, "recipe")
    if not isinstance(model.quantizer, ResidualQuantizer) or model.context is None or state.step != epochs * iters:
        raise RuntimeError("recipe codec_train: not the residual quantizer with the context loss, or steps missing")
    tree = logged.tree()
    if tree != codec_flops_tree(model, samples=config["speech_max_length"]) or \
            model_summary(model, "generator") not in logged.messages:
        raise RuntimeError("recipe codec_train: the logged cost tree or parameter summary is not the model's")
    last = stats[str(epochs)]
    ctx, acc = last["train"]["context_loss"], last["train"]["context_pred_acc"]
    if not (ctx > 0 and 0 <= acc <= 1 and last["valid"]["context_loss"] > 0 and "rvq_dead_codes" in last["train"]):
        raise RuntimeError(f"recipe codec_train: context stats {ctx}, {acc} or the codebook health missing")
    log(f"[recipe] cli/codec_train --stat_flops, residual_quantizer ({config['quantizer_conf']}) + context loss "
        f"(transformer 6 x 8 heads x 2048, ce 1.0, masks [0, 0.05] x 2), bf16 B={config['batch_size']}, {epochs} "
        f"epochs x {iters} steps: {wall:.2f} s; launches exact; epoch {epochs} train context_loss {ctx:.4f}, "
        f"pred_acc {acc:.4f}, valid multi-spectral {last['valid']['generator_multi_spectral_recon_loss']:.4f}; "
        f"the logged tree is codec_flops_tree's ({tree.splitlines()[-1].strip()})")
    params = {name: sum(p.numel() for p in m.parameters()) for name, m in
              (("generator", model), ("context", model.context))}
    log(f"[recipe] parameters: {params} (the generator's include the context model's)")
    return config, exp, model, dict(wall_s=wall, context_loss=ctx, context_pred_acc=acc, parameters=params,
                                    valid_multi_spectral=last["valid"]["generator_multi_spectral_recon_loss"])


def recipe_average(exp: Path, held: dict) -> Path:
    """Step 3: cli/average_nbest over the two epochs: the fp64 mean of the
    parameters, the best epoch's buffers."""
    from funcodec_tpu_torch.cli import average_nbest

    def run():
        path = Path(average_nbest.main(["--exp_dir", str(exp), "--nbest", "2"]))
        if path.name != "valid.generator_multi_spectral_recon_loss.ave_2best.pth":
            raise RuntimeError(f"recipe average_nbest: wrote {path.name}")
        avg = torch.load(path, map_location="cpu", weights_only=True)
        epochs = [torch.load(exp / f"{e}epoch.pth", map_location="cpu", weights_only=True) for e in (1, 2)]
        best = min((1, 2), key=lambda e: json.loads((exp / "reporter.json").read_text())["stats"][str(e)]["valid"][
            "generator_multi_spectral_recon_loss"])
        for k, v in avg.items():
            want = ((epochs[0][k].double() + epochs[1][k].double()) / 2).float() if "quantizer.rq.model" not in k \
                else epochs[best - 1][k]
            if v.shape != want.shape or float((v.double() - want.double()).abs().max()) > 1e-7:
                raise RuntimeError(f"recipe average_nbest: {k} is not the mean of the two epochs")
        return path

    return _held_part("average_nbest", NO_LAUNCHES, run, held)


def recipe_serve(dev, exp: Path, avg: Path, lengths: dict, held: dict) -> dict:
    """Step 4: cli/codec_inference with the averaged weights (bf16, the three
    flags): encode the valid split to codecs.txt (with --stat_flops), then
    decode it to wavs; step 5: cli/codec_eval over them."""
    from funcodec_tpu_torch.cli import codec_eval
    from funcodec_tpu_torch.utils.misc import codec_flops_tree

    valid = lengths["valid"]
    n_batches = -(-len(valid) // RECIPE_ENCODE_B)
    frames = {k: -(-n // 320) for k, n in valid.items()}
    common = ["--config_file", str(exp / "config.yaml"), "--model_file", str(avg), "--batch_size",
              str(RECIPE_ENCODE_B), "--bit_width", "16000", "--dtype", "bfloat16", "--device", str(dev)]
    t0 = time.perf_counter()
    with _Messages() as logged:
        _held_part("encode", _launches(LAURA_ENCODE, n_batches), lambda: cli.main(
            common + ["--output_dir", str(RECIPE_DIR / "codes"), "--data_path_and_name_and_type",
                      f"{RECIPE_DIR / 'dump' / 'valid' / 'wav.scp'},speech,sound", "--run_mod", "encode",
                      "--stat_flops"]), held)
    codes = _codecs(RECIPE_DIR / "codes" / "codecs.txt")
    config = load_config(str(exp / "config.yaml"))
    nq, bins = config["quantizer_conf"]["num_quantizers"], config["quantizer_conf"]["codebook_size"]
    if set(codes) != set(valid) or any(c.shape != (nq, frames[k]) or c.min() < 0 or c.max() >= bins
                                       for k, c in codes.items()):
        raise RuntimeError("recipe encode: codecs.txt does not hold (n_q, frames) tokens of every key")
    model, _ = build_codec_model(config, device=dev)
    if logged.tree() != codec_flops_tree(model, samples=SR):
        raise RuntimeError("recipe encode: --stat_flops logged another tree than codec_flops_tree's")
    del model
    _held_part("decode", _launches(DECODE_PER_BATCH, n_batches), lambda: cli.main(
        common + ["--output_dir", str(RECIPE_DIR / "decode"), "--data_path_and_name_and_type",
                  f"{RECIPE_DIR / 'codes' / 'codecs.txt'},speech,codec_json", "--run_mod", "decode"]), held)
    _check_wavs(RECIPE_DIR / "decode", {k: f * 320 for k, f in frames.items()}, SR, "recipe decode")
    serve_s = time.perf_counter() - t0
    quality = _held_part("codec_eval", NO_LAUNCHES, lambda: codec_eval.main(
        ["--ref_scp", str(RECIPE_DIR / "raw" / "valid" / "wav.scp"), "--deg_dir", str(RECIPE_DIR / "decode"),
         "--output_dir", str(RECIPE_DIR / "score")]), held)
    saved = json.loads((RECIPE_DIR / "score" / "quality.json").read_text())
    values = [v for m in [saved["mean"], *saved["per_utt"].values()] for v in m.values()]
    if set(saved) != {"mean", "per_utt"} or set(saved["per_utt"]) != set(valid) or \
            any(set(m) != QUALITY_KEYS for m in [saved["mean"], *saved["per_utt"].values()]) or \
            not all(math.isfinite(v) for v in values) or saved["mean"] != quality["mean"]:
        raise RuntimeError("recipe codec_eval: quality.json's schema is incomplete or a value is not finite")
    log(f"[recipe] cli/codec_inference on the averaged weights, bf16 B={RECIPE_ENCODE_B}: encode (--stat_flops) to "
        f"codecs.txt and decode to {len(valid)} wavs in {serve_s:.2f} s, launches exact; cli/codec_eval from the "
        f"24 kHz references: quality.json complete and finite (random weights: mean {saved['mean']})")
    return dict(serve_wall_s=serve_s, quality_mean=saved["mean"])


def _semantic_model(dev, mode: str):
    config = load_config(str(FLAGSHIP_YAML))
    config["quantizer_conf"].update(STEADY)
    config["model"] = "codec_semantic_aug"
    config["model_conf"]["ppg_conf"] = {"ppg_dim": PPG_DIM, "ppg_ds_rate": PPG_DS_RATE, "ppg_usage_mod": mode}
    return build_codec_model(config, device=dev, generator=torch.Generator(device=dev).manual_seed(70))


def recipe_semantic(dev, held: dict) -> dict:
    """Step 6: CodecSemanticAug in its five modes: forward_generator_ppg and
    its backward at B = 16 x 2.56 s, inference_ppg at B = 8 x 10 s, bf16 over
    fp32 weights, on seeded posteriors at 100 frames a second."""
    from torch.func import functional_call

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(71)
    speech = torch.from_numpy(_speech(72, TRAIN_B, TRAIN_SECONDS)).to(dev, bf16)
    ppg = torch.rand(TRAIN_B, round(TRAIN_SECONDS * PPG_FRAMES_PER_S), PPG_DIM, generator=gen, device=dev)
    x_inf = torch.from_numpy(_speech(73, PPG_INFER_B, PPG_INFER_SECONDS)).to(dev, bf16)
    ppg_inf = torch.rand(PPG_INFER_B, round(PPG_INFER_SECONDS * PPG_FRAMES_PER_S), PPG_DIM, generator=gen,
                         device=dev)
    out = {}
    for mode in PPG_MODES:
        model, disc = _semantic_model(dev, mode)
        names, params = zip(*model.named_parameters())
        c_params = {n: p.to(bf16) for n, p in zip(names, params)}
        d_params = {n: p.detach().to(bf16) for n, p in disc.named_parameters()}

        def turn():
            loss, o = functional_call(model, c_params, ("forward_generator_ppg",
                                                        lambda x: functional_call(disc, d_params, (x,)), speech, ppg,
                                                        step_generator(dev, 0, 0)))
            return loss.detach(), o, torch.autograd.grad(loss, params, allow_unused=True)

        loss, o, grads = _held_part(f"semantic {mode} train",
                                      _launches(TRAIN_EXPECT, conv1d_s1=PPG_CONVS["train"][mode]), turn, held)
        stats = _floats(o["stats"])
        grads = dict(zip(names, grads))
        ppg_grad = [g for n, g in grads.items() if g is not None and n.startswith(
            "ppg_classifier" if mode == "supervision" else "ppg_embedding")]
        if not math.isfinite(loss.item()) or not all(torch.isfinite(g).all() for g in grads.values() if g is not None) \
                or not ppg_grad or max(float(g.abs().max()) for g in ppg_grad) == 0 or \
                (mode == "supervision") != (stats["ppg_supervision_loss"] > 0):
            raise RuntimeError(f"recipe semantic {mode}: the loss, a gradient or the PPG's gradient is wrong")
        with torch.inference_mode():
            res = _held_part(f"semantic {mode} inference",
                               _launches(EXPECT[MAIN_PATH], conv1d_s1=PPG_CONVS["infer"][mode]),
                               lambda: functional_call(model, c_params, ("inference_ppg", x_inf, ppg_inf)), held)
        idx, recon = res["code_indices"][0], res["recon_speech"]
        frames = round(PPG_INFER_SECONDS * SR / 320)
        q = model.quantizer.cfg
        if idx.shape != (q.num_quantizers, PPG_INFER_B, frames) or idx.min() < 0 or idx.max() >= q.codebook_size or \
                recon.shape != x_inf.shape or not torch.isfinite(recon).all():
            raise RuntimeError(f"recipe semantic {mode}: inference_ppg gave {tuple(idx.shape)} tokens, "
                               f"{tuple(recon.shape)} recon")
        out[mode] = dict(loss=float(loss), ppg_supervision_loss=stats["ppg_supervision_loss"])
        del model, disc, c_params, grads, res
    torch.cuda.empty_cache()
    log(f"[recipe] CodecSemanticAug (ppg_dim {PPG_DIM}, ds {PPG_DS_RATE}), five modes: forward_generator_ppg + "
        f"backward at B={TRAIN_B} x {TRAIN_SECONDS} s and inference_ppg at B={PPG_INFER_B} x {PPG_INFER_SECONDS} s, "
        f"bf16, launches exact (the PPG convs through conv1d_s1: {PPG_CONVS}); losses "
        f"{ {m: round(v['loss'], 4) for m, v in out.items()} }")
    return out


def recipe_identity(dev, held: dict) -> dict:
    """Step 7: one bf16 shared step with identity_quantizer (no codebooks)."""
    config = load_config(str(FLAGSHIP_YAML))
    config["quantizer"] = "identity_quantizer"
    model, disc = build_codec_model(config, device=dev, generator=torch.Generator(device=dev).manual_seed(80))
    opts = [make_optimizer(lr=c["lr"], betas=tuple(c["betas"])) for c in (config["optim_conf"], config["optim2_conf"])]
    state = create_gan_train_state(model, disc, *opts)
    step = make_gan_train_step(model, disc, *opts, shared_forward=True, compute_dtype=torch.bfloat16)
    before = [p.detach().clone() for p in model.parameters()]
    state, stats = _held_part("identity step", TRAIN_EXPECT, lambda: step(
        state, {"speech": _train_speech(dev, TRAIN_B)}, step_generator(dev, 0, 0)), held)
    stats = _floats(stats)
    moved = sum(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    if any(k.startswith("rvq_") for k in stats) or state.rvq_state.embed.numel() or moved < len(before) - 1 or \
            stats["generator_commit_loss"] != 0.0:
        raise RuntimeError(f"recipe identity: {moved} of {len(before)} tensors moved, stats {sorted(stats)}")
    log(f"[recipe] identity_quantizer: one bf16 shared step with no codebooks, launches exact, {moved} of "
        f"{len(before)} generator tensors moved, generator loss {stats['generator_loss']:.4f}")
    del state, step, model, disc
    return stats


def recipe_tree(model, held: dict) -> str:
    """Step 8: codec_flops_tree at 1 s with the three flags on, then off: the same string, no launch."""
    from funcodec_tpu_torch.utils.misc import codec_flops_tree

    def run():
        set_flags(MAIN_PATH)
        on = codec_flops_tree(model, samples=SR)
        conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = rvq.FUSED_RVQ = False
        off = codec_flops_tree(model, samples=SR)
        set_flags(MAIN_PATH)
        if on != off:
            raise RuntimeError("recipe: codec_flops_tree changes with the kernel flags")
        return on

    tree = _held_part("flops tree", NO_LAUNCHES, run, held)
    log(f"[recipe] codec_flops_tree at 1 s, flags on = flags off: {tree.splitlines()[-1].strip()}")
    return tree


def recipe_timing(dev, card: str) -> dict:
    """Step 9: the steady bf16 shared step (fused kernels, initialized
    codebooks) with and without the context loss: ms a step over
    RECIPE_TIMED steps a side in turns, and device kernels a step."""
    _set_seanet_flags(True)
    sides = {name: build_trainer(dev, True, torch.bfloat16, model_conf=mc, **STEADY) for name, mc in
             (("without", None), ("with", dict(context_loss_weight=1.0, context_loss_conf=RECIPE_CONTEXT)))}
    speech = _train_speech(dev, TRAIN_B)
    counter = {name: 0 for name in sides}

    def steps(name, n):
        state, step = sides[name]
        for _ in range(n):
            state, _ = step(state, {"speech": speech}, step_generator(dev, 0, counter[name]))
            counter[name] += 1

    for name in sides:
        steps(name, 2)  # warm-up
    times = {name: [] for name in sides}
    for name in ("without", "with", "with", "without"):
        _sync(dev)
        t0 = time.perf_counter()
        steps(name, RECIPE_TIMED // 2)
        _sync(dev)
        times[name].append((time.perf_counter() - t0) / (RECIPE_TIMED // 2) * 1e3)
    kernels = {name: _kernel_launches(lambda: steps(name, 1)) for name in sides}
    ms = {name: sum(v) / len(v) for name, v in times.items()}
    _set_seanet_flags(False)
    log(f"[recipe] steady bf16 shared step, B={TRAIN_B} x {TRAIN_SECONDS} s, fused: without the context loss "
        f"{ms['without']:.2f} ms ({times['without']}), with it {ms['with']:.2f} ms ({times['with']}): "
        f"{(ms['with'] / ms['without'] - 1) * 100:+.2f} %; device kernels a step {kernels} ({card})")
    del sides
    torch.cuda.empty_cache()
    return dict(ms=ms, ms_turns=times, kernels_per_step=kernels, ratio=ms["with"] / ms["without"])


def recipe_phase(dev, card: str) -> dict:
    """Steps 1-8 on the recipe's path with every count set to 0 before them and
    read after (each part's calls held against their plain versions, those
    launches not counted); then step 9's timing."""
    t_phase = time.perf_counter()
    shutil.rmtree(RECIPE_DIR, ignore_errors=True)
    RECIPE_DIR.mkdir(parents=True)
    held = dict(max_abs_err={}, calls=0, launches={})
    set_flags(MAIN_PATH)
    _sync(dev)
    reset_counts()
    lengths = recipe_data(held)
    config, exp, model, train = recipe_train(dev, lengths, held)
    avg = recipe_average(exp, held)
    serve = recipe_serve(dev, exp, avg, lengths, held)
    semantic = recipe_semantic(dev, held)
    identity = recipe_identity(dev, held)
    set_flags(MAIN_PATH)
    tree = recipe_tree(model, held)
    _sync(dev)
    counts = read_counts()
    expect = {k: sum(part[k] for part in held["launches"].values()) for k in counts}
    if counts != expect:
        raise RuntimeError(f"recipe: launches {counts}, the parts' sum {expect}")
    path_s = time.perf_counter() - t_phase
    del model
    torch.cuda.empty_cache()
    timing = recipe_timing(dev, card)
    log(f"[recipe] the recipe's path {path_s:.2f} s, launches {counts}, {held['calls']} kernel calls held against "
        f"their plain versions (max|err| {held['max_abs_err']}); phase {time.perf_counter() - t_phase:.2f} s")
    return dict(launches=counts, parts=held["launches"], max_abs_err=held["max_abs_err"], held_calls=held["calls"],
                path_s=path_s, phase_s=time.perf_counter() - t_phase, train=train, serve=serve, semantic=semantic,
                identity_loss=identity["generator_loss"], tree_total=tree.splitlines()[-1].strip(), timing=timing)


# ---------------------------------------------------------------------------
# streaming phase
# ---------------------------------------------------------------------------

# the causal weight_norm EnCodec of scripts/bench_streaming.py: 16 kHz, n_filters 32,
# dimension 128, ratios 8·5·4·2, a 2-layer LSTM, 32 x 1024 codebooks, no audio_normalize
STREAM_CONFIG = {
    "encoder_conf": {"causal": True, "norm": "weight_norm", "n_filters": 32, "ratios": [8, 5, 4, 2],
                     "seq_model": "lstm"},
    "decoder_conf": {"causal": True, "norm": "weight_norm", "n_filters": 32, "ratios": [8, 5, 4, 2],
                     "seq_model": "lstm"},
    "quantizer_conf": {"codebook_size": 1024, "num_quantizers": 32, "kmeans_init": False, "sampling_rate": SR,
                       "encoder_hop_length": 320},
    "model_conf": {"odim": 128, "target_sample_hz": SR, "audio_normalize": False},
}
STREAM_B, STREAM_SECONDS = 2, 10.0
# the first chunk primes the session; reflect pads need >= 2,240 samples here (min_first_chunk)
STREAM_FIRST = 2560
STREAM_CYCLE_MS = (20, 80, 320)  # the steady chunks, in this order, then 20 ms ones to the end
STREAM_REL = 2e-4  # streamed samples against the whole decode of the same tokens, of the output's scale
STREAM_NEAR_TIE = 1e-4  # a streamed token may differ from the whole path's only at such a near-tie
# bf16 with FUSED_STRIDE1: conv1d_s1 in each direction's first (unprimed) chunk, at the
# six stride-1 K > 1 convs (the head conv, four residual k3 convs, the last conv);
# primed chunks run plain convs on carry + chunk; the session's RVQ is the fp32 scan
STREAM_EXPECT = {"first encode chunk": dict(NO_LAUNCHES, conv1d_s1=6),
                 "first decode chunk": dict(NO_LAUNCHES, conv1d_s1=6),
                 "primed chunks": NO_LAUNCHES, "flush": NO_LAUNCHES}
STREAM_TIMED_B = (1, 8)
STREAM_TIMED_MS = (20, 80, 320)
STREAM_REPS = 20


def _stream_chunks(total: int) -> list:
    chunks = [STREAM_FIRST]
    cycle = [SR * ms // 1000 for ms in STREAM_CYCLE_MS]
    rest = total - STREAM_FIRST
    while rest >= sum(cycle):
        chunks += cycle
        rest -= sum(cycle)
    small = cycle[0]
    chunks += [small] * (rest // small)
    assert sum(chunks) == total
    return chunks


@contextlib.contextmanager
def _encode_calls():
    """Record each Quantizer.encode scan inside the block (models/quantizer.py
    calls rvq_encode by name): [(input (B, T, D) fp32, codes (n_q, B, T), embed)]."""
    import funcodec_tpu_torch.models.quantizer as quantizer_mod

    calls, inner = [], quantizer_mod.rvq_encode

    def wrapper(cfg, state, x, n_q=None):
        codes = inner(cfg, state, x, n_q)
        calls.append((x.float().clone(), codes.clone(), state.embed))
        return codes

    quantizer_mod.rvq_encode = wrapper
    try:
        yield calls
    finally:
        quantizer_mod.rvq_encode = inner


def _stream(model, wav: torch.Tensor, dtype, chunks, held=None) -> tuple:
    """wav (B, T) through a StreamingCodecSession in `chunks`, then flush():
    (tokens (n_q, B, T'), samples (B, T)). With `held`, each part's launches
    are held to STREAM_EXPECT and its kernel calls to their plain versions."""
    sess = StreamingCodecSession(model, batch=wav.shape[0], dtype=dtype)
    toks, outs, start = [], [], 0

    def part(what, fn):
        return fn() if held is None else _held_part(what, STREAM_EXPECT[what], fn, held, tag="streaming")

    def rest():
        nonlocal start
        for L in chunks[1:]:
            t = sess.encode_chunk(wav[:, start:start + L])
            toks.append(t)
            outs.append(sess.decode_chunk(t))
            start += L

    toks.append(part("first encode chunk", lambda: sess.encode_chunk(wav[:, :chunks[0]])))
    start = chunks[0]
    outs.append(part("first decode chunk", lambda: sess.decode_chunk(toks[0])))
    part("primed chunks", rest)
    tail = part("flush", sess.flush)
    if tail is not None:
        outs.append(tail)
    return torch.cat(toks, dim=2), torch.cat(outs, dim=1)


def _merged(calls):
    """A session's per-chunk encode calls as one call over the whole stream."""
    return (torch.cat([c[0] for c in calls], dim=1), torch.cat([c[1] for c in calls], dim=2), calls[0][2])


def _in_range(name: str, fn):
    """fn, each call inside a torch.profiler record_function range `name`."""
    from torch.profiler import record_function

    def ranged(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return ranged


def streaming_timing(model, dev, card: str) -> list:
    """The steady per-chunk round trip (encode_chunk + decode_chunk) of a
    primed fp32 session, fenced, best of STREAM_REPS; its device kernels and
    their summed time (one profiled round trip), and the idle share of the
    best round trip that leaves."""
    rows = []
    gen = torch.Generator(device=dev).manual_seed(61)
    _set_seanet_flags(False)
    for B in STREAM_TIMED_B:
        for ms in STREAM_TIMED_MS:
            sess = StreamingCodecSession(model, batch=B)
            sess.decode_chunk(sess.encode_chunk(0.1 * torch.randn(B, STREAM_FIRST, device=dev, generator=gen)))
            x = 0.1 * torch.randn(B, SR * ms // 1000, device=dev, generator=gen)

            def trip():
                return sess.decode_chunk(sess.encode_chunk(x))

            for _ in range(2):
                trip()
            best = float("inf")
            for _ in range(STREAM_REPS):
                _sync(dev)
                t0 = time.perf_counter()
                out = trip()
                _sync(dev)
                best = min(best, time.perf_counter() - t0)
            if out.shape != (B, x.shape[1]) or not torch.isfinite(out).all():
                raise RuntimeError(f"streaming timing B={B} {ms} ms: output {tuple(out.shape)}")
            # the quantizer's part of the same profiled round trip: its encode (the fp32 scan)
            # and decode, each run inside a named range
            q = model.quantizer
            q.encode, q.decode = _in_range("rvq_scan", q.encode), _in_range("rvq_decode", q.decode)
            try:
                kernels, device_ms, parts = _device_kernels(trip, ranges=("rvq_scan", "rvq_decode"))
            finally:
                del q.encode, q.decode
            scan, dequant = parts["rvq_scan"], parts["rvq_decode"]
            if not (0 < scan[0] < kernels and 0 < dequant[0] < kernels):
                raise RuntimeError(f"streaming timing B={B} {ms} ms: the profiler put {scan[0]} of the round trip's "
                                   f"{kernels} kernels in the RVQ scan and {dequant[0]} in the decode")
            rtf = ms / 1e3 / best
            rows.append(dict(batch=B, chunk_ms=ms, ms=best * 1e3, rtf_per_stream=rtf, rtf_total=B * rtf,
                             device_kernels=kernels, device_ms=device_ms, idle_share=1 - device_ms / (best * 1e3),
                             scan_kernels=scan[0], scan_device_ms=scan[1], dequant_kernels=dequant[0],
                             dequant_device_ms=dequant[1]))
            log(f"[streaming] round trip B={B} chunk {ms} ms: {best * 1e3:.3f} ms (best of {STREAM_REPS}), "
                f"{rtf:.2f}x real time per stream, {B * rtf:.2f}x in all; {kernels} device kernels, "
                f"{device_ms:.3f} ms of kernel time under the profiler (idle {rows[-1]['idle_share']:.3f} of the "
                f"best round trip), of them the RVQ encode scan's {scan[0]} kernels {scan[1]:.3f} ms and the RVQ "
                f"decode's {dequant[0]} kernels {dequant[1]:.3f} ms ({card})")
    return rows


def streaming_phase(dev, card: str) -> dict:
    """Phase 15: StreamingCodecSession on the causal EnCodec. fp32 (TF32 off):
    tokens equal to the whole path's but at near-ties, samples within
    STREAM_REL of the whole decode of the same tokens. bf16 with
    FUSED_STRIDE1: launches exact per part (every count set to 0 before the
    stream and read after), each kernel call held against its plain version,
    token flips against fp32 within MAX_FLIP_ALL. Then the timing."""
    t_phase = time.perf_counter()
    model, _ = build_codec_model(STREAM_CONFIG, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    if abs(n_params / 1e6 - PARAMS_M) / PARAMS_M > 0.02:
        raise RuntimeError(f"streaming: {n_params} parameters, not {PARAMS_M}M +-2%")
    wav = torch.from_numpy(_speech(60, STREAM_B, STREAM_SECONDS)).to(dev)
    chunks = _stream_chunks(wav.shape[1])
    T = wav.shape[1] // 320

    _set_seanet_flags(False)
    with _encode_calls() as s_calls:
        toks, recon = _stream(model, wav, torch.float32, chunks)
    with _encode_calls() as w_calls, torch.no_grad():
        whole = model.inference_encoding(wav, use_scale=False)["code_indices"][0]
    flips, n_codes, gap = _code_flips([_merged(s_calls)], w_calls)
    with torch.no_grad():
        ref = model.inference_decoding(toks.permute(1, 2, 0))["recon_speech"]
    rel = float((recon - ref).abs().max()) / float(ref.abs().max())
    if toks.shape != (STREAM_CONFIG["quantizer_conf"]["num_quantizers"], STREAM_B, T) or recon.shape != wav.shape or not torch.isfinite(recon).all():
        raise RuntimeError(f"streaming fp32: tokens {tuple(toks.shape)}, samples {tuple(recon.shape)}")
    log(f"[streaming] causal EnCodec {n_params} parameters; B={STREAM_B} x {STREAM_SECONDS} s in {len(chunks)} chunks "
        f"({STREAM_FIRST} samples, then {STREAM_CYCLE_MS} ms in turns, then 20 ms), fp32: {flips} of {n_codes} tokens "
        f"differ from inference_encoding(use_scale=False) (largest distance gap at a first differing stage {gap:.3e} "
        f"of the residual's squared norm, limit {STREAM_NEAR_TIE:.0e}); samples against the whole decode of the "
        f"streamed tokens {rel:.3e} of its scale (limit {STREAM_REL:.0e})")
    if gap > STREAM_NEAR_TIE or rel > STREAM_REL or whole.shape != toks.shape:
        raise RuntimeError("streaming fp32: the session disagrees with the whole-utterance path")

    held = dict(max_abs_err={}, calls=0, launches={})
    set_flags("stride1")  # FUSED_RVQ on too: the session's RVQ must not reach rvq_encode
    _sync(dev)
    reset_counts()
    toks_bf, recon_bf = _stream(model, wav, torch.bfloat16, chunks, held)
    _sync(dev)
    counts = read_counts()
    expect = {k: sum(part[k] for part in STREAM_EXPECT.values()) for k in counts}
    if counts != expect:
        raise RuntimeError(f"streaming bf16: launches {counts}, expected {expect}")
    bf_flips = _flips(toks_bf.cpu().numpy(), toks.cpu().numpy())
    if not torch.isfinite(recon_bf).all() or recon_bf.shape != wav.shape or bf_flips[1] > MAX_FLIP_ALL:
        raise RuntimeError(f"streaming bf16: samples {tuple(recon_bf.shape)}, flips against fp32 {bf_flips}")
    _set_seanet_flags(False)
    log(f"[streaming] bf16, FUSED_STRIDE1: launches {counts} exact ({held['calls']} kernel calls held against their "
        f"plain versions, max|err| {held['max_abs_err']}); token flips against fp32 q0 {bf_flips[0]:.4f} all "
        f"{bf_flips[1]:.4f} (limit {MAX_FLIP_ALL})")
    path_s = time.perf_counter() - t_phase
    timing = streaming_timing(model, dev, card)
    del model
    torch.cuda.empty_cache()
    log(f"[streaming] phase {time.perf_counter() - t_phase:.2f} s (the checks {path_s:.2f} s)")
    return dict(params=n_params, chunks=len(chunks), launches=counts, parts=held["launches"],
                max_abs_err=held["max_abs_err"], held_calls=held["calls"], fp32_token_flips=flips, tokens=n_codes,
                flip_gap=gap, sample_rel=rel, bf16_flips=dict(q0=bf_flips[0], all=bf_flips[1]), timing=timing,
                tokens_fp32=toks.cpu(), phase_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# extras phase
# ---------------------------------------------------------------------------

EXTRA_REL = 1e-4  # fp32 on the card (TF32 off) against the CPU, of each tensor's scale
EXTRA_DISCS = ("hifigan_period_discriminator", "hifigan_multi_period_discriminator", "hifigan_scale_discriminator",
               "hifigan_multi_scale_discriminator", "hifigan_multi_scale_multi_period_discriminator",
               "soundstream_multi_scale_discriminator", "soundstream_complex_stft_discriminator")
# the GAN step's discriminators: JAX's bf16 step takes the complex-STFT one (its STFT
# is fp32, so its convs run in fp32 in both packages)
EXTRA_GAN = {"disc_conf_list": [{"name": "hifigan_multi_scale_multi_period_discriminator"},
                                {"name": "soundstream_multi_scale_discriminator"},
                                {"name": "soundstream_complex_stft_discriminator"}]}
EXTRA_GAN_STEPS = 2
HIFIGAN_B, HIFIGAN_FRAMES = 4, 200
FBANK_B, FBANK_SECONDS = 8, 10.0
# Card vs CPU in the power domain: |P_card - P_cpu| over each frame's largest mel bin, P the
# exp of the log-mel that the CMVN is undone from (a log-mel difference is dominated by fp32
# rounding in low-power bins). The limit sits between fp32 rounding and what the card reads
# for the waveform rounded to fp16, a control that the check must reject
FBANK_POWER_TOL = 5e-5


def _card_cpu_rel(card_t, cpu_t) -> float:
    a, b = card_t.detach().cpu(), cpu_t.detach()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def extras_hifigan(dev, card: str) -> dict:
    cfg = HiFiGANConfig()
    cpu = HiFiGANGenerator(cfg, device="cpu", generator=torch.Generator().manual_seed(11))
    gpu = HiFiGANGenerator(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(11))
    gpu.load_state_dict(cpu.state_dict())
    c = torch.from_numpy(np.random.RandomState(62).randn(HIFIGAN_B, cfg.in_channels, HIFIGAN_FRAMES).astype(np.float32))
    with torch.no_grad():
        y_cpu = cpu(c)
        y_gpu = gpu(c.to(dev))
        ms = timeit(lambda: gpu(c.to(dev)), dev, warmup=1, iters=3) * 1e3
    rel = _card_cpu_rel(y_gpu, y_cpu)
    n_params = sum(p.numel() for p in gpu.parameters())
    log(f"[extras] HiFiGAN generator ({n_params} parameters, {cfg.in_channels} mels, {cfg.channels} channels, "
        f"x{cfg.upsample_factor}) B={HIFIGAN_B} x {HIFIGAN_FRAMES} frames -> {tuple(y_gpu.shape)}: card vs CPU "
        f"{rel:.3e} of the output's scale (limit {EXTRA_REL:.0e}); {ms:.3f} ms on the card ({card})")
    if y_gpu.shape != (HIFIGAN_B, 1, HIFIGAN_FRAMES * 256) or not torch.isfinite(y_gpu).all() or rel > EXTRA_REL:
        raise RuntimeError("extras: the HiFiGAN generator on the card disagrees with the CPU")
    return dict(params=n_params, rel=rel, ms=ms)


def extras_discriminators(dev) -> dict:
    x = torch.from_numpy(_speech(63, 2, 1.0))
    out = {}
    for name in EXTRA_DISCS:
        conf = {"disc_conf_list": [{"name": name}]}
        cpu = build_discriminator(conf, device="cpu", generator=torch.Generator().manual_seed(12))
        gpu = build_discriminator(conf, device=dev, generator=torch.Generator(device=dev).manual_seed(12))
        gpu.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            o_cpu, o_gpu = cpu(x), gpu(x.to(dev))
        worst, n = 0.0, 0
        for (lg, fg), (lc, fc) in zip(o_gpu, o_cpu, strict=True):
            for a, b in [(lg, lc)] + list(zip(fg, fc, strict=True)):
                if a.shape != b.shape or not torch.isfinite(a).all():
                    raise RuntimeError(f"extras {name}: {tuple(a.shape)} on the card, {tuple(b.shape)} on the CPU")
                worst = max(worst, _card_cpu_rel(a, b))
                n += 1
        out[name] = dict(outputs=len(o_gpu), tensors=n, rel=worst,
                         params=sum(p.numel() for p in gpu.parameters()))
        log(f"[extras] {name} (defaults, {out[name]['params']} parameters) B=2 x 1 s fp32: {len(o_gpu)} outputs, "
            f"{n} logits and fmaps, card vs CPU {worst:.3e} of each tensor's scale (limit {EXTRA_REL:.0e})")
        if worst > EXTRA_REL:
            raise RuntimeError(f"extras {name}: the card disagrees with the CPU")
    return out


def extras_gan(dev, held: dict) -> dict:
    """EXTRA_GAN_STEPS bf16 shared steps of the flagship generator (the yaml's
    quantizer, both SEANet flags) against EXTRA_GAN's discriminators at
    B = 16 x 2.56 s: launches exact per step, each kernel call held against
    its plain version, finite stats, both modules moved."""
    _set_seanet_flags(True)
    state, step = build_trainer(dev, True, torch.bfloat16, disc_conf=EXTRA_GAN)
    speech = _train_speech(dev, TRAIN_B, seed=47)
    gen = torch.Generator(device=dev).manual_seed(13)
    before_g, before_d = _masters(state)
    stats = []
    for i in range(EXTRA_GAN_STEPS):
        state, s = _held_part(f"gan step {i}", TRAIN_EXPECT, lambda: step(state, {"speech": speech}, gen), held,
                              tag="extras")
        stats.append(_floats(s))
    _set_seanet_flags(False)
    after_g, after_d = _masters(state)
    moved = [any(not torch.equal(a, b) for a, b in zip(x, y)) for x, y in ((before_g, after_g), (before_d, after_d))]
    n_disc = sum(p.numel() for p in state.discriminator.parameters())
    if not all(moved) or state.step != EXTRA_GAN_STEPS:
        raise RuntimeError(f"extras gan: moved (generator, discriminator) {moved}, step {state.step}")
    log(f"[extras] bf16 shared steps, both SEANet flags, B={TRAIN_B} x {TRAIN_SECONDS} s, against HiFiGAN MSMPD + "
        f"SoundStream + complex-STFT ({n_disc} discriminator parameters): {EXTRA_GAN_STEPS} steps, launches per step "
        f"{TRAIN_EXPECT}, stats finite (step 0: generator_loss {stats[0]['generator_loss']:.4f}, discriminator_loss "
        f"{stats[0]['discriminator_loss']:.4f}), both modules moved")
    del state, step
    torch.cuda.empty_cache()
    return dict(stats=stats, disc_params=n_disc)


def extras_gan_timing(dev, card: str) -> dict:
    """The steady bf16 shared step (both SEANet flags, initialized codebooks)
    against EXTRA_GAN's discriminators and against the MS-STFT one: ms a step,
    best of 3 after a warm-up, and peak memory."""
    _set_seanet_flags(True)
    rows = {}
    for name, disc_conf in (("extras", EXTRA_GAN), ("ms-stft", None)):
        state, step = build_trainer(dev, True, torch.bfloat16, disc_conf=disc_conf, **STEADY)
        batch = {"speech": _train_speech(dev, TRAIN_B, seed=43)}
        g = torch.Generator(device=dev).manual_seed(8)
        state, _ = step(state, batch, g)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            state, s = step(state, batch, g)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        _floats(s)
        rows[name] = dict(ms=best * 1e3, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del state, step, batch
        torch.cuda.empty_cache()
    _set_seanet_flags(False)
    log(f"[extras] steady bf16 shared step, both SEANet flags, B={TRAIN_B} x {TRAIN_SECONDS} s: against the extra "
        f"discriminators {rows['extras']['ms']:.1f} ms a step, peak {rows['extras']['peak_gib']:.2f} GiB; against "
        f"the MS-STFT one {rows['ms-stft']['ms']:.1f} ms, {rows['ms-stft']['peak_gib']:.2f} GiB ({card})")
    return rows


def extras_fbank(dev, card: str) -> dict:
    d = OUT_DIR / "extras"
    d.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(64)
    dim = 80 * 7
    feats = rs.randn(1000, dim) * 3.0 + 5.0
    (d / "cmvn.txt").write_text("[ " + " ".join(map(str, list(feats.sum(0)) + [1000])) + "\n"
                                + " ".join(map(str, list((feats**2).sum(0)) + [0])) + " ]")
    kw = dict(n_mels=80, lfr_m=7, lfr_n=6, cmvn_file=str(d / "cmvn.txt"))
    fe_gpu, fe_cpu = WavFrontend(**kw, device=dev), WavFrontend(**kw, device="cpu")
    wav = torch.from_numpy(_speech(65, FBANK_B, FBANK_SECONDS))
    y_gpu, y_cpu = fe_gpu(wav.to(dev)), fe_cpu(wav)
    shift, scale = (c.double() for c in fe_cpu.cmvn)

    def power_err(y) -> float:  # relative to each frame's largest bin of the CPU's
        p, p_cpu = ((t.cpu().double() / scale - shift).reshape(*t.shape[:2], 7, 80).exp() for t in (y, y_cpu))
        return float(((p - p_cpu).abs() / p_cpu.amax(-1, keepdim=True)).max())

    err, log_err = power_err(y_gpu), float((y_gpu.cpu() - y_cpu).abs().max())
    control = power_err(fe_gpu(wav.half().float().to(dev)))  # the waveform rounded to fp16
    ms = timeit(lambda: fe_gpu(wav.to(dev)), dev, warmup=1, iters=3) * 1e3
    log(f"[extras] WavFrontend (80 mels, LFR 7/6, a seeded CMVN) B={FBANK_B} x {FBANK_SECONDS} s -> "
        f"{tuple(y_gpu.shape)}: card vs CPU power error {err:.3e} of each frame's largest bin (limit "
        f"{FBANK_POWER_TOL:.1e}; the fp16-rounded waveform reads {control:.3e}), CMVN'd log-mel max|err| "
        f"{log_err:.3e}; {ms:.3f} ms on the card ({card})")
    if y_gpu.shape != (FBANK_B, math.ceil((1 + (int(FBANK_SECONDS * SR) - 400) // 160) / 6), dim) or err > FBANK_POWER_TOL:
        raise RuntimeError("extras: WavFrontend on the card disagrees with the CPU")
    if control <= FBANK_POWER_TOL:
        raise RuntimeError("extras: the WavFrontend check passes an fp16-rounded waveform: it cannot see that error")
    return dict(power_rel_err=err, limit=FBANK_POWER_TOL, fp16_control_power_rel_err=control, log_mel_max_abs_err=log_err,
                ms=ms)


def extras_entropy(tokens: torch.Tensor) -> dict:
    """compress_tokens / decompress_tokens over each row of the streamed tokens."""
    sizes, ms = [], 0.0
    for b in range(tokens.shape[1]):
        rows = tokens[:, b].T.contiguous()  # (T, n_q)
        t0 = time.perf_counter()
        blob = compress_tokens(rows, STREAM_CONFIG["quantizer_conf"]["codebook_size"], SR, 320)
        ms += (time.perf_counter() - t0) * 1e3
        if not np.array_equal(decompress_tokens(blob), rows.numpy()):
            raise RuntimeError("extras: decompress_tokens does not give back the streamed tokens")
        sizes.append(len(blob))
    bits = 8 * sum(sizes) / tokens.numel()
    log(f"[extras] .ecdc of the streamed tokens ({tuple(tokens.shape)}): {sizes} bytes ({bits:.3f} bits a token), "
        f"compress {ms:.1f} ms in all on the host, decompressed equal")
    return dict(bytes=sizes, bits_per_token=bits, compress_ms=ms)


def extras_phase(dev, card: str, stream_tokens: torch.Tensor) -> dict:
    """Phase 16: the HiFiGAN generator and the seven extra discriminators on
    the card against the CPU; the GAN step with the extra discriminators
    (every count set to 0 before its steps, read after); WavFrontend; the
    .ecdc round trip of the streamed tokens."""
    t_phase = time.perf_counter()
    hifigan = extras_hifigan(dev, card)
    discs = extras_discriminators(dev)
    held = dict(max_abs_err={}, calls=0, launches={})
    _sync(dev)
    reset_counts()
    gan = extras_gan(dev, held)
    _sync(dev)
    counts = read_counts()
    expect = {k: sum(part[k] for part in held["launches"].values()) for k in counts}
    if counts != expect:
        raise RuntimeError(f"extras: launches {counts}, the steps' sum {expect}")
    gan["timing"] = extras_gan_timing(dev, card)
    fbank = extras_fbank(dev, card)
    entropy = extras_entropy(stream_tokens)
    log(f"[extras] launches {counts}, {held['calls']} kernel calls held against their plain versions "
        f"(max|err| {held['max_abs_err']}); phase {time.perf_counter() - t_phase:.2f} s")
    return dict(launches=counts, max_abs_err=held["max_abs_err"], held_calls=held["calls"], hifigan=hifigan,
                discriminators=discs, gan=gan, fbank=fbank, entropy=entropy, phase_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# JAX checkpoint phase: the JAX package's .ckpt files served and averaged
# ---------------------------------------------------------------------------

JAX_CKPT_DIR = OUT_DIR / "jax_ckpt"
JAX_CKPT_B, JAX_CKPT_SECONDS = 8, 10.0
JAX_CKPT_AVERAGED = 3  # seeded flagship epochs averaged by cli/average_nbest
JAX_CKPT_GROUPS = 50  # the zero-shot request's token groups (random weights never emit eos)


def _same_state(got: dict, want: dict, what: str) -> None:
    """Every tensor of `want` in `got`, bit for bit."""
    if set(got) != set(want):
        raise RuntimeError(f"jax_ckpt {what}: names {sorted(set(got) ^ set(want))[:4]} differ")
    for k, v in want.items():
        if not torch.equal(got[k].cpu(), v.cpu()):
            raise RuntimeError(f"jax_ckpt {what}: {k} is not the same bit for bit")


def _timed_load(fn, dev) -> float:
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    return time.perf_counter() - t0


def jax_ckpt_flagship(dev, held: dict) -> dict:
    """The seeded flagship as the JAX package's weights file (its tree by
    compat/torch_import, its bytes by compat/flax_msgpack, as JAX's
    save_weights writes them; tests/test_torch_jax_ckpt.py holds both
    byte-equal to JAX's), back bit for bit, then served from .ckpt and from
    .pth: B = 8 x 10 s in fp32 (flags off) and in bf16 with the three flags,
    tokens and recon bit-equal between the two files."""
    from funcodec_tpu_torch.compat import torch_import
    from funcodec_tpu_torch.train.checkpoint import load_jax_checkpoint_params, save_jax_weights

    config = _flagship_config()
    model, _ = build_codec_model(config, device="cpu", generator=torch.Generator().manual_seed(21))
    sd = model.state_dict()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != GEN_PARAMS:
        raise RuntimeError(f"jax_ckpt: the flagship has {n_params} parameters, expected {GEN_PARAMS}")
    ckpt, pth = JAX_CKPT_DIR / "flagship.ckpt", JAX_CKPT_DIR / "flagship.pth"
    t0 = time.perf_counter()
    save_jax_weights(str(ckpt), *torch_import.import_encodec(sd, model))
    write_s = time.perf_counter() - t0
    torch.save(sd, pth)
    back, _ = build_codec_model(config, device=dev, generator=torch.Generator(device=dev).manual_seed(22))
    load_s = _timed_load(lambda: load_jax_checkpoint_params(str(ckpt), back), dev)
    pth_load_s = _timed_load(lambda: back.load_state_dict(torch.load(pth, map_location="cpu", weights_only=True)),
                             dev)
    load_jax_checkpoint_params(str(ckpt), back)
    _same_state(back.state_dict(), sd, "flagship .ckpt on the card")
    del back
    x = _speech(70, JAX_CKPT_B, JAX_CKPT_SECONDS)
    served = {}
    for dtype in ("float32", "bfloat16"):
        if dtype == "float32":  # the fp32-exact path
            conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = rvq.FUSED_RVQ = False
            expect = NO_LAUNCHES
        else:
            set_flags(MAIN_PATH)
            expect = EXPECT[MAIN_PATH]
        outs = {}
        for kind, path in (("ckpt", ckpt), ("pth", pth)):
            s2t = Speech2Token(config, str(path), dtype=dtype, device=dev)
            outs[kind] = _held_part(f"serve {dtype} .{kind}", expect, lambda: s2t(x, bit_width=None), held,
                                    tag="jax_ckpt")
            del s2t
        (c_ckpt, _, r_ckpt, _), (c_pth, _, r_pth, _) = outs["ckpt"], outs["pth"]
        _check_output(f"jax_ckpt {dtype}", c_ckpt, r_ckpt, config["quantizer_conf"]["num_quantizers"])
        if not (np.array_equal(c_ckpt[0], c_pth[0]) and np.array_equal(r_ckpt, r_pth)):
            raise RuntimeError(f"jax_ckpt {dtype}: the .ckpt and .pth weights serve different tokens or recon")
        served[dtype] = c_ckpt[0]
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = rvq.FUSED_RVQ = False
    q0, all_ = _flips(served["bfloat16"], served["float32"])
    out = dict(params=n_params, ckpt_bytes=os.path.getsize(ckpt), pth_bytes=os.path.getsize(pth), write_s=write_s,
               load_s=load_s, pth_load_s=pth_load_s, bf16_vs_fp32_flips=dict(q0=q0, all=all_))
    log(f"[jax_ckpt] flagship ({n_params} parameters) as a JAX weights file: {out['ckpt_bytes']} bytes (.pth "
        f"{out['pth_bytes']}), written in {write_s:.3f} s, loaded onto the card in {load_s:.3f} s (.pth "
        f"{pth_load_s:.3f} s), its state_dict bit for bit; B={JAX_CKPT_B} x {JAX_CKPT_SECONDS} s served from .ckpt "
        f"and from .pth: fp32 (flags off) and bf16 (the three flags, launches {EXPECT[MAIN_PATH]} a request) tokens "
        f"and recon bit-equal; bf16 vs fp32 flips q0 {q0:.5f} all {all_:.5f}")
    return out


def jax_ckpt_laura(dev, held: dict) -> dict:
    """The shipped LauraTTS yaml at full width (seeded, the 256-word list,
    the flagship's codebooks grafted) as a JAX weights file, and one seeded
    zero-shot request through Text2Audio from .ckpt (the codec from
    flagship.ckpt) and from .pth, the codec in bf16 with the three flags:
    launches exact, the tokens and the wavs equal."""
    import yaml

    from funcodec_tpu_torch.cli.text2audio_inference import Text2Audio
    from funcodec_tpu_torch.compat import torch_import
    from funcodec_tpu_torch.tasks.text2audio import build_laura_model
    from funcodec_tpu_torch.train.checkpoint import load_jax_params, save_jax_weights

    d = JAX_CKPT_DIR
    codec_config = _flagship_config()
    (d / "codec.yaml").write_text(yaml.safe_dump(codec_config))
    config = yaml.safe_load(TTS_YAML.read_text())
    config["audio_max_duration"] = TTS_CLI_SECONDS
    (d / "laura.yaml").write_text(yaml.safe_dump(config))
    tokens = [f"w{i:03d}" for i in range(TTS_VOCAB)]
    (d / "tokens.txt").write_text("".join(f"{t}\n" for t in tokens))
    model = build_laura_model(config, token_list=tokens, device="cpu", generator=torch.Generator().manual_seed(23))
    codec_sd = torch.load(d / "flagship.pth", map_location="cpu", weights_only=True)
    with torch.no_grad():
        model.quantizer_codebook.embed.copy_(codec_sd["quantizer.rq.model.embed"])
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != TTS_PARAMS:
        raise RuntimeError(f"jax_ckpt: LauraTTS parameters {n_params}, expected {TTS_PARAMS}")
    sd = model.state_dict()
    t0 = time.perf_counter()
    save_jax_weights(str(d / "laura.ckpt"), torch_import.import_laura(sd, model))
    write_s = time.perf_counter() - t0
    torch.save(sd, d / "laura.pth")
    del model
    rs = np.random.RandomState(54)
    text = " ".join(tokens[i] for i in rs.randint(0, TTS_VOCAB, 20))
    prompt = (0.1 * rs.randn(2 * SR)).astype(np.float32)
    set_flags(MAIN_PATH)
    outs, toks, load = {}, {}, {}
    for kind, codec_file in (("ckpt", "flagship.ckpt"), ("pth", "flagship.pth")):
        files = [str(d / n) for n in ("laura.yaml", f"laura.{kind}", "codec.yaml", codec_file)]
        pipe = Text2Audio(*files, token_list=str(d / "tokens.txt"), token_type="word", device=dev)
        pipe.codec = Speech2Token(str(d / "codec.yaml"), str(d / codec_file), dtype="bfloat16", device=dev)
        if kind == "ckpt":
            _same_state(pipe.model.state_dict(), sd, "laura .ckpt on the card")
            load["ckpt"] = _timed_load(lambda: load_jax_params(str(d / "laura.ckpt"), pipe.model), dev)
        else:
            load["pth"] = _timed_load(lambda: pipe.model.load_state_dict(
                torch.load(d / "laura.pth", map_location="cpu", weights_only=True)), dev)
        decoded, inner = [], pipe.model.decode_codec

        def recorded(*a, **kw):
            decoded.append(inner(*a, **kw))
            return decoded[-1]

        pipe.model.decode_codec = recorded
        outs[kind] = _held_part(f"zero-shot request .{kind}", TTS_EXPECT,
                                lambda: pipe(text, prompt_audio=prompt, max_length=JAX_CKPT_GROUPS), held,
                                tag="jax_ckpt")
        toks[kind] = np.asarray(decoded[0])
        del pipe
    conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = rvq.FUSED_RVQ = False
    if toks["ckpt"].shape[-1] != config["model_conf"]["predict_nq"] or not np.array_equal(toks["ckpt"], toks["pth"]):
        raise RuntimeError(f"jax_ckpt laura: tokens {toks['ckpt'].shape} from .ckpt differ from the .pth path's")
    for tag in ("gen", "gen_only_lm"):
        if outs["ckpt"][tag].shape != (JAX_CKPT_GROUPS * 320,) or not np.array_equal(outs["ckpt"][tag],
                                                                                     outs["pth"][tag]):
            raise RuntimeError(f"jax_ckpt laura: {tag} from .ckpt differs from the .pth path's")
    out = dict(params=n_params, ckpt_bytes=os.path.getsize(d / "laura.ckpt"),
               pth_bytes=os.path.getsize(d / "laura.pth"), write_s=write_s, load_s=load["ckpt"],
               pth_load_s=load["pth"], token_shape=list(toks["ckpt"].shape))
    log(f"[jax_ckpt] LauraTTS ({n_params} parameters) as a JAX weights file: {out['ckpt_bytes']} bytes (.pth "
        f"{out['pth_bytes']}), written in {write_s:.3f} s, loaded onto the card in {load['ckpt']:.3f} s (.pth "
        f"{load['pth']:.3f} s), bit for bit; one zero-shot request (20 words, a 2 s prompt, top-k 25 seeded, "
        f"{JAX_CKPT_GROUPS} groups, the codec in bf16 with the three flags, launches {TTS_EXPECT}) from .ckpt "
        f"and from .pth: tokens {tuple(toks['ckpt'].shape)} and both wavs equal")
    return out


def jax_ckpt_average(held: dict) -> dict:
    """cli/average_nbest over JAX_CKPT_AVERAGED seeded flagship epochs as
    .ckpt files and as .pth files: the averaged .ckpt, loaded, is the
    averaged .pth bit for bit."""
    import yaml

    from funcodec_tpu_torch.cli import average_nbest
    from funcodec_tpu_torch.compat import torch_import
    from funcodec_tpu_torch.train.checkpoint import load_jax_checkpoint_params, save_jax_weights, save_weights

    config = _flagship_config()
    crit = [3.0, 1.0, 2.0, 4.0][:JAX_CKPT_AVERAGED]
    report = {"stats": {str(e + 1): {"valid": {"generator_multi_spectral_recon_loss": c}} for e, c in enumerate(crit)},
              "epoch": JAX_CKPT_AVERAGED}
    exps = {k: JAX_CKPT_DIR / f"exp_{k}" for k in ("ckpt", "pth")}
    for exp in exps.values():
        exp.mkdir()
        (exp / "config.yaml").write_text(yaml.safe_dump(config))
        (exp / "reporter.json").write_text(json.dumps(report))
    for e in range(1, JAX_CKPT_AVERAGED + 1):
        model, _ = build_codec_model(config, device="cpu", generator=torch.Generator().manual_seed(30 + e))
        save_jax_weights(str(exps["ckpt"] / f"{e}epoch.ckpt"), *torch_import.import_encodec(model.state_dict(), model))
        save_weights(str(exps["pth"] / f"{e}epoch.pth"), model)
    args = ["--nbest", str(JAX_CKPT_AVERAGED)]
    t0 = time.perf_counter()
    out_ckpt = _held_part("average_nbest .ckpt", NO_LAUNCHES,
                          lambda: average_nbest.main(["--exp_dir", str(exps["ckpt"]), *args]), held, tag="jax_ckpt")
    ckpt_s = time.perf_counter() - t0
    out_pth = average_nbest.main(["--exp_dir", str(exps["pth"]), *args])
    name = f"valid.generator_multi_spectral_recon_loss.ave_{JAX_CKPT_AVERAGED}best"
    if (Path(out_ckpt).name, Path(out_pth).name) != (f"{name}.ckpt", f"{name}.pth"):
        raise RuntimeError(f"jax_ckpt average_nbest wrote {out_ckpt}, {out_pth}")
    model, _ = build_codec_model(config, device="cpu", generator=torch.Generator().manual_seed(39))
    load_jax_checkpoint_params(out_ckpt, model)
    _same_state(model.state_dict(), torch.load(out_pth, map_location="cpu", weights_only=True), "average")
    log(f"[jax_ckpt] cli/average_nbest over {JAX_CKPT_AVERAGED} seeded flagship epochs: the averaged .ckpt "
        f"({os.path.getsize(out_ckpt)} bytes, {ckpt_s:.3f} s on the host) loads to the averaged .pth bit for bit")
    return dict(epochs=JAX_CKPT_AVERAGED, ckpt_bytes=os.path.getsize(out_ckpt), wall_s=ckpt_s)


def jax_ckpt_phase(dev, card: str) -> dict:
    """Phase 17: the JAX package's checkpoint format on the card: the
    flagship served from .ckpt, the LauraTTS request from .ckpt, the n-best
    average of .ckpt files; every count set to 0 before the phase and read
    after, each kernel call held against its plain version."""
    t_phase = time.perf_counter()
    shutil.rmtree(JAX_CKPT_DIR, ignore_errors=True)
    JAX_CKPT_DIR.mkdir(parents=True)
    held = dict(max_abs_err={}, calls=0, launches={})
    _sync(dev)
    reset_counts()
    flagship = jax_ckpt_flagship(dev, held)
    laura = jax_ckpt_laura(dev, held)
    average = jax_ckpt_average(held)
    _sync(dev)
    counts = read_counts()
    expect = {k: sum(part[k] for part in held["launches"].values()) for k in counts}
    if counts != expect:
        raise RuntimeError(f"jax_ckpt: launches {counts}, the parts' sum {expect}")
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"[jax_ckpt] launches {counts}, {held['calls']} kernel calls held against their plain versions (max|err| "
        f"{held['max_abs_err']}); phase {phase_s:.2f} s ({card})")
    return dict(launches=counts, max_abs_err=held["max_abs_err"], held_calls=held["calls"], flagship=flagship,
                laura=laura, average=average, phase_s=phase_s)


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
    sync = sync_phase(dev, s_bf)
    probe_rows, probe_launches, probe_plain, ceiling = probe_phase(dev, card)
    cli_stats = cli_phase(dev, config, s_fp, card)
    rvq_row, conv_rows, rb_rows, fin_row, serving = timing_phase(dev, s_bf, s_fp, calls, card, ceiling)
    del s_bf, s_fp, calls
    torch.cuda.empty_cache()
    train_results, train_counts = training_phase(dev)
    fused_grads = fused_grad_phase(dev)
    backward_rows, backward_errs, train_fwd_errs = backward_phase(dev, card)
    card_cpu = card_cpu_phase(dev)
    train_rows = training_timing(dev, card)
    trainer = trainer_phase(dev, card, train_rows)
    tts = tts_phase(dev, card)
    freq = freq_phase(dev, card)
    laura = laura_phase(dev, card)
    dp = dp_phase(dev, card)
    recipe = recipe_phase(dev, card)
    streaming = streaming_phase(dev, card)
    extras = extras_phase(dev, card, streaming.pop("tokens_fp32"))
    jax_ckpt = jax_ckpt_phase(dev, card)
    if "funcodec_tpu" in sys.modules or ("jax" in sys.modules and not _JAX_PRELOADED):
        raise RuntimeError("the port imported JAX or the JAX package")

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "timings.json").write_text(json.dumps(dict(
        card=card, rvq=rvq_row, conv=conv_rows, resblock=rb_rows, resblock_finalize=fin_row, serving_seconds=serving,
        flips=flips, launches=counts, sync=sync, probe=probe_rows, probe_launches=probe_launches,
        copy_ceiling_bytes_per_s=ceiling, cli=cli_stats, training=dict(
            configs=train_results, launches=train_counts, fused_gradients=fused_grads, backward=backward_rows,
            backward_max_relative_error=backward_errs, forward_max_abs_error=train_fwd_errs,
            card_vs_cpu=card_cpu, timing=train_rows), trainer=trainer, tts=tts, freqcodec=freq, laura=laura,
        data_parallel=dp, recipe=recipe, streaming=streaming, extras=extras, jax_ckpt=jax_ckpt),
        indent=1))
    conv_main = _summed([r for r in conv_rows if r["main_path"]])
    conv_main["library_ms"] = sum(r["library_ms"] for r in conv_rows if r["main_path"])
    conv_main["legacy_ms"] = sum(r["legacy_ms"] for r in conv_rows if r["main_path"])
    rb_main = _summed(rb_rows, n=2)  # the encoder's and the decoder's block at each width
    rb_main["library_ms"] = None
    rb_main["unfused_ms"] = 2 * sum(r["unfused_ms"] for r in rb_rows)
    rb_main["legacy_ms"] = 2 * sum(r["legacy_ms"] for r in rb_rows)
    backward = {k: {f"backward_{m}": v for m, v in _summed(rows).items() if m != "bound_by"}
                for k, rows in backward_rows.items()}
    kernels = [
        dict(name="rvq_encode", route="cuda", source="funcodec_tpu_torch/csrc/rvq_encode.cu",
             replaces="funcodec_tpu/quant/rvq_pallas.py:29", launches=counts["rvq_encode"],
             max_abs_err=rvq_err, ms=rvq_row["ms"], plain_ms=rvq_row["plain_ms"],
             bound_ms=rvq_row["bound_ms"], bound_by=rvq_row["bound_by"], library_ms=None,
             legacy_ms=rvq_row["legacy_ms"]),
        dict(name="conv1d_s1", route="cuda", source="funcodec_tpu_torch/csrc/conv1d_s1.cu",
             replaces="funcodec_tpu/ops/conv_pallas.py:59", launches=counts["conv1d_s1"],
             max_abs_err=seanet_errs["conv1d_s1"], **conv_main, **backward["conv1d_s1"],
             backward_max_rel_err=backward_errs["conv1d_s1"],
             training_max_abs_err=train_fwd_errs["conv1d_s1"]),
        dict(name="resblock_tgn", route="cuda", source="funcodec_tpu_torch/csrc/resblock_tgn.cu",
             replaces="funcodec_tpu/ops/resblock_pallas.py:86", launches=counts["resblock_tgn"],
             max_abs_err=seanet_errs["resblock_tgn"], **rb_main, **backward["resblock_tgn"],
             backward_max_rel_err=backward_errs["resblock_tgn"],
             training_max_abs_err=train_fwd_errs["resblock_tgn"]),
        # the affines between the passes: plain JAX beside the TPU kernel, a kernel of its own here
        dict(name="resblock_tgn_finalize", route="cuda", source="funcodec_tpu_torch/csrc/resblock_tgn.cu",
             replaces="funcodec_tpu/ops/resblock_pallas.py:232", launches=counts["resblock_tgn_finalize"],
             max_abs_err=seanet_errs["resblock_tgn_finalize"],
             **{k: fin_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
    ]
    for name, variant in (("scale_copy", "A tile=4000"), ("dma_copy", "D dma_copy")):
        row = next(r for r in probe_rows if r["name"] == variant)  # bf16 at the probe shape
        kernels.append(dict(
            name=name, route="cuda", source="funcodec_tpu_torch/csrc/copy_probe.cu",
            replaces=REPLACES[name], launches=probe_launches[name], max_abs_err=0.0, ms=row["ms"],
            plain_ms=probe_plain[torch.bfloat16], bound_ms=row["bound_ms"], bound_by="bytes",
            library_ms=row["library_ms"]))
    # the training phase's fused steps, the trainer phase's two-epoch run, a TTS request, the
    # FreqCodec main-path requests (gr8 and gr1), the Laura recipe's stages 1 and 3, the
    # data-parallel phase's NCCL world-1 steps and serving replicas, the recipe phase's path,
    # the streaming session's bf16 stream, the extras phase's GAN steps and the JAX checkpoint phase's
    # requests
    for k in kernels:
        k["training_launches"] = train_counts.get(k["name"], 0)
        k["trainer_launches"] = trainer["launches"].get(k["name"], 0)
        k["tts_launches"] = tts["kernels"]["launches"].get(k["name"], 0)
        if k["name"] in tts["kernels"]["max_abs_err"]:  # the request's own calls against the plain version
            k["tts_max_abs_err"] = tts["kernels"]["max_abs_err"][k["name"]]
        k["freqcodec_launches"] = freq["launches"].get(k["name"], 0)
        if k["name"] in freq["max_abs_err"]:
            k["freqcodec_max_abs_err"] = freq["max_abs_err"][k["name"]]
        k["laura_launches"] = laura["launches"].get(k["name"], 0)
        if k["name"] in laura["max_abs_err"]:
            k["laura_max_abs_err"] = laura["max_abs_err"][k["name"]]
        k["dp_launches"] = dp["launches"].get(k["name"], 0)
        if k["name"] in dp["max_abs_err"]:  # the gloo ranks' own calls against the plain version
            k["dp_max_abs_err"] = dp["max_abs_err"][k["name"]]
        k["recipe_launches"] = recipe["launches"].get(k["name"], 0)
        if k["name"] in recipe["max_abs_err"]:
            k["recipe_max_abs_err"] = recipe["max_abs_err"][k["name"]]
        # the worst held call per kernel, null for a kernel that no held call reaches; a held
        # resblock_tgn call holds the block's output, so its finalizes too
        held_as = "resblock_tgn" if k["name"] == "resblock_tgn_finalize" else k["name"]
        for phase, res in (("streaming", streaming), ("extras", extras), ("jax_ckpt", jax_ckpt)):
            k[f"{phase}_launches"] = res["launches"].get(k["name"], 0)
            k[f"{phase}_max_abs_err"] = res["max_abs_err"].get(held_as) if k[f"{phase}_launches"] else None
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
