"""Dump wav files into kaldi wav arks at a target sampling rate (port of
funcodec_tpu/cli/dump_to_wav_ark.py).

The data-prep step of the reference's egs/LibriTTS/codec/scripts/
dump_to_wav_ark.py (run.sh:123-147, under torchrun): read a wav.scp or a
wav list, resample each file to --sample_rate, and write sharded
wav.NN.ark / wav.NN.scp with length.NN.txt (sample counts, the input of
speech_shape batching), then the merged wav.scp and length.txt. One
process with --nj worker threads replaces the reference's rank / world
fork: the work is host I/O and resampling (data/wav_io.resample, the
JAX package's scipy resample_poly), so the files are byte for byte the JAX
CLI's.

    python -m funcodec_tpu_torch.cli.dump_to_wav_ark --wav_scp data/train/wav.scp \
        --out_dir dump/train --sample_rate 16000 --nj 4
"""

from __future__ import annotations

import argparse
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from funcodec_tpu_torch.data.wav_io import WavArkWriter, read_2column_text, read_wav, read_wav_ark_entry, resample


def _load_any(path: str, target_sr: int) -> np.ndarray:
    if ":" in path and path.rpartition(":")[2].isdigit():
        sr, wav = read_wav_ark_entry(path)
    else:
        sr, wav = read_wav(path)
    if wav.ndim > 1:  # downmix to mono (the reference's librosa mono=True)
        wav = wav.mean(axis=1)
    if sr != target_sr:
        wav = resample(wav, sr, target_sr)
    # rescaled only where it would clip (dump_to_wav_ark.py:76-77)
    mx = float(np.max(np.abs(wav))) if wav.size else 0.0
    if mx > 1.0:
        wav = wav / mx * 0.9
    return wav.astype(np.float32)


def dump_shard(recs, out_dir: str, shard: int, sample_rate: int) -> int:
    """One shard's ark, scp and lengths; returns the utterances written
    (unreadable files are skipped with a warning)."""
    ark = os.path.join(out_dir, f"wav.{shard:02d}.ark")
    scp = os.path.join(out_dir, f"wav.{shard:02d}.scp")
    lengths = os.path.join(out_dir, f"length.{shard:02d}.txt")
    n = 0
    with WavArkWriter(ark, scp) as w, open(lengths, "wt") as lf:
        for uttid, path in recs:
            try:
                wav = _load_any(path, sample_rate)
            except (OSError, ValueError) as e:
                logging.warning("skip %s: %s", uttid, e)
                continue
            w(uttid, sample_rate, wav)
            lf.write(f"{uttid} {len(wav)}\n")
            n += 1
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(description="dump wavs into sharded kaldi wav arks")
    parser.add_argument("--wav_scp", type=str, default=None)
    parser.add_argument("--wav_list", type=str, default=None)
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--nj", type=int, default=4, help="shards / worker threads")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.wav_scp:
        recs = sorted(read_2column_text(args.wav_scp).items())
    elif args.wav_list:
        with open(args.wav_list) as f:
            recs = sorted((os.path.basename(p).rsplit(".", 1)[0], p) for p in (line.strip() for line in f) if p)
    else:
        parser.error("need --wav_scp or --wav_list")

    os.makedirs(args.out_dir, exist_ok=True)
    nj = max(1, min(args.nj, len(recs)))
    shards = [recs[i::nj] for i in range(nj)]
    with ThreadPoolExecutor(nj) as ex:
        counts = list(ex.map(lambda s: dump_shard(shards[s], args.out_dir, s, args.sample_rate), range(nj)))
    # the merged indexes, as run.sh cats the per-rank scps (run.sh:141-145)
    for stem, suffix in (("wav", "scp"), ("length", "txt")):
        with open(os.path.join(args.out_dir, f"{stem}.{suffix}"), "wt") as out:
            for s in range(nj):
                with open(os.path.join(args.out_dir, f"{stem}.{s:02d}.{suffix}")) as part:
                    out.write(part.read())
    logging.info("dumped %d utterances into %d wav ark shards", sum(counts), nj)
    return sum(counts)


if __name__ == "__main__":
    main()
