"""Objective reconstruction-quality scoring over wav pairs (port of
funcodec_tpu/cli/codec_eval.py).

The recipe's last stage (egs/LibriTTS/codec/run.sh, where the reference
scores with ViSQOL in a docker image): given a reference wav.scp and a
directory (or scp) of reconstructions, it logs per-utterance and mean
metrics of utils/quality.reconstruction_metrics (LSD, multi-scale mel
distortion, SI-SNR, STOI, NSIM), writes them to ``quality.json`` and prints
the mean as one JSON line. Host-only numpy work.

    python -m funcodec_tpu_torch.cli.codec_eval --ref_scp data/test/wav.scp \
        --deg_dir exp/codec/decode --output_dir exp/codec/score
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from pathlib import Path

import numpy as np

from funcodec_tpu_torch.data.wav_io import read_2column_text, read_wav, resample
from funcodec_tpu_torch.utils.quality import reconstruction_metrics


def _find_deg(deg_dir: str, key: str):
    for pattern in (f"{key}.wav", f"{key}_rec.wav", f"{key}_fake.wav", f"{key}_gen.wav"):
        p = Path(deg_dir) / pattern
        if p.exists():
            return str(p)
    return None


def _mono_at(path: str, sr: int) -> np.ndarray:
    file_sr, x = read_wav(path)
    if x.ndim == 2:
        x = x[:, 0]
    return resample(x, file_sr, sr) if file_sr != sr else x


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="codec reconstruction scoring")
    parser.add_argument("--ref_scp", type=str, required=True)
    parser.add_argument("--deg_scp", type=str, default=None)
    parser.add_argument("--deg_dir", type=str, default=None)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--sampling_rate", type=int, default=16000)
    args = parser.parse_args(argv)
    if not (args.deg_scp or args.deg_dir):
        parser.error("need --deg_scp or --deg_dir")

    logging.basicConfig(level=logging.INFO)
    refs = read_2column_text(args.ref_scp)
    degs = read_2column_text(args.deg_scp) if args.deg_scp else {}

    per_utt = {}
    for key, ref_path in refs.items():
        deg_path = degs.get(key) or (args.deg_dir and _find_deg(args.deg_dir, key))
        if not deg_path:
            logging.warning("no reconstruction for %s; skipped", key)
            continue
        ref, deg = _mono_at(ref_path, args.sampling_rate), _mono_at(deg_path, args.sampling_rate)
        per_utt[key] = m = reconstruction_metrics(ref, deg, sr=args.sampling_rate)
        logging.info("%s: lsd %.3f dB, mel_dist %.4f, si_snr %.2f dB", key, m["lsd_db"], m["mel_distortion"],
                     m["si_snr_db"])

    if not per_utt:
        raise SystemExit("no scored pairs")
    mean = {k: float(np.mean([m[k] for m in per_utt.values()])) for k in next(iter(per_utt.values()))}
    os.makedirs(args.output_dir, exist_ok=True)
    result = {"mean": mean, "per_utt": per_utt}
    with open(Path(args.output_dir) / "quality.json", "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({"n": len(per_utt), **mean}))
    return result


if __name__ == "__main__":
    main()
