"""LauraTTS inference: text (+ an optional zero-shot prompt wav) -> waveforms
(port of funcodec_tpu/cli/text2audio_inference.py).

`Text2Audio` composes the port's LauraGenModel with the port's codec
(cli/codec_inference.Speech2Token). Each request writes two wavs: `gen`
(the non-AR dense embeddings through the codec's decode_emb) and
`gen_only_lm` (the AR tokens through the codec's decode), and `main` adds
tts_eval.json. Three decode modes: batch-1 (decode_codec), lockstep batches
(--batch_size > 1, decode_codec_batch) and continuous batching
(--serving_slots > 0, models/tts_serving.LauraServingSession).

Request k of a run (in scp order) samples with seed `seed + k` in every
mode, so the three modes give the same tokens.

    python -m funcodec_tpu_torch.cli.text2audio_inference --device cpu \\
        --config_file laura.yaml --model_file laura.pth \\
        --codec_config_file codec.yaml --codec_model_file codec.pth \\
        --text_scp text.scp --token_list tokens.txt --token_type word \\
        --output_dir out
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import yaml

from funcodec_tpu_torch.cli.codec_inference import Speech2Token
from funcodec_tpu_torch.data.text import TokenIDConverter, build_tokenizer
from funcodec_tpu_torch.data.wav_io import read_2column_text, read_wav, resample, save_audio
from funcodec_tpu_torch.models.laura import Sampling, pad_requests
from funcodec_tpu_torch.models.tts_serving import LauraServingSession
from funcodec_tpu_torch.tasks.text2audio import INIT_SEED, build_laura_model
from funcodec_tpu_torch.train.checkpoint import load_laura_weights
from funcodec_tpu_torch.utils.tts_quality import tts_metrics

EMPTY = {"gen": np.zeros((0,), np.float32), "gen_only_lm": np.zeros((0,), np.float32)}


class Text2Audio:
    """The composed TTS pipeline. `device` defaults to the card; without a
    model file the LM's weights are random, drawn with seed INIT_SEED. The
    LM's and the codec's model files are PyTorch state_dicts (.pth, .pt,
    .bin) or the JAX package's .ckpt files, by the suffix."""

    def __init__(
        self,
        config_file: str,
        model_file: Optional[str],
        codec_config_file: str,
        codec_model_file: Optional[str],
        token_list: Optional[str] = None,
        token_type: Optional[str] = None,
        sampling: Sampling = 25,  # top-k 25, as the demo
        seed: int = 0,
        *,
        device: Union[str, torch.device] = "cuda",
    ):
        with open(config_file) as f:
            self.config = yaml.safe_load(f)
        tokens = None
        if token_list:
            with open(token_list, encoding="utf-8") as f:
                tokens = [line.strip() for line in f if line.strip()]
        self.model = build_laura_model(self.config, token_list=tokens, device=device)
        self.device = self.model.device
        self.tokenizer = build_tokenizer(token_type) if token_type and tokens else None
        self.converter = TokenIDConverter(tokens) if tokens else None
        if model_file and os.path.exists(model_file):
            load_laura_weights(model_file, self.model)
        else:
            logging.warning("no LM checkpoint %s; random init (seed %d)", model_file, INIT_SEED)
        self.codec = Speech2Token(codec_config_file, codec_model_file, dtype="float32", device=self.device)
        self.sampling = sampling
        self.seed = int(seed)
        self.requests = 0  # requests decoded so far: request k samples with seed + k
        self.codec_token_rate = self.config.get("codec_token_rate", 25)
        self.max_duration = self.config.get("audio_max_duration", 30)

    def _next_seeds(self, n: int) -> List[int]:
        seeds = [self.seed + self.requests + i for i in range(n)]
        self.requests += n
        return seeds

    def _max_length(self, max_length: Optional[int]) -> int:
        return max_length or int(self.max_duration * self.codec_token_rate)

    def _text_to_features(self, text: Union[str, np.ndarray]) -> np.ndarray:
        """Raw text -> token ids (1, L); or ids / embeddings passed through."""
        if isinstance(text, str):
            assert self.tokenizer is not None and self.converter is not None, (
                "string inputs need --token_list/--token_type (or precomputed ids)")
            ids = self.converter.tokens2ids(self.tokenizer.text2tokens(text))
            return np.asarray(ids, np.int64)[None, :]
        text = np.asarray(text)
        if text.ndim == 1:
            return text[None, :]
        return text[None] if text.ndim == 2 and self.model.cfg.vocab_size == 0 else text

    def _prep_item(self, it):
        """(features (1, L[, D]), prompt tokens (P, nq)) of one request dict."""
        nq = self.model.cfg.predict_nq
        feats = self._text_to_features(it["text"])
        continual = np.zeros((0, nq), np.int64)
        if it.get("prompt_audio") is not None:
            # zero-shot: the prompt's codec tokens become the LM's codec prefix. The
            # inference mode without a reconstruction searches the codebooks as the
            # JAX CLI's encode mode does (the exact fp32 scan), or with the RVQ
            # kernel when FUSED_RVQ is on; the encode mode always scans
            token_id, *_ = self.codec(it["prompt_audio"][None, :], need_recon=False, run_mod="inference",
                                      bit_width=None)
            continual = np.asarray(token_id[0])[:nq, 0, :].T.astype(np.int64)
            if it.get("prompt_text") is not None:
                feats = np.concatenate([self._text_to_features(it["prompt_text"]), feats], axis=1)
        return feats, continual

    def _synthesize_tokens(self, tokens: np.ndarray, text_in: np.ndarray, gen_start: int) -> Dict[str, np.ndarray]:
        """AR tokens (1, T, nq) -> {'gen', 'gen_only_lm'} waveforms."""
        if tokens.shape[1] - gen_start <= 0:
            return dict(EMPTY)
        _, _, recon_lm, _ = self.codec(tokens[:, gen_start:, :], run_mod="decode", bit_width=None)

        def decode_emb(emb):
            return self.codec(emb, run_mod="decode_emb")[2]

        recon = self.model.syn_audio(tokens, text_in, np.array([text_in.shape[1]]), decode_emb,
                                     continual_length=gen_start)
        return {"gen": np.asarray(recon)[0], "gen_only_lm": np.asarray(recon_lm)[0]}

    def __call__(self, text, prompt_text=None, prompt_audio=None, max_length: Optional[int] = None):
        """One request through decode_codec -> {'gen': wav, 'gen_only_lm': wav}."""
        feats, continual = self._prep_item(dict(text=text, prompt_text=prompt_text, prompt_audio=prompt_audio))
        tokens = self.model.decode_codec(
            feats, np.array([feats.shape[1]]), max_length=self._max_length(max_length), sampling=self.sampling,
            seed=self._next_seeds(1)[0], continual=continual if len(continual) else None)
        return self._synthesize_tokens(tokens, feats, len(continual))

    def batch_synthesize(self, items, max_length: Optional[int] = None):
        """One decode_codec_batch over all rows; a list of {'gen', 'gen_only_lm'} in input order."""
        cfg = self.model.cfg
        preps = [self._prep_item(it) for it in items]
        B = len(items)
        text_pad, tl, prompt_pad, pl = pad_requests([f[0] for f, _ in preps], [p for _, p in preps],
                                                    cfg.predict_nq, cfg.ignore_id)
        Pmax = int(pl.max())
        rows = self.model.decode_codec_batch(
            text_pad, tl, max_length=self._max_length(max_length), sampling=self.sampling,
            seed=self._next_seeds(B), continual=prompt_pad if Pmax > 0 else None,
            continual_lengths=pl if Pmax > 0 else None)
        return [self._synthesize_tokens(row[None], f, p.shape[0]) for row, (f, p) in zip(rows, preps)]

    def serving_synthesize(self, items, max_length: Optional[int] = None, num_slots: int = 8):
        """Continuous batching over a LauraServingSession: a row that finishes
        frees its slot for a queued request; each request's audio is made
        as it finishes. {'gen', 'gen_only_lm'} dicts in input order."""
        preps = [self._prep_item(it) for it in items]
        budget = max(f.shape[1] + 2 + p.shape[0] for f, p in preps)
        sess = LauraServingSession(self.model, num_slots=min(num_slots, len(items)),
                                   max_new=self._max_length(max_length), prefix_budget=budget,
                                   sampling=self.sampling)
        for i, ((feats, prompt), seed) in enumerate(zip(preps, self._next_seeds(len(items)))):
            sess.submit(f"u{i}", feats[0], seed, prompt=prompt if prompt.shape[0] else None)
        outs: list = [None] * len(items)
        while any(o is None for o in outs):
            finished = sess.poll()
            if not finished and not sess.busy:
                unfinished = [f"u{i}" for i, o in enumerate(outs) if o is None]
                raise RuntimeError("serving session went idle with unfinished requests: " + ", ".join(unfinished))
            for uid, tokens in finished.items():
                i = int(uid[1:])
                feats, prompt = preps[i]
                outs[i] = self._synthesize_tokens(np.asarray(tokens)[None], feats, prompt.shape[0])
        return outs


def _parse_sampling(s: str) -> Sampling:
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return float(s) if "." in s else int(s)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="LauraTTS inference on one CUDA card (or the CPU)")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--config_file", type=str, required=True)
    parser.add_argument("--model_file", type=str, required=True)
    parser.add_argument("--codec_config_file", type=str, required=True)
    parser.add_argument("--codec_model_file", type=str, required=True)
    parser.add_argument("--text_scp", type=str, required=True,
                        help="uttid -> text (or token ids with --text_type ids)")
    parser.add_argument("--text_type", type=str, default="text", choices=["text", "ids"])
    parser.add_argument("--token_list", type=str, default=None)
    parser.add_argument("--token_type", type=str, default=None)
    parser.add_argument("--prompt_wav_scp", type=str, default=None)
    parser.add_argument("--prompt_text_scp", type=str, default=None)
    parser.add_argument("--sampling", type=str, default="25", help="true/false, int top-k, or float top-p")
    parser.add_argument("--sampling_rate", type=int, default=16000)
    parser.add_argument("--batch_size", type=int, default=1,
                        help=">1 drives batched AR decode (decode_codec_batch)")
    parser.add_argument("--serving_slots", type=int, default=0,
                        help=">0 decodes through the continuous-batching LauraServingSession with this many "
                             "slots (rel_pos/none-PE LMs only)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda; cpu runs on the host)")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    pipeline = Text2Audio(args.config_file, args.model_file, args.codec_config_file, args.codec_model_file,
                          token_list=args.token_list, token_type=args.token_type,
                          sampling=_parse_sampling(args.sampling), device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    texts = read_2column_text(args.text_scp)
    prompts_wav = read_2column_text(args.prompt_wav_scp) if args.prompt_wav_scp else {}
    prompts_text = read_2column_text(args.prompt_text_scp) if args.prompt_text_scp else {}

    def load_item(key, text):
        if args.text_type == "ids":
            text = np.array([int(x) for x in text.split()], np.int64)
        prompt_audio = None
        if key in prompts_wav:
            sr, wav = read_wav(prompts_wav[key])
            if wav.ndim == 2:
                wav = wav[:, 0]
            if sr != args.sampling_rate:
                wav = resample(wav, sr, args.sampling_rate)
            prompt_audio = wav
        return dict(text=text, prompt_text=prompts_text.get(key), prompt_audio=prompt_audio)

    eval_rows = {}

    def emit(key, out, prompt_audio=None):
        for tag, wav in out.items():
            if wav.size:
                save_audio(wav, os.path.join(args.output_dir, f"{key}_{tag}.wav"), args.sampling_rate, rescale=True)
        logging.info("%s: gen %.2fs, gen_only_lm %.2fs", key, out["gen"].size / args.sampling_rate,
                     out["gen_only_lm"].size / args.sampling_rate)
        row = {}
        for tag, wav in out.items():
            m = tts_metrics(wav, prompt=prompt_audio, sr=args.sampling_rate)
            row.update({f"{tag}_{k}": v for k, v in m.items()})
        eval_rows[key] = row

    entries = list(texts.items())
    if args.serving_slots > 0:
        items = [load_item(k, t) for k, t in entries]
        for (key, _), out, item in zip(entries, pipeline.serving_synthesize(items, num_slots=args.serving_slots),
                                       items):
            emit(key, out, prompt_audio=item["prompt_audio"])
    elif args.batch_size <= 1:
        for key, text in entries:
            item = load_item(key, text)
            emit(key, pipeline(item["text"], prompt_text=item["prompt_text"], prompt_audio=item["prompt_audio"]),
                 prompt_audio=item["prompt_audio"])
    else:
        for i in range(0, len(entries), args.batch_size):
            chunk = entries[i: i + args.batch_size]
            items = [load_item(k, t) for k, t in chunk]
            for (key, _), out, item in zip(chunk, pipeline.batch_synthesize(items), items):
                emit(key, out, prompt_audio=item["prompt_audio"])

    if eval_rows:
        keys = sorted({k for row in eval_rows.values() for k in row})
        mean = {}
        for k in keys:
            vals = [row[k] for row in eval_rows.values() if k in row and np.isfinite(row[k])]
            if vals:
                mean[k] = float(np.mean(vals))
        with open(os.path.join(args.output_dir, "tts_eval.json"), "w") as f:
            json.dump({"mean": mean, "per_utt": eval_rows}, f, indent=2)
        logging.info("tts_eval.json: %s", mean)


if __name__ == "__main__":
    main()
