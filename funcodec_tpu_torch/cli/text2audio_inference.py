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

`dtype` ("float32" or "bfloat16", --dtype) is the LM's weights and KV cache
and the codec's (Speech2Token's dtype; its decode modes then run in it);
logits and sampling stay fp32.

Continuous batching is also a service: ``start_serving`` opens a session,
``submit`` queues a request at any time and each ``poll`` runs one
scheduling tick. The requests that finished at a tick are synthesised
together behind the next tick's decode segment and returned by it (``gen``
only): the text and codec encoders once over all of them (the padding
masked), then one decode_emb over their embeddings, each wrap-padded with
its own frames to the session's cap in multiples of the codec CLI's 16-frame
bucket, so the shapes come from a finite set and a waveform does not depend
on the requests beside it; each waveform is cut to its request's frames.
Each batch is a ``synth`` span (utils/profiling): CUDA events, its first
request's number as its id.

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
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

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
from funcodec_tpu_torch.utils.profiling import span
from funcodec_tpu_torch.utils.tts_quality import tts_metrics

EMPTY = {"gen": np.zeros((0,), np.float32), "gen_only_lm": np.zeros((0,), np.float32)}
SYNTH_BUCKET = 16  # the service's syntheses pad to multiples of the codec CLI's 16-frame bucket


class Text2Audio:
    """The composed TTS pipeline. `device` defaults to the card; without a
    model file the LM's weights are random, drawn with seed INIT_SEED. The
    LM's and the codec's model files are PyTorch state_dicts (.pth, .pt,
    .bin) or the JAX package's .ckpt files, by the suffix. The configs are
    yaml paths or loaded dicts, the token list a file or a list."""

    def __init__(
        self,
        config_file: Union[str, Mapping[str, Any]],
        model_file: Optional[str],
        codec_config_file: Union[str, Mapping[str, Any]],
        codec_model_file: Optional[str],
        token_list: Optional[Union[str, Sequence[str]]] = None,
        token_type: Optional[str] = None,
        sampling: Sampling = 25,  # top-k 25, as the demo
        seed: int = 0,
        *,
        device: Union[str, torch.device] = "cuda",
        dtype: str = "float32",
    ):
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        if isinstance(config_file, Mapping):
            self.config = dict(config_file)
        else:
            with open(config_file) as f:
                self.config = yaml.safe_load(f)
        tokens = None
        if isinstance(token_list, str):
            with open(token_list, encoding="utf-8") as f:
                tokens = [line.strip() for line in f if line.strip()]
        elif token_list:
            tokens = list(token_list)
        self.model = build_laura_model(self.config, token_list=tokens, device=device)
        self.device = self.model.device
        self.tokenizer = build_tokenizer(token_type) if token_type and tokens else None
        self.converter = TokenIDConverter(tokens) if tokens else None
        if model_file and os.path.exists(model_file):
            load_laura_weights(model_file, self.model)
        else:
            logging.warning("no LM checkpoint %s; random init (seed %d)", model_file, INIT_SEED)
        if dtype == "bfloat16":
            self.model.to(torch.bfloat16)
        self.codec = Speech2Token(codec_config_file, codec_model_file, dtype=dtype, device=self.device)
        self.session: Optional[LauraServingSession] = None
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
        as it finishes, alone and unpadded (the batch-1 mode's and the JAX
        package's waveforms). {'gen', 'gen_only_lm'} dicts in input order."""
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

    # -- the service: start_serving, then submit / poll ------------------------

    def start_serving(self, num_slots: int = 8, max_length: Optional[int] = None, prefix_budget: int = 256,
                      segment_steps: int = 25) -> LauraServingSession:
        """Open a LauraServingSession of `num_slots` slots over the LM: caps of
        up to max_length groups (default the config's audio_max_duration),
        prefixes of up to prefix_budget positions ([sos, text, task])."""
        self.session = LauraServingSession(self.model, num_slots=num_slots, max_new=self._max_length(max_length),
                                           prefix_budget=prefix_budget, sampling=self.sampling,
                                           segment_steps=segment_steps)
        self.synth_frames = -(-self.session.max_new // SYNTH_BUCKET) * SYNTH_BUCKET
        self._pending: Dict[str, tuple] = {}  # uid -> (text features, request number)
        self._done: Dict[str, np.ndarray] = {}  # finished at the last tick: synthesised at the next
        self._submitted = self.synthesized = 0
        return self.session

    def submit(self, uid: str, text, seed: Optional[int] = None, cap: Optional[int] = None) -> None:
        """Queue one request: its text (a string, ids or features), a seed
        (default the next of seed + k) and a cap on its groups (default the
        session's)."""
        feats = self._text_to_features(text)
        self.session.submit(uid, feats[0], self._next_seeds(1)[0] if seed is None else int(seed), max_new=cap)
        self._submitted += 1
        self._pending[uid] = (feats, self._submitted)

    @property
    def serving_busy(self) -> bool:
        """Requests queued, decoding or waiting for their synthesis."""
        return self.session.busy or bool(self._done)

    def poll(self) -> Dict[str, Dict[str, np.ndarray]]:
        """One scheduling tick of the session. The requests that finished at
        the tick before are synthesised behind this tick's decode segment
        (the host queues their work while the card decodes) and returned:
        {uid: {'tokens' (T, nq) int32 (eos removed), 'gen' (T * hop,)}}. A
        request comes back one tick after its last group."""
        done, launched = self._done, []
        self._done = self.session.poll(lambda: launched.append(self._launch_synth(done)))
        return self._collect_synth(*launched[0]) if launched and launched[0] else {}

    @torch.inference_mode()
    def _launch_synth(self, done: Dict[str, np.ndarray]):
        """Queue the synthesis of finished requests, together and without
        waiting for the card, in one ``synth`` span: the text encoder and the
        NAR codec encoder over all of them (text and frames padded to the
        longest of the batch in multiples of SYNTH_BUCKET, each row's true
        lengths masking its padding), each row's embedding wrap-padded with
        its own frames to synth_frames (the session's cap in multiples of
        SYNTH_BUCKET, as the codec CLI wrap-pads a batch's rows), and one
        decode_emb over the rows. Returns (rows, decode_emb's dispatch)."""
        if not done:
            return None
        cfg, model, b, L = self.model.cfg, self.model, SYNTH_BUCKET, self.synth_frames
        rows = [(uid, np.asarray(tokens), *self._pending.pop(uid)) for uid, tokens in done.items()]
        with span("synth", device=self.device, request_id=rows[0][3]):
            voiced = [r for r in rows if len(r[1])]
            if not voiced:
                return rows, None
            n, first = len(voiced), voiced[0][2]
            lt = [f.shape[1] for _, _, f, _ in voiced]
            frames = [len(t) for _, t, _, _ in voiced]
            fill = cfg.ignore_id if first.dtype.kind in "iu" else 0
            text = np.full((n, -(-max(lt) // b) * b) + first.shape[2:], fill, first.dtype)
            codec = np.zeros((n, -(-max(frames) // b) * b, cfg.predict_nq), np.int64)
            for i, (_, t, f, _) in enumerate(voiced):
                text[i, : lt[i]] = f[0]
                codec[i, : frames[i]] = t[:, : cfg.predict_nq]
            up = lambda a: Speech2Token._to_device(a, self.device)  # noqa: E731
            lengths = up(np.array([lt, frames], np.int64))
            emb = model.dense_embedding(up(codec), lengths[1], up(text), lengths[0])
            wrap = torch.arange(L, device=self.device)[None, :] % lengths[1][:, None]
            emb = emb.gather(1, wrap[..., None].expand(n, L, emb.shape[-1]))
            return rows, self.codec.dispatch(emb, run_mod="decode_emb")

    def _collect_synth(self, rows: list, decoded) -> Dict[str, Dict[str, np.ndarray]]:
        """The launched syntheses' gen waveforms, each cut to its frames."""
        recon = None if decoded is None else np.asarray(self.codec.collect(decoded)[2])
        out, i, hop = {}, 0, self.codec.hop_length
        for uid, tokens, _, _ in rows:
            if len(tokens):
                gen, i = recon[i, : len(tokens) * hop], i + 1
            else:
                gen = EMPTY["gen"]
            self.synthesized += 1
            out[uid] = {"tokens": tokens, "gen": gen}
        return out

    @property
    def stats(self) -> Dict[str, int]:
        """The session's counters and the requests synthesised."""
        return dict(self.session.stats, synthesized=self.synthesized)


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
    parser.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                        help="the LM's weights and KV cache and the codec's (logits and sampling stay fp32)")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    pipeline = Text2Audio(args.config_file, args.model_file, args.codec_config_file, args.codec_model_file,
                          token_list=args.token_list, token_type=args.token_type,
                          sampling=_parse_sampling(args.sampling), device=args.device, dtype=args.dtype)
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
