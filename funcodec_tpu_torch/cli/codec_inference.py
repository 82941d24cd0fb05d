"""Batch codec inference: wav.scp -> codecs.txt -> reconstructed wavs.

Port of funcodec_tpu/cli/codec_inference.py. The public artifacts are
byte-compatible with the JAX pipeline's: codecs.txt json lines
``uttid [[[q0...],[q1...],...]]``, kaldi ark/scp for indices ("ark" mode) and
codec embeddings, ``{uttid}.wav`` reconstructions (peak-rescaled PCM16).

One process drives one GPU, named by ``device`` (default "cuda"; pass "cpu"
to run on the CPU), or with ``data_parallel`` N one model replica on each of
N cards (or on an explicit ``devices`` list), each serving a contiguous
block of every batch's rows. Utterances are length-sorted into wrap-padded buckets;
CUDA work is queued asynchronously, so the main thread dispatches batch i+1
before it collects batch i (``collect`` is the only synchronising copy),
while a reader pool decodes the next batches and a writer thread and wav pool
write the last ones.

    python -m funcodec_tpu_torch.cli.codec_inference --device cpu \\
        --config_file conf.yaml --model_file model.pth --output_dir out \\
        --data_path_and_name_and_type wav.scp,speech,sound --batch_size 16
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import math
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from funcodec_tpu_torch.data.kaldi_ark import ArkScpReader, ArkWriter
from funcodec_tpu_torch.data.wav_io import (
    SoundScpReader,
    _is_ark_entry,
    peek_wav_info,
    read_wav,
    resample,
    save_audio,
    write_wav,
)
from funcodec_tpu_torch.tasks.codec import build_codec_model, load_config, resolve_device
from funcodec_tpu_torch.train.checkpoint import load_codec_weights

_UNSET = object()
RUN_MODS = ("inference", "encode", "decode", "decode_emb")
INIT_SEED = 0  # random weights when no model file is given


def load_codec_json(json_str: str) -> np.ndarray:
    """codecs.txt line payload -> (T, n_q)."""
    array = np.array(json.loads(json_str))
    if array.ndim == 3:
        array = array[0]
    return array.T


class Speech2Token:
    """Codec model wrapper with run_mod in {inference, encode, decode, decode_emb}.

    `config_file` is a FunCodec config.yaml path or an already-loaded dict.
    `model_file` is a FunCodec .pth, a weights file of the port's trainer
    (cli/codec_train: {epoch}epoch.pth, latest.pth) or one of the JAX
    package's (a flax msgpack .ckpt: {epoch}epoch.ckpt, latest.ckpt, an
    average; read by the suffix, as the JAX CLI reads it: .pth, .pt and .bin
    are PyTorch files); without one the weights are random,
    drawn from a torch.Generator seeded with INIT_SEED. dtype "bfloat16" casts
    the parameters but not the codebooks (fp32 buffers, as in the JAX
    package); "float32" also turns off TF32 in cuDNN and cuBLAS, which would
    break the fp32 path's token exactness.

    The positional arguments mean what they mean in the JAX package.
    `data_parallel` N serves one batch over N cards from this one process,
    as the JAX package's "data" mesh does: one replica of the model on each
    card (the same weights), each given a contiguous block of the batch's
    rows, every replica dispatched before any is collected, so the cards
    overlap; no collective. A batch whose size N does not divide is padded
    by repeating its last row, and collect() strips the pad rows. N is
    clamped to the visible cards (-1: all of them). `devices` names the
    replicas' devices explicitly (then N is their count): two or four
    replicas on one card, or on the CPU, serve the same tokens.
    """

    def __init__(
        self,
        config_file: Union[str, Mapping[str, Any]],
        model_file: Optional[str] = None,
        dtype: str = "float32",
        sampling_rate: int = 16_000,
        bit_width: Optional[int] = 8_000,
        data_parallel: int = 1,
        *,
        device: Union[str, torch.device] = "cuda",
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        if isinstance(config_file, Mapping):
            self.config = dict(config_file)
        else:
            self.config = load_config(config_file)
        if devices is not None:
            self.devices = [resolve_device(d) for d in devices]
            if not self.devices:
                raise ValueError("devices names no device")
        else:
            dev = resolve_device(device)
            n = _clamp_data_parallel(data_parallel, dev)
            self.devices = [dev] if n == 1 else [torch.device("cuda", i) for i in range(n)]
        self.device = self.devices[0]
        self.data_parallel = len(self.devices)
        self.sampling_rate = sampling_rate
        self.bit_width = bit_width
        self.dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        if self.dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        generator = torch.Generator(device=self.device).manual_seed(INIT_SEED)
        self.model, _ = build_codec_model(self.config, device=self.device, generator=generator)
        if model_file and os.path.exists(model_file):
            load_codec_weights(model_file, self.model)
        else:
            logging.warning("no model file %s; random init (seed %d)", model_file, INIT_SEED)
        self.model.eval()
        if self.dtype == torch.bfloat16:
            # parameters only: the codebooks stay fp32 buffers. torch leaves
            # bf16 LSTM weights unflattened (cudnn.is_acceptable excludes
            # bf16), so cuDNN compacts them on each call and warns.
            with torch.no_grad():
                for p in self.model.parameters():
                    p.data = p.data.to(torch.bfloat16)
        # a copy of its own on every other device (on the same card too: the
        # kernels' packed weights are cached on each replica's tensors)
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d) for d in self.devices[1:]]

    @property
    def hop_length(self) -> int:
        return self.model.quantizer.cfg.encoder_hop_length

    @property
    def bits_per_quant(self) -> int:
        q = self.model.quantizer.cfg
        return (q.sampling_rate // q.encoder_hop_length) * int(math.log2(q.codebook_size))

    @staticmethod
    def _to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
        """A host batch on `device`. From numpy the copy goes through pinned
        memory without blocking, so it does not wait for the batches already
        queued on the card."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        if dtype is not None and t.device.type == "cpu":
            t = t.to(dtype)
        if device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device=device, dtype=dtype or t.dtype)

    def dispatch(
        self,
        speech,
        need_recon: bool = True,
        bit_width=_UNSET,
        use_scale: bool = True,
        run_mod: str = "inference",
        pcm16_ilens=None,
    ) -> Dict[str, Any]:
        """Run one batch and return the model's out dict of device tensors
        without copying to the host (CUDA work is queued asynchronously).
        Pair with collect().

        speech: (B, T) waveform (float, or int16 PCM that is dequantized on
        the device), (B, T, n_q) tokens for decode, (B, T, D) embeddings for
        decode_emb; a numpy array or a tensor.

        pcm16_ilens: per-utterance valid sample counts; when given, the
        reconstruction is peak-rescaled and rounded to int16 on the device,
        so collect() copies 2-byte PCM rather than 4-byte floats.

        With several replicas the batch (padded to a multiple of their count
        by repeating its last row) is split into contiguous blocks, one a
        replica, each dispatched before any is collected; the out dict then
        holds the replicas' outs and the pad's row count."""
        if run_mod not in RUN_MODS:
            raise ValueError(run_mod)
        if bit_width is _UNSET:
            bit_width = self.bit_width
        if len(self.replicas) == 1:
            return self._dispatch(self.model, self.device, speech, need_recon, bit_width, use_scale, run_mod,
                                  pcm16_ilens)
        n, rows = len(self.replicas), len(speech)
        pad = (-rows) % n
        if pad:
            if isinstance(speech, torch.Tensor):
                speech = torch.cat([speech, speech[-1:].expand(pad, *speech.shape[1:])])
            else:
                speech = np.concatenate([speech, np.repeat(np.asarray(speech)[-1:], pad, axis=0)])
            if pcm16_ilens is not None:
                pcm16_ilens = list(pcm16_ilens) + [pcm16_ilens[-1]] * pad
        b = len(speech) // n
        outs = [self._dispatch(m, d, speech[i * b:(i + 1) * b], need_recon, bit_width, use_scale, run_mod,
                               None if pcm16_ilens is None else pcm16_ilens[i * b:(i + 1) * b])
                for i, (m, d) in enumerate(zip(self.replicas, self.devices))]
        return {"_replicas": outs, "_row_pad": pad, "_rows": rows}

    def _dispatch(self, model, device, speech, need_recon, bit_width, use_scale, run_mod, pcm16_ilens):
        """One replica's share of dispatch()."""
        with torch.inference_mode():
            if run_mod == "decode":
                nq = None
                if bit_width is not None:
                    nq = int(max(bit_width // self.bits_per_quant, 1))
                out = model.inference_decoding(self._to_device(speech, device, torch.int64)[:, :, :nq])
            elif run_mod == "decode_emb":
                out = model.inference_decoding_emb(self._to_device(speech, device))
            else:
                x = self._to_device(speech, device)
                if x.dtype == torch.int16:
                    x = x.float() * (1.0 / 32768.0)
                x = x.to(self.dtype)
                if run_mod == "inference":
                    out = model.inference(x, need_recon=need_recon, bit_width=bit_width, use_scale=use_scale)
                else:
                    out = model.inference_encoding(
                        x, need_recon=need_recon, bit_width=bit_width, use_scale=use_scale
                    )
            out = dict(out)
            if pcm16_ilens is not None and out.get("recon_speech") is not None:
                out["recon_pcm16"] = pcm16(out.pop("recon_speech"), pcm16_ilens)
        return out

    @staticmethod
    def collect(out: Dict[str, Any], need_sub_quants: bool = True):
        """Copy a dispatched batch to the host: (code_indices [int32 (n_q, B, T)],
        code_embeddings (device tensors), recon, sub_quants). recon is int16
        PCM if the batch was dispatched with pcm16_ilens, else float32 (B, T).
        The replicas' blocks are joined in row order (the code embeddings on
        the first replica's device) and the pad rows stripped."""
        if "_replicas" in out:
            return _joined([Speech2Token.collect(o, need_sub_quants) for o in out["_replicas"]], out["_rows"])
        codes = out.get("code_indices")
        if codes is not None and codes[0] is not None:
            codes = [c.cpu().numpy().astype(np.int32) for c in codes]
        recon = out.get("recon_pcm16")
        if recon is not None:
            recon = recon.cpu().numpy()
        elif out.get("recon_speech") is not None:
            recon = out["recon_speech"].float().cpu().numpy()
        sub_quants = out.get("sub_quants") if need_sub_quants else None
        if sub_quants is not None and sub_quants[0] is not None:
            sub_quants = [s.float().cpu().numpy() for s in sub_quants]
        return codes, out.get("code_embeddings"), recon, sub_quants

    def __call__(
        self,
        speech,
        need_recon: bool = True,
        bit_width=_UNSET,
        use_scale: bool = True,
        run_mod: str = "inference",
    ):
        """One synchronous batch. bit_width: omit for the constructor default;
        pass None explicitly for ALL quantizers."""
        return self.collect(
            self.dispatch(
                speech, need_recon=need_recon, bit_width=bit_width,
                use_scale=use_scale, run_mod=run_mod,
            )
        )


def _clamp_data_parallel(data_parallel: Optional[int], device: torch.device) -> int:
    """The JAX package's clamp to the visible devices (-1: all of them)."""
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    dp = n_dev if (data_parallel is not None and data_parallel < 0) else int(data_parallel or 1)
    if dp > n_dev:
        logging.warning("data_parallel=%d > %d visible devices; clamping", dp, n_dev)
        dp = n_dev
    return dp


def _joined(parts, n: int):
    """The replicas' collected (codes, code embeddings, recon, sub_quants),
    joined along the batch rows and cut to the batch's `n` rows."""

    def rows(arrays, axis: int):
        return np.concatenate(arrays, axis=axis)[(slice(None),) * axis + (slice(0, n),)]

    def frames(k: int, axis: int):
        first = parts[0][k]
        if first is None or first[0] is None:
            return first
        return [rows([p[k][f] for p in parts], axis) for f in range(len(first))]

    embs = parts[0][1]
    if embs:
        dev = embs[0][0].device
        embs = [(torch.cat([p[1][f][0].to(dev) for p in parts])[:n],
                 None if embs[f][1] is None else torch.cat([p[1][f][1].to(dev) for p in parts])[:n])
                for f in range(len(embs))]
    recon = None if parts[0][2] is None else rows([p[2] for p in parts], 0)
    return frames(0, 1), embs, recon, frames(3, 1)


def pcm16(recon: torch.Tensor, ilens) -> torch.Tensor:
    """save_audio(rescale=True) on the device: per-utterance peak over the
    valid samples only, scaled down to |x| <= 0.99, rounded to int16."""
    r = recon.float()
    n = torch.as_tensor(np.asarray(ilens, np.int64), device=r.device)
    mask = torch.arange(r.shape[1], device=r.device)[None, :] < n[:, None]
    peak = (r.abs() * mask).amax(dim=1, keepdim=True)
    scale = torch.where(peak > 0.99, 0.99 / peak.clamp_min(1e-12), torch.ones_like(peak))
    q = torch.round(r * scale * 32767.0)
    return q.clamp(-32768, 32767).to(torch.int16)


def _bucket_length(t: int, hop: int, quantum: int = 16) -> int:
    """Round T up so the token length is a multiple of `quantum` frames."""
    frames = -(-t // hop)
    frames = -(-frames // quantum) * quantum
    return frames * hop


def _wrap_pad(arrs: List[np.ndarray], target: int) -> np.ndarray:
    """Stack items padded along time (axis 0) to `target` with wrap padding
    (the reference collate's pad_mode="wrap")."""
    padded = []
    for a in arrs:
        pad = target - a.shape[0]
        if pad > 0:
            a = np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1), mode="wrap")
        padded.append(a)
    return np.stack(padded)


def _iter_batches(items: List[Tuple[str, np.ndarray]], batch_size: int, hop: int):
    """Yield (keys, padded batch, lengths) with wrap padding into length
    buckets. Time is axis 0 of each item: (T,) waveforms, (T, n_q) tokens,
    (T, D) embeddings."""
    items = sorted(items, key=lambda kv: kv[1].shape[0])
    for i in range(0, len(items), batch_size):
        chunk = items[i : i + batch_size]
        lengths = [x.shape[0] for _, x in chunk]
        yield [k for k, _ in chunk], _wrap_pad([x for _, x in chunk], _bucket_length(max(lengths), hop)), lengths


def _plan_sound_batches(
    reader: SoundScpReader,
    sampling_rate: int,
    file_sampling_rate: Optional[int],
    should_resample: bool,
) -> List[Tuple[str, int]]:
    """(key, post-resample length) for every utterance without decoding:
    lengths come from RIFF headers (peek_wav_info); resample_poly's output
    length is ceil(n * new/old) exactly, so the batch plan's padding is exact."""
    infos: List[Tuple[str, int]] = []
    for key in reader:
        p = reader.data[key]
        info = None if _is_ark_entry(p) else peek_wav_info(p)
        if info is not None:
            sr, n, _ch = info
        else:  # ark entry or exotic wav: decode once to learn the length
            sr, wav = reader[key]
            n = wav.shape[0]
        src_sr = file_sampling_rate if should_resample else sr
        est = n if src_sr == sampling_rate else -(-n * sampling_rate // src_sr)
        infos.append((key, est))
    return infos


def inference_pipeline(
    output_dir: str,
    config_file: str,
    model_file: str,
    data_path_and_name_and_type: Sequence[Tuple[str, str, str]],
    batch_size: int = 1,
    bit_width: Optional[int] = 8000,
    sampling_rate: int = 16000,
    file_sampling_rate: Optional[int] = None,
    use_scale: bool = True,
    run_mod: str = "inference",
    need_indices: bool = True,
    need_sub_quants: bool = False,
    indices_save_type: str = "json",
    dtype: str = "float32",
    pipeline_depth: int = 2,
    model: Optional[Speech2Token] = None,
    num_reader_threads: Optional[int] = None,
    num_writer_threads: Optional[int] = None,
    data_parallel: int = 1,
    device: Union[str, torch.device] = "cuda",
) -> List[Dict[str, Any]]:
    """The encoding_decoding.sh stage-1/2 driver, in three overlapped stages:

      reader pool : wav decode + resample of the next batches' items over
                    `num_reader_threads` workers (default: host cores, <= 16);
                    batch assembly (pad + stack) stays on one thread, so
                    batches come in plan order
      main thread : dispatch to the card, `pipeline_depth` batches in
                    flight, one collect per batch
      writer      : per-utterance wav encode/write fans out over
                    `num_writer_threads`; token/ark writes stay on the single
                    writer thread (one file handle, ordered)

    The batch plan (length-sorted buckets) is built from wav headers alone,
    so the first dispatch happens after decoding one batch, not the corpus.
    """
    import queue as _queue
    import threading
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    host_cores = os.cpu_count() or 1
    if num_reader_threads is None:
        num_reader_threads = min(host_cores, 16)
    if num_writer_threads is None:
        num_writer_threads = min(host_cores, 16)

    if model is None:  # callers serving many requests pass a built model in
        model = Speech2Token(
            config_file, model_file, dtype=dtype,
            sampling_rate=sampling_rate, bit_width=bit_width,
            data_parallel=data_parallel, device=device,
        )
    os.makedirs(output_dir, exist_ok=True)
    hop = model.hop_length
    should_resample = file_sampling_rate is not None and file_sampling_rate != sampling_rate

    path, _name, typ = data_path_and_name_and_type[0]
    bucket_hop = 1 if run_mod in ("decode", "decode_emb") else hop

    # ---- work plan: (key, length) pairs + a lazy per-key loader ----
    if typ == "sound":
        reader = SoundScpReader(path)
        infos = _plan_sound_batches(reader, sampling_rate, file_sampling_rate, should_resample)

        def load_item(key: str) -> np.ndarray:
            p = reader.data[key]
            if _is_ark_entry(p):
                sr, wav = reader[key]
            else:
                # raw int16 PCM when possible: the device dequantizes (exact)
                sr, wav = read_wav(p, normalize=False)
            if wav.ndim == 2:
                wav = wav[:, 0]
            if wav.dtype == np.int16 and (should_resample or sr != sampling_rate):
                wav = wav.astype(np.float32) / 32768.0
            if should_resample:
                wav = resample(wav, file_sampling_rate, sampling_rate)
            elif sr != sampling_rate:
                wav = resample(wav, sr, sampling_rate)
            return wav if wav.dtype == np.int16 else wav.astype(np.float32)

    elif typ == "codec_json":
        token_map: Dict[str, np.ndarray] = {}
        with open(path) as f:
            for line in f:
                key, payload = line.rstrip("\n").split(maxsplit=1)
                token_map[key] = load_codec_json(payload)  # (T, n_q)
        infos = [(k, v.shape[0]) for k, v in token_map.items()]

        def load_item(key: str) -> np.ndarray:
            return token_map[key]

    elif typ == "kaldi_ark":
        ark_reader = ArkScpReader(path)
        infos = [(k, ark_reader[k].shape[0]) for k in ark_reader]

        def load_item(key: str) -> np.ndarray:
            return ark_reader[key]

    else:
        raise ValueError(f"unsupported data type {typ}")

    # length-sorted chunks (the reference collate's sorted bucketing)
    infos.sort(key=lambda kv: kv[1])
    planned = [[k for k, _ in infos[i : i + batch_size]] for i in range(0, len(infos), batch_size)]

    indices_writer = None
    indices_file = None
    if need_indices and run_mod in ("inference", "encode"):
        if indices_save_type == "ark":
            base = os.path.join(output_dir, "indices")
            indices_writer = ArkWriter(base + ".ark", base + ".scp")
        else:
            indices_file = open(os.path.join(output_dir, "codecs.txt"), "wt")
    sub_quants_writer = None
    if need_sub_quants and run_mod in ("inference", "encode"):
        base = os.path.join(output_dir, "codec_emb")
        sub_quants_writer = ArkWriter(base + ".ark", base + ".scp")

    results: List[Dict[str, Any]] = []
    errors: List[BaseException] = []
    in_q: "_queue.Queue" = _queue.Queue(maxsize=max(2, pipeline_depth + 1))
    wr_q: "_queue.Queue" = _queue.Queue(maxsize=max(4, 2 * pipeline_depth))

    def reader_fn():
        try:
            with ThreadPoolExecutor(max_workers=num_reader_threads, thread_name_prefix="codec-read") as pool:
                # keep a window of batches' item decodes in flight so the pool
                # never drains at a batch boundary; assembly below consumes
                # strictly in plan order
                window: deque = deque()
                plan_iter = iter(planned)

                def refill():
                    while len(window) < max(2, pipeline_depth + 1):
                        nxt = next(plan_iter, None)
                        if nxt is None:
                            return
                        window.append((nxt, [pool.submit(load_item, k) for k in nxt]))

                refill()
                while window:
                    keys, futs = window.popleft()
                    refill()  # decode ahead while this batch assembles
                    arrs = [f.result() for f in futs]
                    if any(a.dtype != arrs[0].dtype for a in arrs):
                        # mixed int16/float batch: promote on the host (int16
                        # is an unscaled transport form; np.stack must not
                        # blend them)
                        arrs = [
                            a.astype(np.float32) / 32768.0 if a.dtype == np.int16 else a.astype(np.float32)
                            for a in arrs
                        ]
                    lengths = [a.shape[0] for a in arrs]
                    in_q.put((keys, _wrap_pad(arrs, _bucket_length(max(lengths), bucket_hop)), lengths))
        except BaseException as e:  # surfaced to the caller after join
            errors.append(e)
        finally:
            in_q.put(None)

    wav_pool = ThreadPoolExecutor(max_workers=num_writer_threads, thread_name_prefix="codec-wav")

    def _write_wav_one(path: str, wav_out: np.ndarray, out_sr: int):
        try:
            if wav_out.dtype == np.int16:
                write_wav(path, wav_out, out_sr)  # already peak-scaled and rounded on the device
            else:
                save_audio(wav_out, path, out_sr, rescale=True)
        except BaseException as e:
            errors.append(e)

    def write_batch(keys, fetched, lengths):
        token_id, _token_emb, recon, sub_quants = fetched
        if should_resample and recon is not None:
            recon = resample(recon, sampling_rate, file_sampling_rate)
        for i, key in enumerate(keys):
            if run_mod in ("decode", "decode_emb"):
                codec_len = lengths[i]
                ilen = codec_len * hop
                if should_resample:
                    ilen = int(ilen * file_sampling_rate / sampling_rate)
            else:
                ilen = lengths[i]
                codec_len = int(math.ceil(ilen / hop))
            if recon is not None:
                wav_out = recon[i][:ilen]
                out_sr = file_sampling_rate if should_resample else sampling_rate
                fname = key + ".wav" if not key.endswith(".wav") else key
                wav_pool.submit(_write_wav_one, os.path.join(output_dir, fname), wav_out, out_sr)
                results.append({"key": key, "value": os.path.join(output_dir, fname)})
            if token_id is not None and (indices_writer or indices_file):
                # frames list of (n_q, B, T) -> per-utterance [[q rows]...]
                if indices_save_type == "ark":
                    mats = [np.asarray(x)[:, i, :codec_len].T.astype(np.float32) for x in token_id]
                    indices_writer(key, np.concatenate(mats, axis=0))
                else:
                    to_write = [np.asarray(x)[:, i, :codec_len].tolist() for x in token_id]
                    indices_file.write(key + " " + json.dumps(to_write) + "\n")
            if sub_quants is not None and sub_quants_writer and sub_quants[0] is not None:
                # frames list of (n_q, B, T, D) -> (T, n_q*D)
                cat = np.concatenate([np.asarray(x) for x in sub_quants], axis=2)
                mat = cat[:, i, :codec_len, :].transpose(1, 0, 2).reshape(codec_len, -1)
                sub_quants_writer(key, mat.astype(np.float32))

    def writer_fn():
        try:
            while True:
                item = wr_q.get()
                if item is None:
                    return
                write_batch(*item)
        except BaseException as e:
            errors.append(e)
            while wr_q.get() is not None:  # drain so the main thread never blocks
                pass

    reader_t = threading.Thread(target=reader_fn, name="codec-reader", daemon=True)
    writer_t = threading.Thread(target=writer_fn, name="codec-writer", daemon=True)
    reader_t.start()
    writer_t.start()

    pending: deque = deque()

    def flush_one():
        keys, out, lengths = pending.popleft()
        wr_q.put((keys, model.collect(out, need_sub_quants=need_sub_quants), lengths))

    want_recon = run_mod != "encode"
    try:
        while True:
            item = in_q.get()
            if item is None:
                break
            keys, batch, lengths = item
            # valid output samples per utterance at the model sampling rate
            ilens = [n * hop for n in lengths] if run_mod in ("decode", "decode_emb") else lengths
            out = model.dispatch(
                batch, need_recon=want_recon, bit_width=bit_width, use_scale=use_scale, run_mod=run_mod,
                # int16 on the device only when the host won't resample
                # (resample needs float input)
                pcm16_ilens=(ilens if (want_recon and not should_resample) else None),
            )
            pending.append((keys, out, lengths))
            if len(pending) >= pipeline_depth:
                flush_one()
        while pending:
            flush_one()
    finally:
        wr_q.put(None)
        writer_t.join()
        reader_t.join()
        wav_pool.shutdown(wait=True)  # all wav files on disk before return
        if indices_writer:
            indices_writer.close()
        if indices_file:
            indices_file.close()
        if sub_quants_writer:
            sub_quants_writer.close()
    if errors:
        raise errors[0]
    return results


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="codec inference on one CUDA card, a replica on each of --data_parallel cards, or the CPU")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--config_file", type=str, required=True)
    parser.add_argument("--model_file", type=str, required=True)
    parser.add_argument(
        "--data_path_and_name_and_type", type=str, action="append", required=True,
        help="e.g. wav.scp,speech,sound or codecs.txt,speech,codec_json",
    )
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--bit_width", type=int, default=8000)
    parser.add_argument("--sampling_rate", type=int, default=16000)
    parser.add_argument("--file_sampling_rate", type=int, default=None)
    parser.add_argument("--run_mod", type=str, default="inference",
                        choices=["inference", "encode", "decode", "decode_emb"])
    parser.add_argument("--need_indices", type=lambda s: s.lower() == "true", default=True)
    parser.add_argument("--need_sub_quants", type=lambda s: s.lower() == "true", default=False)
    parser.add_argument("--indices_save_type", type=str, default="json", choices=["json", "ark"])
    parser.add_argument("--dtype", type=str, default="float32")
    parser.add_argument("--num_reader_threads", type=int, default=None,
                        help="host decode workers (default: cpu count, <= 16)")
    parser.add_argument("--num_writer_threads", type=int, default=None,
                        help="wav encode/write workers (default: cpu count, <= 16)")
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="cards to serve on, one model replica each (-1: all visible); clamped to the "
                             "visible cards")
    parser.add_argument("--stat_flops", action="store_true",
                        help="log the per-layer FLOPs/params tree of the serving path at 1 s of audio "
                             "before running (codec_inference.py:328-342; utils/misc.codec_flops_tree)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to serve on (default: cuda; cpu runs on the host)")
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.stat_flops:
        from funcodec_tpu_torch.utils.misc import codec_flops_tree

        # counted from the layers' shapes: the model is built, never run
        model, _ = build_codec_model(load_config(args.config_file), device=args.device)
        logging.info("\n%s", codec_flops_tree(model, samples=args.sampling_rate))
        del model
    triples = [tuple(s.split(",")) for s in args.data_path_and_name_and_type]
    inference_pipeline(
        output_dir=args.output_dir,
        config_file=args.config_file,
        model_file=args.model_file,
        data_path_and_name_and_type=triples,
        batch_size=args.batch_size,
        bit_width=args.bit_width,
        sampling_rate=args.sampling_rate,
        file_sampling_rate=args.file_sampling_rate,
        run_mod=args.run_mod,
        need_indices=args.need_indices,
        need_sub_quants=args.need_sub_quants,
        indices_save_type=args.indices_save_type,
        dtype=args.dtype,
        num_reader_threads=args.num_reader_threads,
        num_writer_threads=args.num_writer_threads,
        data_parallel=args.data_parallel,
        device=args.device,
    )


if __name__ == "__main__":
    main()
