"""Continuous-batching TTS serving for Laura codec LMs (port of
funcodec_tpu/models/tts_serving.py).

`LauraServingSession` keeps B fixed slots over one (B, capacity) KV cache.
Each slot has its own write head (``cache.length`` is a (B,) tensor, the
per-row mode of TransformerEncoder.step): admission writes the request's
prefix right-aligned into the slot's window [0, prefix_budget) and the row
generates from prefix_budget upward, so its relative distances are those of
a fresh batch-1 decode. Capacity is prefix_budget + max_new + 1 and a freed
slot re-admits at once.

The decode runs in segments of up to `segment_steps` steps. Inside a segment
nothing waits on the card: the live flags, counts and tokens stay on the
device and rows that finished ride along without writing (write_mask). One
host readback per segment (live flags, counts, tokens and the live-step
count in one copy) harvests finished rows; the host bounds a segment by the
most steps any live row can still take under its cap.

A request's draws depend only on its seed and step (models/laura.
draw_uniforms), so a session decode of a request equals
``model.decode_codec`` of it with the same seed. Supports rel_pos/none
position encodings (the shipped LauraTTS topology); split-PE models use
decode_codec_batch.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from funcodec_tpu_torch.models.laura import Sampling, sample_groups
from funcodec_tpu_torch.models.transformer import KVCache, init_kv_cache


class LauraServingSession:
    """Slot-based continuous-batching decode over one Laura codec LM.

        sess = LauraServingSession(model, num_slots=8)
        sess.submit("utt1", text_feats, seed=1)
        finished = sess.drain()  # {uid: (T, nq) int32 tokens}

    or incrementally: ``submit()`` any time, ``poll()`` per scheduling tick.
    `text_bucket` / `prompt_bucket` pad a request's text and prompt to a
    multiple before its prefix is embedded; the true lengths mask the
    padding, so the tokens do not depend on them.
    """

    def __init__(
        self,
        model,
        num_slots: int = 8,
        max_new: int = 30 * 25,
        prefix_budget: int = 256,
        capacity: Optional[int] = None,
        sampling: Sampling = 0.8,
        segment_steps: int = 25,
        text_bucket: int = 32,
        prompt_bucket: int = 32,
    ):
        cfg, lm_cfg = model.cfg, model.codec_lm_cfg
        if cfg.lm_pe_type == "split" or lm_cfg.pos_enc_type not in ("rel_pos", "none"):
            raise NotImplementedError(
                "continuous batching needs position-shift-invariant attention "
                "(rel_pos/none); split-PE models use decode_codec_batch")
        self.model, self.cfg, self.lm_cfg = model, cfg, lm_cfg
        self.device = model.device
        self.B = int(num_slots)
        self.max_new = int(max_new)
        self.prefix_budget = int(prefix_budget)
        self.capacity = int(capacity if capacity is not None else prefix_budget + max_new + 1)
        if self.capacity < self.prefix_budget + self.max_new + 1:
            raise ValueError(f"capacity {self.capacity} < prefix_budget + max_new + 1")
        self.sampling = sampling
        self.segment_steps = int(segment_steps)
        self.text_bucket = max(1, int(text_bucket))
        self.prompt_bucket = max(1, int(prompt_bucket))
        self.eos = cfg.codebook_size + cfg.sos_eos

        dev, B, nq = self.device, self.B, cfg.predict_nq
        v_out = model.codec_lm.decoder.weight.shape[0]
        self.cache = init_kv_cache(lm_cfg, B, self.capacity, dtype=model.cache_dtype, device=dev)
        self.cache.length = torch.full((B,), self.prefix_budget, dtype=torch.int64, device=dev)
        self.logits = torch.zeros(B, v_out, dtype=torch.float32, device=dev)
        self.toks = torch.zeros(B, self.max_new, nq, dtype=torch.int64, device=dev)
        self.counts = torch.zeros(B, dtype=torch.int64, device=dev)
        self.row_max = torch.full((B,), self.max_new, dtype=torch.int64, device=dev)
        self.live = torch.zeros(B, dtype=torch.bool, device=dev)
        self.seeds = torch.zeros(B, dtype=torch.int64, device=dev)
        self.valid_key = torch.zeros(B, self.capacity, dtype=torch.bool, device=dev)
        self._rel_proj = model.codec_lm.encoder.rel_proj(self.capacity)

        self._queue: deque = deque()  # (uid, emb_pad, llm_len, seed, cap)
        self._slot_uid: List[Optional[str]] = [None] * B
        self._cap = [0] * B  # each slot's request's cap
        self._left = [0] * B  # steps each slot may still take (host copy at the last readback)
        self._prompts: Dict[str, np.ndarray] = {}
        self._finished: Dict[str, np.ndarray] = {}
        self.stats = {"segments": 0, "slot_steps": 0, "live_steps": 0, "emitted": 0, "host_syncs": 0}

    # ------------------------------------------------------------------ API

    def submit(self, uid: str, text_feats, seed: int, prompt: Optional[np.ndarray] = None,
               max_new: Optional[int] = None) -> None:
        """Queue one request: (Lt, D) text features or (Lt,) ids, an integer
        seed (same seed => same tokens as model.decode_codec), optional
        (P, nq) prompt tokens and a cap on its generation (decode_codec's
        max_length); the slot frees at the cap or at eos."""
        cap = self.max_new if max_new is None else int(max_new)
        if not 0 < cap <= self.max_new:
            raise ValueError(f"max_new {cap} not in (0, {self.max_new}]")
        emb_pad, llm_len = self._prefix_embedding(text_feats, prompt)
        nq = self.cfg.predict_nq
        self._prompts[uid] = (np.asarray(prompt, np.int32).reshape(-1, nq) if prompt is not None and len(prompt)
                              else np.zeros((0, nq), np.int32))
        self._queue.append((uid, emb_pad, llm_len, int(seed), cap))

    def poll(self) -> Dict[str, np.ndarray]:
        """One scheduling tick: admit what fits, run one decode segment,
        harvest finished rows. Returns {uid: (T, nq) tokens} finished this
        tick (prompt included, eos removed)."""
        self._admit_ready()
        busy = [s for s in range(self.B) if self._slot_uid[s] is not None]
        if not busy:
            return self._pop_finished()
        steps = min(self.segment_steps, max(self._left[s] for s in busy))
        live_steps = self._segment(steps)
        B = self.B
        out = torch.cat([self.live.long(), self.counts, live_steps.reshape(1), self.toks.reshape(-1)]).cpu().numpy()
        self.stats["host_syncs"] += 1
        live, counts, toks = out[:B].astype(bool), out[B: 2 * B], out[2 * B + 1:].reshape(self.toks.shape)
        self.stats["segments"] += 1
        self.stats["slot_steps"] += steps * B
        self.stats["live_steps"] += int(out[2 * B])
        self._harvest(live, counts, toks)
        return self._pop_finished()

    def drain(self) -> Dict[str, np.ndarray]:
        """Run ticks until the queue and all slots are empty."""
        out: Dict[str, np.ndarray] = {}
        while self._queue or any(u is not None for u in self._slot_uid):
            out.update(self.poll())
        return out

    @property
    def busy(self) -> bool:
        return bool(self._queue) or any(u is not None for u in self._slot_uid)

    # ----------------------------------------------------------- scheduling

    def _admit_ready(self) -> None:
        for slot in range(self.B):
            if not self._queue:
                break
            if self._slot_uid[slot] is None:
                uid, emb_pad, llm_len, seed, cap = self._queue.popleft()
                self._admit(slot, emb_pad, llm_len, seed, cap)
                self._slot_uid[slot] = uid
                self._cap[slot] = self._left[slot] = cap

    def _harvest(self, live: np.ndarray, counts: np.ndarray, toks: np.ndarray) -> None:
        for s in range(self.B):
            uid = self._slot_uid[s]
            if uid is None:
                continue
            if live[s]:
                self._left[s] = self._cap[s] - int(counts[s])
                continue
            self._finished[uid] = np.concatenate([self._prompts.pop(uid), toks[s, : counts[s]]], axis=0).astype(
                np.int32)
            self.stats["emitted"] += int(counts[s])
            self._slot_uid[s] = None

    def _pop_finished(self) -> Dict[str, np.ndarray]:
        out, self._finished = self._finished, {}
        return out

    # ------------------------------------------------------------ device work

    @torch.inference_mode()
    def _prefix_embedding(self, text_feats, prompt) -> Tuple[torch.Tensor, int]:
        """The [sos, text, task](+prompt) prefix embedding (1, prefix_budget,
        D), right-aligned into the budget; text and prompt padded to their
        buckets, the true lengths masking the padding."""
        model, LP, cfg = self.model, self.prefix_budget, self.cfg
        text = np.asarray(text_feats)
        lt = int(text.shape[0])
        P = int(len(prompt)) if prompt is not None else 0
        llm_len = lt + 2 + P
        if llm_len > LP:
            raise ValueError(f"prefix {llm_len} exceeds prefix_budget {LP}")
        lt_b = -(-lt // self.text_bucket) * self.text_bucket
        P_b = -(-P // self.prompt_bucket) * self.prompt_bucket if P else 0
        if text.ndim == 1:  # token ids: pad with ignore_id (embeds to zero)
            text_pad = np.full((lt_b,), cfg.ignore_id, np.int64)
        else:
            text_pad = np.zeros((lt_b,) + text.shape[1:], np.float32)
        text_pad[:lt] = text
        dev = self.device
        tl = torch.tensor([lt], device=dev)
        if P:
            codec = np.zeros((1, P_b, cfg.predict_nq), np.int64)
            codec[0, :P] = np.asarray(prompt, np.int64)
            inputs, _ = model._prefix(model._tensor(text_pad[None]), tl, model._tensor(codec),
                                      torch.tensor([P], device=dev))
        else:
            inputs, _ = model._prefix(model._tensor(text_pad[None]), tl)
        emb = model.embed_prefill(inputs, tl + 1)[0, :llm_len]
        out = emb.new_zeros(1, LP, emb.shape[-1])
        out[0, LP - llm_len:] = emb
        return out, llm_len

    @torch.inference_mode()
    def _admit(self, slot: int, emb_pad: torch.Tensor, llm_len: int, seed: int, cap: int) -> None:
        """Prefill the request's prefix into the slot's window [0, prefix_budget) and arm the row."""
        model, LP = self.model, self.prefix_budget
        enc = model.codec_lm.encoder
        row_cache = KVCache(k=[k[slot: slot + 1] for k in self.cache.k], v=[v[slot: slot + 1] for v in self.cache.v],
                            length=0)  # views: the prefill writes the slot's rows in place
        valid_row = torch.arange(self.capacity, device=self.device) >= LP - llm_len
        h, _ = enc.step(row_cache, emb_pad.to(model.cache_dtype),
                        attend_mask=valid_row[None, None, :].expand(1, LP, self.capacity), rel_proj=self._rel_proj)
        self.logits[slot] = model.codec_lm.decoder(h[0, -1]).float()
        self.cache.length[slot] = LP
        self.toks[slot] = 0
        self.counts[slot] = 0
        self.row_max[slot] = cap
        self.live[slot] = True
        self.seeds[slot] = seed
        self.valid_key[slot] = valid_row

    @torch.inference_mode()
    def _segment(self, steps: int) -> torch.Tensor:
        """`steps` AR steps for all slots; returns the live-step count (a device scalar)."""
        model, B, nq = self.model, self.B, self.cfg.predict_nq
        rows = torch.arange(B, device=self.device)
        amask = self.valid_key[:, None, :]
        live_steps = torch.zeros((), dtype=torch.int64, device=self.device)
        for _ in range(steps):
            live = self.live
            live_steps = live_steps + live.sum()
            groups = sample_groups(self.logits, nq, self.sampling, self.seeds, self.counts)
            emit = live & ~(groups == self.eos).any(dim=-1)
            idx = self.counts.clamp(max=self.max_new - 1)
            self.toks[rows, idx] = torch.where(emit[:, None], groups, self.toks[rows, idx])
            self.counts += emit
            self.live = emit & (self.counts < self.row_max)
            # every row steps; only emitting rows write their K/V and advance
            safe = groups.masked_fill(~emit[:, None], 0)
            logits, self.cache = model.lm_step(self.cache, safe, None, amask, self._rel_proj, self.max_new,
                                               write_mask=emit)
            self.logits = torch.where(self.live[:, None], logits.float(), self.logits)
        return live_steps


class ServingPool:
    """One LauraServingSession per device, fed from one process; requests go
    to the least-loaded session. The model is copied to each device it is not
    on. Tokens do not depend on the device that served a request."""

    def __init__(self, model, devices: Optional[Sequence[Union[str, torch.device]]] = None, **session_kwargs):
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("ServingPool needs at least one device")
        self.sessions: List[LauraServingSession] = []
        for d in devices:
            m = model if d == model.device else copy.deepcopy(model).to(d)
            self.sessions.append(LauraServingSession(m, **session_kwargs))
        self._load = [0] * len(self.sessions)

    def submit(self, uid, text_feats, seed, prompt=None, max_new=None) -> None:
        i = min(range(len(self.sessions)), key=self._load.__getitem__)
        self.sessions[i].submit(uid, text_feats, seed, prompt=prompt, max_new=max_new)
        self._load[i] += 1

    def poll(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for i, sess in enumerate(self.sessions):
            done = sess.poll()
            self._load[i] -= len(done)
            out.update(done)
        return out

    def drain(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        while any(self._load):
            out.update(self.poll())
        return out

    @property
    def stats(self) -> Dict[str, int]:
        agg: Dict[str, int] = {}
        for sess in self.sessions:
            for k, v in sess.stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg
