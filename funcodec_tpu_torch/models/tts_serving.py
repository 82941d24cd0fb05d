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
most steps any live row can still take under its cap. A step updates the
session's tensors in place, so on a card it is captured once as a CUDA
graph (while no slot is live, when a step changes nothing) and a segment
replays it: one launch a step instead of the step's ~500.

A request's draws depend only on its seed and step (models/laura.
draw_uniforms), so a session decode of a request equals
``model.decode_codec`` of it with the same seed. Supports rel_pos/none
position encodings (the shipped LauraTTS topology); split-PE models use
decode_codec_batch.

Admission takes queued requests in batches: the prefixes embedded
together, the text and prompt padded to the longest of the batch (the true
lengths mask the padding), and prefilled together into a small cache of
their own, then copied into their slots. The host knows before a segment
runs which rows it ends at their caps, so ``poll`` prefills that many of
the queue's next requests behind the segment (staged), and the next tick
only copies them into the freed slots; a slot freed by an eos admits at
the next tick's start. ``poll`` queues the segment's readback right behind
it, then runs a callable (host work that hides behind the decode; its
device work queues after the readback) and the staging, so the readback
waits for the segment alone.

Spans (utils/profiling): ``admit`` (an admission batch's prefix embedding
and prefill, staged or not; CUDA events, its first request's number as its
id),
``lm_segment`` (one segment's decode steps, CUDA events) and ``harvest``
(the segment's one readback, a wait). ``stats`` counts segments, slot
steps, live steps, emitted groups, host readbacks and admitted requests.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from funcodec_tpu_torch.models.laura import Sampling, sample_groups
from funcodec_tpu_torch.models.transformer import init_kv_cache
from funcodec_tpu_torch.utils.profiling import span


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
        self._rows = torch.arange(B, device=dev)
        self._live_steps = torch.zeros((), dtype=torch.int64, device=dev)
        self._graph = self._capture() if dev.type == "cuda" else None

        self._queue: deque = deque()  # (uid, request number, text, seed, cap)
        self._staged: Optional[dict] = None  # requests prefilled for the slots the running segment frees
        self._submitted = 0
        self._slot_uid: List[Optional[str]] = [None] * B
        self._cap = [0] * B  # each slot's request's cap
        self._left = [0] * B  # steps each slot may still take (host copy at the last readback)
        self._prompts: Dict[str, np.ndarray] = {}
        self._finished: Dict[str, np.ndarray] = {}
        self.stats = {"segments": 0, "slot_steps": 0, "live_steps": 0, "emitted": 0, "host_syncs": 0, "admitted": 0}

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
        text = np.asarray(text_feats)
        llm_len = int(text.shape[0]) + 2 + (int(len(prompt)) if prompt is not None else 0)
        if llm_len > self.prefix_budget:
            raise ValueError(f"prefix {llm_len} exceeds prefix_budget {self.prefix_budget}")
        nq = self.cfg.predict_nq
        self._prompts[uid] = (np.asarray(prompt, np.int32).reshape(-1, nq) if prompt is not None and len(prompt)
                              else np.zeros((0, nq), np.int32))
        self._submitted += 1
        self._queue.append((uid, self._submitted, text, int(seed), cap))

    def poll(self, overlap: Optional[Callable[[], None]] = None) -> Dict[str, np.ndarray]:
        """One scheduling tick: admit what fits, launch one decode segment
        and its readback, run `overlap` (host work to hide behind the
        segment; its device work queues after the readback), stage the
        requests for the rows the segment ends at their caps, harvest
        finished rows. Returns {uid: (T, nq) tokens} finished this tick
        (prompt included, eos removed)."""
        self._admit_ready()
        busy = [s for s in range(self.B) if self._slot_uid[s] is not None]
        if not busy:
            if overlap is not None:
                overlap()
            return self._pop_finished()
        steps = min(self.segment_steps, max(self._left[s] for s in busy))
        with span("lm_segment", device=self.device):
            live_steps = self._segment(steps)
        packed = torch.cat([self.live.long(), self.counts, live_steps.reshape(1), self.toks.reshape(-1)])
        copied = None
        if self.device.type == "cuda":  # into pinned memory behind one event, so the readback waits for it alone
            packed = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True).copy_(packed, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(self.device))
        if overlap is not None:
            overlap()
        self._stage(steps, busy)
        B = self.B
        with span("harvest", wait=True):
            if copied is not None:
                copied.synchronize()
            out = packed.numpy()
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
        while self.busy:
            out.update(self.poll())
        return out

    @property
    def busy(self) -> bool:
        return bool(self._queue) or self._staged is not None or any(u is not None for u in self._slot_uid)

    # ----------------------------------------------------------- scheduling

    def _admit_ready(self) -> None:
        """Fill the free slots: the staged requests first (a segment frees
        at least the slots it was staged for), then the queue's next
        requests, prefilled in one batch."""
        free = [s for s in range(self.B) if self._slot_uid[s] is None]
        if self._staged is not None:
            staged, self._staged = self._staged, None
            n = len(staged["reqs"])
            assert n <= len(free), "staged requests outnumber the free slots"
            self._commit(free[:n], staged)
            free = free[n:]
        free = free[: len(self._queue)]
        if free:
            self._commit(free, self._prefill([self._queue.popleft() for _ in free]))

    def _stage(self, steps: int, busy: List[int]) -> None:
        """Prefill, behind the segment just launched, as many of the queue's
        next requests as the segment ends rows at their caps."""
        n = min(sum(self._left[s] <= steps for s in busy), len(self._queue))
        if n:
            self._staged = self._prefill([self._queue.popleft() for _ in range(n)])

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

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the session's device; on a card through pinned
        memory without blocking, so it does not wait for the queued work."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(self.device, non_blocking=True) if self.device.type == "cuda" else t

    @torch.inference_mode()
    def _prefill(self, reqs: list) -> dict:
        """Embed the requests' [sos, text, task](+prompt) prefixes, text and
        prompt padded to their buckets (the longest of the batch; the true
        lengths mask the padding), right-align each into the budget
        [0, prefix_budget) and prefill them in one pass into a cache of
        their own: what ``_commit`` copies into their slots."""
        model, cfg, LP, n = self.model, self.cfg, self.prefix_budget, len(reqs)
        with span("admit", device=self.device, request_id=reqs[0][1]):
            texts = [np.asarray(r[2]) for r in reqs]
            prompts = [self._prompts[r[0]] for r in reqs]
            lt = np.array([t.shape[0] for t in texts], np.int64)
            P = np.array([p.shape[0] for p in prompts], np.int64)
            lt_b = int(-(-lt.max() // self.text_bucket) * self.text_bucket)
            if texts[0].ndim == 1:  # token ids: pad with ignore_id (embeds to zero)
                text_pad = np.full((n, lt_b), cfg.ignore_id, np.int64)
            else:
                text_pad = np.zeros((n, lt_b) + texts[0].shape[1:], np.float32)
            for i, t in enumerate(texts):
                text_pad[i, : len(t)] = t
            llm_len = lt + 2 + P
            # one upload of the rows' numbers: caps, seeds, text, prompt and prefix lengths
            nums = self._upload(np.stack([np.array([r[4] for r in reqs], np.int64),
                                          np.array([r[3] for r in reqs], np.int64), lt, P, llm_len]))
            cap_t, seed_t, tl, pl, ll = nums
            if P.max() > 0:
                P_b = int(-(-P.max() // self.prompt_bucket) * self.prompt_bucket)
                codec = np.zeros((n, P_b, cfg.predict_nq), np.int64)
                for i, p in enumerate(prompts):
                    codec[i, : len(p)] = p
                inputs, _ = model._prefix(self._upload(text_pad), tl, self._upload(codec), pl)
            else:
                inputs, _ = model._prefix(self._upload(text_pad), tl)
            emb = model.embed_prefill(inputs, tl + 1)  # (n, maxP, D), row i's prefix in [0, llm_len_i)
            shift = (LP - ll)[:, None]
            src = torch.arange(LP, device=self.device)[None, :] - shift  # budget position -> prefix position
            emb_pad = emb.gather(1, src.clamp(min=0)[..., None].expand(n, LP, emb.shape[-1]))
            emb_pad = emb_pad * (src >= 0)[..., None]
            valid = torch.arange(self.capacity, device=self.device)[None, :] >= shift
            # the prefill sees keys [0, LP) only: a cache of LP positions and
            # the distance table's rows of distances up to LP - 1
            cache = init_kv_cache(self.lm_cfg, n, LP, dtype=model.cache_dtype, device=self.device)
            rel_proj = None if self._rel_proj is None else [
                t[self.capacity - LP: self.capacity + LP - 1] for t in self._rel_proj]
            h, _ = model.codec_lm.encoder.step(cache, emb_pad.to(model.cache_dtype),
                                               attend_mask=valid[:, None, :LP].expand(n, LP, LP), rel_proj=rel_proj)
            logits = model.codec_lm.decoder(h[:, -1]).float()
        return dict(reqs=reqs, kv=cache.k + cache.v, logits=logits, valid=valid, cap=cap_t, seed=seed_t)

    @torch.inference_mode()
    def _commit(self, slots: List[int], staged: dict) -> None:
        """Copy prefilled requests into their slots' cache rows and arm the rows."""
        slot_t = self._upload(np.asarray(slots, np.int64))
        LP = self.prefix_budget
        # index_fill_ / index_copy_: an indexed assignment of a Python scalar would copy it from the host
        for dst, src_kv in zip(self.cache.k + self.cache.v, staged["kv"]):
            dst[slot_t, :LP] = src_kv
        self.logits.index_copy_(0, slot_t, staged["logits"])
        self.cache.length.index_fill_(0, slot_t, LP)
        self.toks.index_fill_(0, slot_t, 0)
        self.counts.index_fill_(0, slot_t, 0)
        self.row_max.index_copy_(0, slot_t, staged["cap"])
        self.live.index_fill_(0, slot_t, True)
        self.seeds.index_copy_(0, slot_t, staged["seed"])
        self.valid_key.index_copy_(0, slot_t, staged["valid"])
        for slot, (uid, *_, cap) in zip(slots, staged["reqs"]):
            self.stats["admitted"] += 1
            self._slot_uid[slot] = uid
            self._cap[slot] = self._left[slot] = cap

    @torch.inference_mode()
    def _segment(self, steps: int) -> torch.Tensor:
        """`steps` AR steps for all slots; returns the live-step count (a device scalar)."""
        self._live_steps.zero_()
        if self._graph is None:
            for _ in range(steps):
                self._step()
        else:
            with torch.cuda.device(self.device):  # a graph replays on the current device's stream
                for _ in range(steps):
                    self._graph.replay()
        return self._live_steps

    def _step(self) -> None:
        """One AR step of every slot, in place on the session's tensors: a
        live row samples its next group and, unless that is eos, writes it,
        its K/V and advances; every row steps, only emitting rows write."""
        model, nq = self.model, self.cfg.predict_nq
        live = self.live
        self._live_steps += live.sum()
        groups = sample_groups(self.logits, nq, self.sampling, self.seeds, self.counts)
        emit = live & ~(groups == self.eos).any(dim=-1)
        idx = self.counts.clamp(max=self.max_new - 1)
        self.toks[self._rows, idx] = torch.where(emit[:, None], groups, self.toks[self._rows, idx])
        self.counts += emit
        self.live.copy_(emit & (self.counts < self.row_max))
        safe = groups.masked_fill(~emit[:, None], 0)
        logits, cache = model.lm_step(self.cache, safe, None, self.valid_key[:, None, :], self._rel_proj, self.max_new,
                                      write_mask=emit)
        self.cache.length.copy_(cache.length)
        self.logits.copy_(torch.where(self.live[:, None], logits.float(), self.logits))

    @torch.inference_mode()
    def _capture(self) -> "torch.cuda.CUDAGraph":
        """The step as a CUDA graph, captured before any admission: with no
        slot live, the warm-up steps (on a side stream, as capture needs)
        leave every tensor as it was."""
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(2):
                    self._step()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                self._step()
        return graph


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
