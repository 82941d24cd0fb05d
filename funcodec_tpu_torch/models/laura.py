"""LauraGPT-style text-to-audio generation model, inference half (port of
funcodec_tpu/models/laura.py).

Two stages, as in the JAX package: a decoder-only codec LM over
[sos, text, task_id, codec_emb] predicts the first `predict_nq` token groups
(a flattened (codebook_size + 1) * nq softmax, the text prefix attending
bidirectionally), and a non-autoregressive codec encoder predicts dense
codec embeddings from the text and the first groups' one-hots.

AR decoding runs through the KV cache of models/transformer.py as a host
loop over a step function. The loop never waits on the card per step: the
done flags, counts and tokens stay on the device, rows that are done keep
stepping with their outputs discarded, and the host reads the flags back
once every `segment_steps` steps. ``host_syncs`` counts those readbacks.

Sampling draws come from a counter-based hash (``draw_uniforms``): a
request's draw at step i in group g depends only on (its seed, i, g, the
vocabulary index), not on its batch, slot, co-tenants or device, so the
batched, serving and batch-1 decodes of a request with one seed sample the
same tokens. The draws differ from jax.random's.

Training: ``forward`` is the training loss (the LM's label-smoothed NLL of
the first groups plus the codec encoder's regression loss). Its draws (the
SpecAug spans of ops/augment.py, the scheduled sampler's uniforms) come from
an explicit ``torch.Generator``; ``prob_sampler`` also takes the uniforms
and ``_aug_segment`` the spans, so a caller can replay jax.random's.
Straight-through estimators are written ``x + (y - x).detach()``.

Under data parallelism ``forward`` takes the rank's
``parallel.dist.DataGroup`` (None: one process) and this rank's equal
block of a batch bucketed as a whole. Its denominators are the global
batch's, as in JAX: the NLL's and the regression loss's numerators and
denominators and the accuracies go through one ``global_sum``, so a rank
whose rows hold fewer tokens weighs less, and the draws are made at the
global batch's shape, each rank keeping its rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from funcodec_tpu_torch.models.transformer import (
    KVCache,
    TransformerConfig,
    TransformerEncoder,
    apply_abs_pos,
    causal_mask,
    init_kv_cache,
    linear,
    make_pad_mask_bool,
    table,
    _is_meta,
)
from funcodec_tpu_torch.ops.augment import spec_aug, utterance_mvn
from funcodec_tpu_torch.parallel.dist import DataGroup, draw_rows, global_sum, local_rows, world_of

Sampling = Union[bool, int, float]
TIME_WARP = ("apply_time_warp", "time_warp_window", "time_warp_mode")  # SpecAug keys spec_aug does not take


# ---------------------------------------------------------------------------
# ragged helpers
# ---------------------------------------------------------------------------


def ragged_concat(segments: List[torch.Tensor], lengths: List[torch.Tensor], total_max: int) -> torch.Tensor:
    """Per-row concat of variable-length segments (B, Li, D) into (B, total_max, D)."""
    B, D = segments[0].shape[0], segments[0].shape[-1]
    dtype = segments[0].dtype
    for s in segments[1:]:
        dtype = torch.promote_types(dtype, s.dtype)
    dev = segments[0].device
    out = torch.zeros(B, total_max + 1, D, dtype=dtype, device=dev)
    offset = torch.zeros(B, dtype=torch.int64, device=dev)
    for seg, ln in zip(segments, lengths):
        j = torch.arange(seg.shape[1], device=dev)[None, :]
        valid = j < ln[:, None]
        dest = torch.where(valid, offset[:, None] + j, total_max)
        vals = torch.where(valid[..., None], seg.to(dtype), 0.0)
        out.scatter_add_(1, dest[..., None].expand(-1, -1, D), vals)
        offset = offset + ln.long()
    return out[:, :total_max]


def pad_requests(texts, prompts, nq: int, ignore_id: int = -1):
    """Ragged requests -> decode_codec_batch's arrays. `texts`: (L_b,) ids or
    (L_b, D) features; `prompts`: (P_b, nq) tokens or None. Returns (text
    (B, L_max[, D]) padded with ignore_id or zeros, text_lengths (B,),
    prompts (B, max(P_max, 1), nq) zero-padded, prompt_lengths (B,))."""
    B = len(texts)
    tl = np.array([len(t) for t in texts], np.int64)
    pl = np.array([0 if p is None else len(p) for p in prompts], np.int64)
    first = np.asarray(texts[0])
    if first.dtype.kind in "iu":
        text = np.full((B, tl.max()), ignore_id, np.int64)
    else:
        text = np.zeros((B, tl.max()) + first.shape[1:], np.float32)
    prompt = np.zeros((B, max(int(pl.max()), 1), nq), np.int64)
    for b, (t, p) in enumerate(zip(texts, prompts)):
        text[b, : tl[b]] = t
        if pl[b]:
            prompt[b, : pl[b]] = p
    return text, tl, prompt, pl


def gather_window(x: torch.Tensor, starts: torch.Tensor, window: int) -> torch.Tensor:
    """out[b, j] = x[b, starts[b] + j] for j < window (clipped)."""
    B, T = x.shape[0], x.shape[1]
    idx = (starts[:, None].long() + torch.arange(window, device=x.device)).clamp(0, T - 1)
    return x.gather(1, idx.reshape(B, window, *([1] * (x.dim() - 2))).expand(B, window, *x.shape[2:]))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

_GOLDEN = 0x9E3779B97F4A7C15
_MUL1, _MUL2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB


def _signed(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def splitmix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's output function over int64 tensors (uint64 bit patterns;
    int64 products wrap modulo 2**64 on the CPU and the card)."""
    z = z + _signed(_GOLDEN)
    z = (z ^ _srl(z, 30)) * _signed(_MUL1)
    z = (z ^ _srl(z, 27)) * _signed(_MUL2)
    return z ^ _srl(z, 31)


def draw_uniforms(seeds: torch.Tensor, steps: Union[int, torch.Tensor], groups: int, vocab: int) -> torch.Tensor:
    """float64 uniforms in (0, 1), (B, groups, vocab): element (b, g, v) is a
    hash of (seeds[b], step of row b, g, v) alone."""
    dev = seeds.device
    row = splitmix64(splitmix64(seeds.long()) ^ steps)  # (B,); an int step stays a kernel argument (no copy)
    gv = torch.arange(groups * vocab, dtype=torch.int64, device=dev).reshape(groups, vocab)
    h = splitmix64(row[:, None, None] ^ splitmix64(gv))
    return (_srl(h, 11).double() + 0.5) * (1.0 / (1 << 53))


def _masked_logp(scores: torch.Tensor, sampling: Sampling) -> torch.Tensor:
    """float64 log-probabilities over the candidate set (-inf outside it).
    scores (..., V). bool True: the full softmax; int k: the k most probable
    (ties to the lower index); float p: the smallest prefix of the stably
    sorted probabilities whose mass before each member is < p."""
    logits = scores.double()
    if isinstance(sampling, bool):
        return logits
    prob = torch.softmax(scores.float(), dim=-1)
    if isinstance(sampling, int):
        order = torch.sort(prob, dim=-1, descending=True, stable=True).indices[..., :sampling]
        keep = torch.zeros_like(prob, dtype=torch.bool).scatter_(-1, order, True)
    elif isinstance(sampling, float):
        sorted_p, order = torch.sort(prob, dim=-1, descending=True, stable=True)
        cum_before = torch.cumsum(sorted_p, dim=-1) - sorted_p
        keep = torch.zeros_like(prob, dtype=torch.bool).scatter_(-1, order, cum_before < sampling)
    else:
        raise NotImplementedError(type(sampling))
    logp = torch.log(prob.clamp_min(1e-20)).double()
    return logp.masked_fill(~keep, float("-inf"))


def sample_groups(logits: torch.Tensor, nq: int, sampling: Sampling, seeds: torch.Tensor,
                  steps: Union[int, torch.Tensor]) -> torch.Tensor:
    """One token per group (JAX _sample_group semantics) for every row.

    logits (B, nq * V) -> (B, nq) int64. False: argmax, first max on ties;
    otherwise a Gumbel-max over `_masked_logp` with `draw_uniforms`."""
    scores = logits.reshape(logits.shape[0], nq, -1)
    if isinstance(sampling, bool) and not sampling:
        return scores.argmax(dim=-1)
    u = draw_uniforms(seeds, steps, nq, scores.shape[-1])
    return (_masked_logp(scores, sampling) - torch.log(-torch.log(u))).argmax(dim=-1)


# ---------------------------------------------------------------------------
# configuration and model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LauraConfig:
    """The JAX package's LauraConfig (LauraGenModel kwargs)."""

    input_size: int = 512
    vocab_size: int = 0
    num_quantizers: int = 32
    codebook_size: int = 1024
    codebook_dim: int = 128
    predict_nq: int = 2
    codec_sampling_ratio: float = 0.0
    lsm_weight: float = 0.0
    length_normalized_loss: bool = True
    ignore_id: int = -1
    pos_emb_type: str = "split"  # split | uni (codec_encoder inputs)
    lm_pe_type: str = "uni"  # uni | split (TransformerEmbedLM pe_type)

    @property
    def lm_out_voc_size(self) -> int:
        return (self.codebook_size + 1) * self.predict_nq

    @property
    def sos_eos(self) -> int:
        return 0

    @property
    def task_id(self) -> int:
        return 1


class QuantizerCodebook(nn.Module):
    """The frozen codebooks (``quantizer_codebook.embed``), grafted from a codec."""

    def __init__(self, cfg: LauraConfig, *, device):
        super().__init__()
        self.embed = nn.Parameter(
            torch.zeros(cfg.num_quantizers, cfg.codebook_size, cfg.codebook_dim, device=device),
            requires_grad=False)


class CodecLM(nn.Module):
    """TransformerEmbedLM: ``codec_lm.encoder``, ``.decoder`` and (split PE) ``.input_layer``."""

    def __init__(self, cfg: LauraConfig, lm_cfg: TransformerConfig, *, device, generator):
        super().__init__()
        self.encoder = TransformerEncoder(lm_cfg, device=device, generator=generator)
        if cfg.lm_pe_type == "split":
            self.input_layer = linear(cfg.codebook_dim, lm_cfg.attention_dim, device=device, generator=generator)
        self.decoder = linear(lm_cfg.attention_dim, cfg.lm_out_voc_size, device=device, generator=generator)


def _normal_embedding(n: int, d: int, *, device, generator) -> nn.Embedding:
    m = nn.Embedding(n, d, device=device)
    if not _is_meta(device):
        with torch.no_grad():
            m.weight.normal_(generator=generator)
    return m


class LauraGenModel(nn.Module):
    """LauraGenModel under the reference names (text_encoder, codec_lm, ...)."""

    def __init__(
        self,
        cfg: LauraConfig,
        text_encoder_cfg: Optional[TransformerConfig],
        codec_encoder_cfg: TransformerConfig,
        codec_lm_cfg: TransformerConfig,
        input_aug_conf: Optional[dict] = None,
        output_aug_conf: Optional[dict] = None,
        input_normalize: bool = False,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.text_encoder_cfg, self.codec_encoder_cfg, self.codec_lm_cfg = (
            text_encoder_cfg, codec_encoder_cfg, codec_lm_cfg)
        self.input_aug_conf, self.output_aug_conf, self.input_normalize = (
            input_aug_conf, output_aug_conf, input_normalize)
        kw = dict(device=device, generator=generator)
        if text_encoder_cfg is not None:
            self.text_encoder = TransformerEncoder(text_encoder_cfg, **kw)
            text_out = text_encoder_cfg.attention_dim
        else:
            text_out = cfg.input_size
        self.text_enc_out_layer = linear(text_out, cfg.codebook_dim, **kw)
        if cfg.vocab_size > 0:
            self.token_embedding = _normal_embedding(cfg.vocab_size, cfg.input_size, **kw)
        self.lm_embedding = _normal_embedding(2, cfg.codebook_dim, **kw)
        self.codec_lm = CodecLM(cfg, codec_lm_cfg, **kw)
        self.codec_encoder = TransformerEncoder(codec_encoder_cfg, **kw)
        self.codec_encoder_out_layer = linear(codec_encoder_cfg.attention_dim, cfg.codebook_dim, **kw)
        self.quantizer_codebook = QuantizerCodebook(cfg, device=device)
        self.host_syncs = 0  # host readbacks of decode state (decode_codec, decode_codec_batch)

    @property
    def device(self) -> torch.device:
        return self.quantizer_codebook.embed.device

    @property
    def cache_dtype(self) -> torch.dtype:
        """The KV cache's dtype: lm_decoder's weight's."""
        return self.codec_lm.decoder.weight.dtype

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=self.device, dtype=dtype or t.dtype)

    # -- pieces ---------------------------------------------------------------

    def calc_dense_vector(self, codec: torch.Tensor, codec_lengths: torch.Tensor) -> torch.Tensor:
        """Sum of frozen codebook vectors: codec (B, T, nq) -> (B, T, D), zero past codec_lengths."""
        embed = self.quantizer_codebook.embed
        nq = codec.shape[-1]
        mask = make_pad_mask_bool(codec_lengths, codec.shape[1])[..., None]
        codec = torch.where(mask, codec, 0).long()
        dense = embed[0][codec[..., 0]]
        for q in range(1, nq):
            dense = dense + embed[q][codec[..., q]]
        return dense * mask

    def encode_text(self, text: torch.Tensor, text_lengths: torch.Tensor):
        """Text encoder + projection to codebook_dim."""
        cfg = self.cfg
        if cfg.vocab_size > 0:
            valid = text != cfg.ignore_id
            text = self.token_embedding(torch.where(valid, text, 0).long()) * valid[..., None]
        else:
            text = text.to(self.text_enc_out_layer.weight.dtype)
        if self.text_encoder_cfg is not None:
            mask = make_pad_mask_bool(text_lengths, text.shape[1])[:, None, :]
            h = self.text_enc_out_layer(self.text_encoder(text, mask))
        elif text.shape[-1] == cfg.codebook_dim:
            h = text
        else:
            h = self.text_enc_out_layer(text)
        return h, text_lengths

    def _aug_segment(self, seg, lengths, conf: dict, generator: Optional[torch.Generator], spans=None,
                     group: Optional[DataGroup] = None):
        """SpecAug one LM segment on its valid rows, with identity gradients
        (the reference masks under no_grad: values change, the autograd
        graph does not). Spans are drawn over the padded buffer; `spans`
        ((freq_widths, freq_starts), (time_widths, time_starts)) replays
        given ones (at the global batch's shape)."""
        kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in conf.items() if k not in TIME_WARP}
        freq, time = spans if spans is not None else (None, None)
        auged = spec_aug(seg, generator, freq_spans=freq, time_spans=time, group=group, **kwargs)
        valid = make_pad_mask_bool(lengths, seg.shape[1])[..., None]
        auged = torch.where(valid, auged, seg)
        return seg + (auged - seg).detach()

    def build_llm_io(self, text, text_lengths, codec=None, codec_lengths=None,
                     aug: Optional[torch.Generator] = None, group: Optional[DataGroup] = None):
        """[sos, text, task] (+ codec embeddings) LM inputs and their
        lengths. `aug` (training only) turns on the input / output SpecAug
        and the input MVN the model was built with, drawing from it."""
        cfg = self.cfg
        B, Lt = text.shape[0], text.shape[1]
        if aug is not None:
            if self.input_aug_conf is not None:
                text = self._aug_segment(text, text_lengths, self.input_aug_conf, aug, group=group)
            if self.input_normalize:
                valid = make_pad_mask_bool(text_lengths, Lt)[..., None]
                normed = torch.where(valid, utterance_mvn(text, text_lengths), text)
                text = text + (normed - text).detach()
        emb = self.lm_embedding.weight
        sos = emb[cfg.sos_eos].expand(B, 1, cfg.codebook_dim)
        task = emb[cfg.task_id].expand(B, 1, cfg.codebook_dim)
        ones = torch.ones(B, dtype=torch.int64, device=text.device)
        segments, seg_lens, total = [sos, text, task], [ones, text_lengths.long(), ones], 2 + Lt
        if codec is not None:
            codec_emb = self.calc_dense_vector(codec, codec_lengths)
            if aug is not None and self.output_aug_conf is not None:
                # the reference's aug length: input_lengths - speech_len - 2 = Lc - 1
                codec_emb = self._aug_segment(codec_emb, codec_lengths - 1, self.output_aug_conf, aug, group=group)
            segments.append(codec_emb)
            seg_lens.append(codec_lengths.long())
            total += codec.shape[1]
        llm_lengths = text_lengths + 2
        if codec is not None:
            llm_lengths = llm_lengths + codec_lengths
        return ragged_concat(segments, seg_lens, total), llm_lengths

    def _apply_split_pe(self, inputs, speech_lengths):
        """pe_type 'split': absolute positions restart at the codec segment,
        the <task_id> slot is left untouched, then the input Linear."""
        B, T, D = inputs.shape
        pe = table("abs", T, inputs)
        pos = torch.arange(T, device=inputs.device)[None, :]
        L = speech_lengths[:, None]
        prefix, suffix = pos < L, pos > L
        pe_idx = torch.where(prefix, pos, (pos - L - 1).clamp_min(0))
        posed = inputs * math.sqrt(D) + pe[pe_idx]
        return self.codec_lm.input_layer(torch.where((prefix | suffix)[..., None], posed, inputs))

    def _lm_forward(self, inputs, input_lengths, speech_lengths):
        """Codec LM forward with the bidirectional [sos, text] prefix -> logits."""
        T = inputs.shape[1]
        pos = torch.arange(T, device=inputs.device)
        bidir = (pos[None, None, :] < speech_lengths[:, None, None]) & (pos[None, :, None] < speech_lengths[:, None, None])
        valid = make_pad_mask_bool(input_lengths, T)
        mask = (causal_mask(input_lengths, T) | bidir) & valid[:, None, :] & valid[:, :, None]
        if self.cfg.lm_pe_type == "split":
            inputs = self._apply_split_pe(inputs, speech_lengths)
        return self.codec_lm.decoder(self.codec_lm.encoder(inputs, mask))

    def nll(self, text, text_lengths, codec, codec_lengths, aug: Optional[torch.Generator] = None,
            group: Optional[DataGroup] = None):
        """The first groups' LM loss terms: (nll (B, Lc + 1, nq), logits
        (B, Lc + 1, nq, V), target, y_lengths). `text` is the encoded text."""
        cfg = self.cfg
        B, Lc = codec.shape[0], codec.shape[1]
        inputs, input_lengths = self.build_llm_io(text, text_lengths, codec, codec_lengths, aug=aug, group=group)
        y = self._lm_forward(inputs, input_lengths, text_lengths + 1)
        V = cfg.codebook_size + 1
        # logits at positions text_len + 1 .. text_len + 1 + codec_len
        logits = gather_window(y, text_lengths + 1, Lc + 1).reshape(B, Lc + 1, cfg.predict_nq, V)
        # targets: the codec tokens, then <eos> = codebook_size
        eos_row = torch.full((B, 1, cfg.predict_nq), cfg.codebook_size, dtype=torch.int64, device=codec.device)
        padded_codec = torch.cat([codec.long(), eos_row], dim=1)
        pos = torch.arange(Lc + 1, device=codec.device)[None, :, None]
        target = torch.where(pos == codec_lengths[:, None, None], cfg.codebook_size + cfg.sos_eos, padded_codec)
        target = torch.where(pos <= codec_lengths[:, None, None], target, 0)
        # label-smoothed CE in its KL form (losses/label_smoothing_loss.py), fp32
        logp = F.log_softmax(logits.float(), dim=-1)
        smoothing = cfg.lsm_weight
        confidence, off_value = 1.0 - smoothing, smoothing / (V - 1)
        true_logp = logp.gather(-1, target[..., None])[..., 0]
        nll = -(confidence * true_logp + off_value * (logp.sum(dim=-1) - true_logp))
        if smoothing > 0:
            # KL(targets || p) adds the constant negative entropy of the targets
            nll = nll + (confidence * math.log(confidence + 1e-20) + (V - 1) * off_value * math.log(off_value + 1e-20))
        y_lengths = codec_lengths + 1
        nll = torch.where(make_pad_mask_bool(y_lengths, Lc + 1)[..., None], nll, 0.0)
        return nll, logits, target, y_lengths

    def prob_sampler(self, logits, codec, codec_lengths, generator: Optional[torch.Generator],
                     uniform: Optional[torch.Tensor] = None, group: Optional[DataGroup] = None):
        """Scheduled sampling with a straight-through one-hot; logits (B, Lc,
        nq, bins). A predicted group replaces the ground truth where it is
        correct or where its uniform (drawn from `generator`, or given, at
        the global batch's shape (B * world, Lc, nq)) exceeds
        codec_sampling_ratio."""
        cfg = self.cfg
        Lc = logits.shape[1]
        valid = make_pad_mask_bool(codec_lengths, Lc)[:, :, None, None]
        # an fp32 softmax island, cast back: the argmax runs on the cast
        # probabilities (bf16 ties go to the first maximum, as in JAX)
        soft = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        pred_token = soft.argmax(dim=-1)
        hard = F.one_hot(pred_token, cfg.codebook_size).to(soft.dtype)
        pred_prob = soft + (hard - soft).detach()
        if cfg.codec_sampling_ratio == 0.0:
            return pred_prob * valid
        gt = F.one_hot(codec.long().clamp(0, cfg.codebook_size - 1), cfg.codebook_size).to(soft.dtype)
        if cfg.codec_sampling_ratio == 1.0:
            return gt * valid
        correct = pred_token == codec
        if uniform is None:
            uniform = draw_rows(lambda n: torch.rand((n, *correct.shape[1:]), generator=generator,
                                                     device=logits.device), correct.shape[0], group)
        else:
            uniform = local_rows(uniform, group)
        use_pred = correct | (~correct & (uniform > cfg.codec_sampling_ratio))
        return torch.where(use_pred[..., None], pred_prob, gt) * valid

    @staticmethod
    def _reg_sums(prediction, target, lengths) -> torch.Tensor:
        """The regression loss's masked sums: [sum |d|, sum d^2, mask count] fp32."""
        d = target.shape[-1]
        mask = (torch.arange(d, device=target.device)[None, None, :] < lengths[:, None, None]).float()
        mask = mask.expand(target.shape)
        diff = prediction - target
        return torch.stack([(diff.abs() * mask).sum(), (diff ** 2 * mask).sum(), mask.sum()])

    @staticmethod
    def _reg_loss(sums: torch.Tensor):
        """(loss, l1, l2) from [sum |d|, sum d^2, mask count]."""
        denom = sums[2].clamp_min(1.0)
        l1 = sums[0] / denom
        l2 = 0.5 * sums[1] / denom
        return l1 * 0.5 + l2 * 0.5, l1, l2

    def calc_reg_loss(self, prediction, target, lengths):
        """Masked 0.5 * L1 + 0.5 * (0.5 * L2): (loss, l1, l2).

        The reference's quirk is kept: make_pad_mask(length, target) masks
        the FEATURE axis (d < codec_len), not time, so with codec_len >=
        codebook_dim the mask is all ones and zero-padded time rows count in
        the denominator."""
        return self._reg_loss(self._reg_sums(prediction, target, lengths))

    def forward(self, text, text_lengths, codec, codec_lengths,
                generator: Optional[torch.Generator] = None,
                group: Optional[DataGroup] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss and its stats; codec (B, Lc, >= predict_nq).
        Draws come from `generator` in order: the SpecAug spans when the
        model augments, then the sampler's uniforms. With a data `group`
        the rows are this rank's block and the loss and stats the global
        batch's (module docstring)."""
        cfg = self.cfg
        nq = cfg.predict_nq
        codec = codec.long()
        text, text_lengths = self.encode_text(text, text_lengths)
        augments = bool(self.input_aug_conf or self.output_aug_conf or self.input_normalize)
        nll, logits, target, target_lengths = self.nll(
            text, text_lengths, codec[:, :, :nq], codec_lengths, aug=generator if augments else None, group=group)
        out_mask = make_pad_mask_bool(target_lengths, nll.shape[1])[..., None]
        denom = out_mask.sum() * nq if cfg.length_normalized_loss else nll.shape[0] * nq

        prob = self.prob_sampler(logits[:, :-1, :, : cfg.codebook_size], codec[:, :, :nq], codec_lengths, generator,
                                 group=group)
        codec_emb, _ = self.cal_codec_emb(text, text_lengths, prob, codec_lengths)
        target_emb = self.calc_dense_vector(codec, codec_lengths)
        # per-group accuracy; the reference's quirk is kept: padded positions
        # carry zero logits and target 0, and pads count as correct
        pred = torch.where(out_mask[..., None], logits, 0.0).argmax(dim=-1)
        accs = [(pred[:, :, i] == target[:, :, i]).float().mean() for i in range(nq)]
        # numerators, denominators and accuracies of the global batch: one all_reduce
        sums = global_sum(torch.stack([(nll * out_mask).sum(), torch.as_tensor(denom, device=nll.device).float(),
                                       *self._reg_sums(codec_emb, target_emb, codec_lengths), *accs]), group)
        nll_loss = sums[0] / sums[1].clamp_min(1)
        reg_loss, l1, l2 = self._reg_loss(sums[2:5])
        loss = reg_loss + nll_loss
        stats = dict(loss=loss, nll_loss=nll_loss, reg_loss=reg_loss, reg_l1_loss=l1, reg_l2_loss=l2)
        for i in range(nq):
            stats[f"out_acc_{i + 1}"] = sums[5 + i] / world_of(group)
        return loss, stats

    # -- AR decode with a KV cache ----------------------------------------------

    def embed_prefill(self, inputs, speech_lengths):
        """LM input embedding of a whole prefix."""
        if self.cfg.lm_pe_type == "split":
            return self._apply_split_pe(inputs, speech_lengths)
        self._check_cached_pe()
        return self.codec_lm.encoder.embed_input(inputs)[0]

    def embed_step(self, dense, codec_pos: torch.Tensor, max_length: int):
        """LM input embedding of one token group per row, dense (B, 1, D);
        codec_pos (B,) is each row's position in its codec segment (split PE)."""
        if self.cfg.lm_pe_type == "split":
            D = dense.shape[-1]
            pe = table("abs", max_length + 4096, dense)
            return self.codec_lm.input_layer(dense * math.sqrt(D) + pe[codec_pos][:, None])
        return self.codec_lm.encoder.embed_input(dense)[0]

    def _check_cached_pe(self) -> None:
        if self.codec_lm_cfg.pos_enc_type not in ("rel_pos", "none"):
            raise NotImplementedError("KV-cache decode supports rel_pos/none/split codec LMs")

    def lm_step(self, cache: KVCache, groups, codec_pos, attend_mask, rel_proj, max_length, write_mask=None):
        """Feed one token group per row (B, nq): (logits (B, nq * V), cache)."""
        ones = torch.ones(groups.shape[0], dtype=torch.int64, device=groups.device)
        x = self.embed_step(self.calc_dense_vector(groups[:, None, :], ones), codec_pos, max_length)
        h, cache = self.codec_lm.encoder.step(cache, x, attend_mask=attend_mask, rel_proj=rel_proj,
                                              write_mask=write_mask)
        return self.codec_lm.decoder(h[:, -1]), cache

    def _prefix(self, text, text_lengths, continual=None, continual_lengths=None):
        """Text -> the LM prefix inputs (B, maxP, D) and their lengths."""
        text_h, text_lengths = self.encode_text(text, text_lengths)
        if continual is not None:
            return self.build_llm_io(text_h, text_lengths, codec=continual, codec_lengths=continual_lengths)
        return self.build_llm_io(text_h, text_lengths)

    @torch.inference_mode()
    def decode_codec(
        self,
        text,  # (1, Lt, D) raw text features or (1, Lt) ids
        text_lengths,
        max_length: int = 30 * 25,
        sampling: Sampling = 0.8,
        seed: int = 0,
        continual: Optional[np.ndarray] = None,  # (Lp, nq) prompt codec tokens
        segment_steps: int = 25,
    ) -> np.ndarray:
        """AR first-nq decode of one utterance: (1, T, predict_nq) int32
        tokens, the prompt included and eos removed."""
        cfg = self.cfg
        Lt = int(np.asarray(text_lengths).reshape(-1)[0])
        text = self._tensor(text)[:, :Lt]
        has_prompt = continual is not None and len(continual)
        prompt = (np.asarray(continual, np.int64).reshape(-1, cfg.predict_nq) if has_prompt
                  else np.zeros((0, cfg.predict_nq), np.int64))
        rows = self.decode_codec_batch(
            text, np.asarray([Lt]), max_length=max_length, sampling=sampling, seed=[seed],
            continual=prompt[None] if has_prompt else None,
            continual_lengths=np.asarray([len(prompt)]) if has_prompt else None,
            segment_steps=segment_steps)
        out = rows[0]
        if out.shape[0] == 0:
            return np.zeros((1, 0, cfg.predict_nq), np.int32)
        return out[None]

    @torch.inference_mode()
    def decode_codec_batch(
        self,
        text,  # (B, Lt_max, D) raw text features or (B, Lt_max) ids
        text_lengths,  # (B,)
        max_length: int = 30 * 25,
        sampling: Sampling = 0.8,
        seed: Union[int, Sequence[int]] = 0,
        continual: Optional[np.ndarray] = None,  # (B, Lp_max, nq) prompt tokens
        continual_lengths: Optional[np.ndarray] = None,  # (B,)
        segment_steps: int = 25,
    ) -> List[np.ndarray]:
        """Batched AR decode: B utterances step through one shared KV cache.

        Ragged prefixes are left-aligned in the cache (row b occupies
        [maxP - P_b, maxP)), so every row's generated tokens share slots and
        relative distances between valid tokens stay exact; the left-pad
        slots are masked out of every attention. `seed` gives row b's seed
        (an int: seed + b). Returns a list of (T_b, predict_nq) int32 arrays
        (prompt included, eos removed), each equal to decode_codec of its row
        with its seed."""
        cfg = self.cfg
        B = len(text_lengths)
        seeds = [seed + b for b in range(B)] if isinstance(seed, int) else list(seed)
        if continual is not None:
            prompts = np.asarray(continual, np.int64)
            prompt_lens = np.asarray(continual_lengths, np.int64)
        else:
            prompts = np.zeros((B, 0, cfg.predict_nq), np.int64)
            prompt_lens = np.zeros((B,), np.int64)
        emb, shift = self.batch_prefix(text, text_lengths, continual, continual_lengths)
        logits, cache, attend, rel_proj = self.prefill(emb, shift, max_length)
        toks, counts = self._decode_rows(logits, cache, attend, rel_proj, self._tensor(prompt_lens),
                                         self._tensor(np.asarray(seeds)), max_length, sampling, segment_steps)
        return [np.concatenate([prompts[b, : prompt_lens[b]], toks[b, : counts[b]]], axis=0).astype(np.int32)
                for b in range(B)]

    def batch_prefix(self, text, text_lengths, continual=None, continual_lengths=None):
        """The LM prefix embeddings of B requests, left-aligned (row b in
        [maxP - P_b, maxP)): (emb (B, maxP, D), shift (B,) = maxP - P_b)."""
        text = self._tensor(text)
        tl = self._tensor(np.asarray(text_lengths, np.int64))
        if continual is not None:
            inputs, llm_lengths = self._prefix(text, tl, self._tensor(np.asarray(continual, np.int64)),
                                               self._tensor(np.asarray(continual_lengths, np.int64)))
        else:
            inputs, llm_lengths = self._prefix(text, tl)
        emb = self.embed_prefill(inputs, tl + 1)
        maxP = emb.shape[1]
        shift = maxP - llm_lengths.long()
        src = (torch.arange(maxP, device=emb.device)[None, :] - shift[:, None]) % maxP
        return emb.gather(1, src[..., None].expand(-1, -1, emb.shape[-1])), shift

    def prefill(self, emb, shift, max_length: int):
        """Prefill left-aligned prefixes into a new cache with room for
        max_length more groups: (logits (B, nq * V), cache, attend (B, 1, M)
        key validity, rel_proj)."""
        enc = self.codec_lm.encoder
        B, maxP = emb.shape[0], emb.shape[1]
        max_total = maxP + max_length + 1
        valid_key = torch.arange(max_total, device=emb.device)[None, :] >= shift[:, None]  # (B, M)
        cache = init_kv_cache(self.codec_lm_cfg, B, max_total, dtype=self.cache_dtype, device=emb.device)
        rel_proj = enc.rel_proj(max_total)
        h, cache = enc.step(cache, emb, attend_mask=valid_key[:, None, :].expand(B, maxP, max_total),
                            rel_proj=rel_proj)
        return self.codec_lm.decoder(h[:, -1]), cache, valid_key[:, None, :], rel_proj

    def _decode_rows(self, logits, cache, attend, rel_proj, prompt_lens, seeds, max_length, sampling, segment_steps):
        """AR-decode from prefilled rows: (toks (B, max_length, nq), counts (B,)) numpy."""
        cfg = self.cfg
        B, dev = logits.shape[0], logits.device
        eos = cfg.codebook_size + cfg.sos_eos
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        counts = torch.zeros(B, dtype=torch.int64, device=dev)
        toks = torch.zeros(B, max_length, cfg.predict_nq, dtype=torch.int64, device=dev)
        i = 0
        while i < max_length:
            for _ in range(min(segment_steps, max_length - i)):
                groups = sample_groups(logits, cfg.predict_nq, sampling, seeds, i)
                hits_eos = (groups == eos).any(dim=-1)
                emit = ~done & ~hits_eos
                toks[:, i] = groups * emit[:, None]
                counts += emit
                done |= hits_eos
                i += 1
                if i < max_length:  # done rows keep stepping; their outputs are discarded
                    safe = groups.masked_fill(done[:, None], 0)
                    logits, cache = self.lm_step(cache, safe, prompt_lens + (i - 1), attend, rel_proj, max_length)
            if i < max_length:
                self.host_syncs += 1
                if bool(done.all()):
                    break
        self.host_syncs += 1
        out = torch.cat([counts[:, None], toks.reshape(B, -1)], dim=1).cpu().numpy()
        return out[:, 1:].reshape(B, max_length, cfg.predict_nq), out[:, 0]

    # -- non-AR side ------------------------------------------------------------

    def cal_codec_emb(self, text, text_lengths, codec_prob, codec_lengths):
        """Non-AR dense embedding prediction; codec_prob (B, Lc, nq, bins)."""
        cfg = self.cfg
        embed = self.quantizer_codebook.embed[: cfg.predict_nq]
        first_nq_emb = torch.einsum("blnv,nvd->bld", codec_prob.to(embed.dtype), embed)
        if cfg.pos_emb_type == "split":
            text_in, codec_in = apply_abs_pos(text), apply_abs_pos(first_nq_emb)
        else:
            text_in, codec_in = text, first_nq_emb
        total = text.shape[1] + first_nq_emb.shape[1]
        model_inputs = ragged_concat([text_in, codec_in], [text_lengths.long(), codec_lengths.long()], total)
        mask = make_pad_mask_bool(text_lengths + codec_lengths, total)[:, None, :]
        h = self.codec_encoder_out_layer(self.codec_encoder(model_inputs, mask))
        outs = gather_window(h, text_lengths, first_nq_emb.shape[1])
        return outs * make_pad_mask_bool(codec_lengths, outs.shape[1])[..., None], codec_lengths

    @torch.inference_mode()
    def syn_audio(self, codec, text, text_lengths, codec_decoder: Callable, continual_length: Optional[int] = None):
        """Non-AR dense prediction -> `codec_decoder`(emb (1, T, D)) (a waveform)."""
        cfg = self.cfg
        codec = self._tensor(codec).long()[:, :, : cfg.predict_nq]
        prob = F.one_hot(codec.clamp(0, cfg.codebook_size - 1), cfg.codebook_size).float()
        codec_lengths = torch.tensor([codec.shape[1]], device=self.device)
        text_h, tl = self.encode_text(self._tensor(text), self._tensor(np.asarray(text_lengths).reshape(-1)))
        codec_emb, _ = self.cal_codec_emb(text_h, tl, prob, codec_lengths)
        return codec_decoder(codec_emb[:, continual_length or 0:])
