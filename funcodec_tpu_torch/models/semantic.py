"""Semantic-augmented codec: Encodec with PPG (phoneme posterior)
conditioning (port of funcodec_tpu/models/semantic.py).

Behavioral reference: funcodec/models/codec_semantic_aug.py
(CodecSemanticAug :117-769: the PPG embedding :178-201, _process_ppg
:357-383, _add_ppg_to_code :385-395, the usage modes of _forward_generator
:406-495, the classifier loss :396-405).

PPG usage modes (``ppg_usage_mod``):

- "residual": quantize (emb - ppg_emb); the decoder gets quantized + ppg_emb;
- "addition": quantize emb; the decoder gets quantized + ppg_emb;
- "concat" (any other name): the decoder gets conv([ppg_emb; quantized]);
- "supervision": the plain codec, plus a HuBERT-style phoneme CE of a
  classifier on the first quantizer's output;
- "ptts": quantize emb; the decoder gets quantized + ppg_emb +
  utt_level_emb. The reference calls an undefined calc_utt_level_emb
  there; as in the JAX package, the utterance-level embedding is the time
  mean of the pre-quantizer latents through a linear projection
  (``utt_level_proj``), broadcast over time.

The PPG arrives as ids (B, F) or posteriors (B, F, ppg_dim) (their argmax)
at the codec frame rate times ``ppg_ds_rate``; it is embedded
(``ppg_embedding``) and brought to the codec's rate by a conv stack
(``ppg_ds_layer``: SConv1d k7 with time_group_norm, ELU, SConv1d of stride
ppg_ds_rate) or by subsampling, then edge-padded or trimmed to the codec's
frames. As in the JAX package, the GAN train step does not route PPG
batches: ``forward_generator_ppg`` and ``inference_ppg`` are the entry
points.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from funcodec_tpu_torch.models.encodec import Discriminator, Encodec, EncodecConfig, _without_param_grad
from funcodec_tpu_torch.models.seanet import _build_stack
from funcodec_tpu_torch.ops.conv import ConvSpec
from funcodec_tpu_torch.parallel.dist import DataGroup, global_mean
from funcodec_tpu_torch.quant.rvq import RVQTensors

ELU = ("act", ("ELU", (("alpha", 1.0),)))


@dataclasses.dataclass(frozen=True)
class SemanticCodecConfig(EncodecConfig):
    ppg_dim: int = 86
    ppg_ds_rate: int = 2
    ppg_ds_type: str = "conv"  # conv | subsample
    ppg_usage_mod: str = "residual"  # residual | addition | concat | supervision | ptts
    ppg_supervision_weight: float = 1.0
    ppg_supervision_loss_weight: float = 1.0


class CodecSemanticAug(Encodec):
    """Encodec plus ``ppg_embedding``, ``ppg_ds_layer``, ``ppg_cond_layer``
    and, by mode, ``ppg_classifier`` (supervision) or ``utt_level_proj``
    (ptts), drawn from `generator` after the Encodec's own modules."""

    def __init__(self, cfg: SemanticCodecConfig, encoder, quantizer, decoder, *, device=None,
                 generator: torch.Generator):
        super().__init__(cfg, encoder, quantizer, decoder, device=device, generator=generator)
        if device is None:
            device = next(encoder.parameters()).device
        odim = cfg.odim
        self.ppg_ds_layers = [
            ("conv", ConvSpec(odim, odim, 7, norm="time_group_norm")),
            ELU,
            ("conv", ConvSpec(odim, odim, cfg.ppg_ds_rate * 2, stride=cfg.ppg_ds_rate, norm="none")),
        ]
        self.ppg_cond_layers = [("conv", ConvSpec(odim * 2, odim, 3, norm="none"))]
        self.ppg_classifier_layers = [
            ("conv", ConvSpec(odim, 512, 5, norm="time_group_norm")),
            ELU,
            ("conv", ConvSpec(512, 512, 3, norm="time_group_norm")),
            ELU,
            ("conv", ConvSpec(512, cfg.ppg_dim, 1, norm="time_group_norm")),
        ]
        self.ppg_embedding = nn.Embedding(cfg.ppg_dim, odim, device=device)
        with torch.no_grad():
            self.ppg_embedding.weight.normal_(generator=generator)
        self.ppg_ds_layer = _build_stack(self.ppg_ds_layers, device, generator)
        self.ppg_cond_layer = _build_stack(self.ppg_cond_layers, device, generator)
        if cfg.ppg_usage_mod == "supervision":
            self.ppg_classifier = _build_stack(self.ppg_classifier_layers, device, generator)
        if cfg.ppg_usage_mod == "ptts":
            self.utt_level_proj = nn.Linear(odim, odim, device=device)
            with torch.no_grad():
                bound = 1.0 / math.sqrt(odim)
                self.utt_level_proj.weight.uniform_(-bound, bound, generator=generator)
                self.utt_level_proj.bias.zero_()

    # -- ppg processing (codec_semantic_aug.py:357-395) ----------------------

    def _utt_level_emb(self, emb: torch.Tensor) -> torch.Tensor:
        """(B, 1, odim): the time mean of the latents through utt_level_proj."""
        return self.utt_level_proj(emb.mean(dim=1, keepdim=True))

    def _ppg_ids(self, ppg: torch.Tensor) -> torch.Tensor:
        return ppg.argmax(dim=-1) if ppg.dim() == 3 else ppg.long()

    def _process_ppg(self, ppg: torch.Tensor) -> torch.Tensor:
        """(B, F) ids or (B, F, ppg_dim) posteriors -> (B, F', odim)."""
        emb = self.ppg_embedding(self._ppg_ids(ppg))
        if self.cfg.ppg_ds_type == "conv":
            return self.ppg_ds_layer(emb.transpose(1, 2)).transpose(1, 2)
        return emb[:, :: self.cfg.ppg_ds_rate]

    @staticmethod
    def _match_len(ppg_emb: torch.Tensor, code_len: int) -> torch.Tensor:
        """The time axis edge-padded or trimmed to code_len (:387-390)."""
        if ppg_emb.shape[1] < code_len:
            ppg_emb = F.pad(ppg_emb.transpose(1, 2), (0, code_len - ppg_emb.shape[1]), mode="replicate").transpose(1, 2)
        return ppg_emb[:, :code_len]

    def _fuse(self, ppg_emb: torch.Tensor, code_embs: torch.Tensor) -> torch.Tensor:
        """The concat mode's fusion (:385-395): conv([ppg_emb; code])."""
        x = torch.cat([ppg_emb, code_embs.to(ppg_emb.dtype)], dim=-1)
        return self.ppg_cond_layer(x.transpose(1, 2)).transpose(1, 2)

    def _decoder_input(self, emb: torch.Tensor, seg: torch.Tensor, quantize):
        """(decoder input, indices, commit, sub_quants) of one frame in the
        configured mode; `quantize` maps latents to (q, indices, commit,
        sub_quants)."""
        mode = self.cfg.ppg_usage_mod
        if mode == "residual":
            q, idx, commit, subq = quantize(emb - seg)
            return q + seg, idx, commit, subq
        q, idx, commit, subq = quantize(emb)
        if mode == "addition":
            return q + seg, idx, commit, subq
        if mode == "ptts":
            return q + seg + self._utt_level_emb(emb), idx, commit, subq
        if mode == "supervision":
            return q, idx, commit, subq
        return self._fuse(seg, q), idx, commit, subq

    # -- training forward -----------------------------------------------------

    def _reconstruct_with_ppg(self, speech: torch.Tensor, ppg: torch.Tensor, generator: Optional[torch.Generator],
                              rvq_state: Optional[RVQTensors] = None, training: bool = True,
                              group: Optional[DataGroup] = None):
        """encode -> (PPG-conditioned) RVQ -> decode. Returns (recon, aux)
        with the commit loss, each frame's latent MSE (this rank's), the
        supervision CE (this rank's mean) and the new RVQ state."""
        ppg_emb = self._process_ppg(ppg)
        state = self.quantizer.state.tensors() if rvq_state is None else rvq_state
        commits, mses, codes = [], [], []
        sup_loss = torch.zeros((), device=speech.device)
        for emb, scale in self._encode(speech):
            seg = self._match_len(ppg_emb, emb.shape[1])

            def quantize(x):
                nonlocal state
                if training:
                    q, idx, commit, subq, state = self.quantizer.train_forward(x, generator, state, group=group)
                    return q, idx, commit, subq
                q, idx, subq = self.quantizer.inference(x)
                return q, idx, torch.zeros((), device=x.device), subq

            decoder_in, _, commit, subq = self._decoder_input(emb, seg, quantize)
            if self.cfg.ppg_usage_mod == "supervision":
                sup_loss = sup_loss + self._ppg_class_loss(subq[0], emb, ppg)
            commits.append(commit)
            mses.append((decoder_in.float() - emb.float()).square().mean())
            codes.append((decoder_in, scale))
        recon = self._decode(codes)[..., : speech.shape[-1]]
        aux = dict(commit_loss=torch.stack(commits).sum(), enc_quant_mses=torch.stack(mses),
                   ppg_supervision_loss=sup_loss, rvq_state=state)
        return recon, aux

    def _ppg_class_loss(self, quantized: torch.Tensor, enc_out: torch.Tensor, ppg: torch.Tensor) -> torch.Tensor:
        """The HuBERT-style phoneme CE on the first quantizer (:396-405): the
        classifier sees the latents with the quantizer's value (straight
        through) and their gradient scaled by ppg_supervision_weight; its
        labels are the PPG ids at every ppg_ds_rate-th frame; fp32 CE."""
        w = self.cfg.ppg_supervision_weight
        x = enc_out + (quantized - enc_out).detach()
        x = x * w + (x * (1.0 - w)).detach()
        logits = self.ppg_classifier(x.transpose(1, 2)).transpose(1, 2)
        labels = self._ppg_ids(ppg)[:, :: self.cfg.ppg_ds_rate]
        t = min(logits.shape[1], labels.shape[1])
        logp = torch.log_softmax(logits[:, :t].float(), dim=-1)
        return -logp.gather(-1, labels[:, :t, None])[..., 0].mean()

    def forward_generator_ppg(self, discriminator: Discriminator, speech: torch.Tensor, ppg: torch.Tensor,
                              generator: Optional[torch.Generator], rvq_state: Optional[RVQTensors] = None,
                              training: bool = True, group: Optional[DataGroup] = None):
        """The generator turn with PPG conditioning: Encodec's losses (the
        discriminator on the fp32 reconstruction and real signal, as the JAX
        package's) plus the supervision CE times
        ppg_supervision_loss_weight. Returns (loss, out) with out = {stats,
        rvq_state, gen_loss (detached), real, fake}; the terms are the global
        batch's (one global_mean)."""
        cfg = self.cfg
        orig = speech.float()
        recon, aux = self._reconstruct_with_ppg(speech, ppg, generator, rvq_state, training=training, group=group)
        recon = recon.float()
        recon_loss = (orig - recon).abs().mean()
        multi_spectral = self._multi_spectral_loss(orig, recon)
        disc = _without_param_grad(discriminator)
        fake_outs = disc(recon)
        with torch.no_grad():
            real_outs = disc(orig)
        adv, feat = [], []
        for (_, rf), (fl, ff) in zip(real_outs, fake_outs):
            adv.append(F.relu(1.0 - fl).mean())
            feat += [(a - b).abs().mean() for a, b in zip(rf, ff)]
        terms = global_mean(torch.stack([recon_loss, multi_spectral, torch.stack(adv).mean(),
                                         torch.stack(feat).mean(), aux["commit_loss"], aux["ppg_supervision_loss"],
                                         *aux["enc_quant_mses"]]), group)
        recon_loss, multi_spectral, adversarial_loss, feat_match_loss, commit_loss, sup_loss = terms[:6]
        enc_quant_loss = terms[6:].square().sum()
        gen_loss = (
            recon_loss * cfg.recon_loss_weight
            + multi_spectral * cfg.multi_spectral_recon_loss_weight
            + adversarial_loss * cfg.adversarial_loss_weight
            + feat_match_loss * cfg.feat_match_loss_weight
        )
        loss = (gen_loss + commit_loss + enc_quant_loss * cfg.enc_quant_loss_weight
                + sup_loss * cfg.ppg_supervision_loss_weight)
        stats = {k: v.detach() for k, v in dict(
            generator_loss=loss,
            generator_recon_loss=recon_loss,
            generator_multi_spectral_recon_loss=multi_spectral,
            generator_adv_loss=adversarial_loss,
            generator_feat_match_loss=feat_match_loss,
            generator_commit_loss=commit_loss,
            generator_enc_quant_loss=enc_quant_loss,
            ppg_supervision_loss=sup_loss,
        ).items()}
        out = dict(stats=stats, rvq_state=aux["rvq_state"], gen_loss=gen_loss.detach(), real=orig, fake=recon)
        return loss, out

    def inference_ppg(self, speech: torch.Tensor, ppg: torch.Tensor, need_recon: bool = True,
                      bit_width: Optional[int] = None, use_scale: bool = True) -> Dict[str, Any]:
        """PPG-conditioned inference (codec_semantic_aug.py:686+): the eval
        quantizer at `bit_width`'s depth in the configured mode."""
        ppg_emb = self._process_ppg(ppg)
        codes, idxs = [], []
        for emb, scale in self._encode(speech):
            seg = self._match_len(ppg_emb, emb.shape[1])

            def quantize(x):
                q, idx, subq = self.quantizer.inference(x, bandwidth=bit_width)
                return q, idx, None, subq

            decoder_in, indices, _, _ = self._decoder_input(emb, seg, quantize)
            codes.append((decoder_in, scale if use_scale else None))
            idxs.append(indices)
        recon = self._decode(codes)[..., : speech.shape[-1]] if need_recon else None
        return dict(recon_speech=recon, code_indices=idxs, code_embeddings=codes)
