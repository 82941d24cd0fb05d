"""EnCodec-style codec (port of funcodec_tpu/models/encodec.py).

normalize -> SEANet encode -> RVQ -> SEANet decode -> overlap-add -> trim.
Waveforms are (B, T) mono, latents (B, T', D), indices (n_q, B, T'), as in
the JAX package.

The GAN training forwards (``forward_generator``, ``forward_discriminator``
and the loss assemblies the shared-forward step reuses) take the
discriminator as a module or as a function of the waveform, and a
``torch.Generator`` for the quantizer's draws (and PhaseAug's, with
FreqCodec's phase-invariant training). They return the RVQ state
the step advanced to without writing the buffers; train/step.py commits it.
Recon, mel and loss reductions are fp32; the discriminator runs in the
reconstruction's type.

Under data parallelism the training forwards take the rank's
``parallel.dist.DataGroup`` (None: one process) and this rank's equal block
of the batch's rows. Each turn's loss terms (batch means) pass through one
``global_mean``, so that their values, the enc-quant loss (the square of
the global MSE) and the discriminator's gate are the global batch's on
every rank, and the ranks' mean gradient is the global loss's; the
quantizer's statistics and PhaseAug's draws are the global batch's too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from funcodec_tpu_torch.models.quantizer import Quantizer
from funcodec_tpu_torch.models.seanet import SEANetDecoder, SEANetEncoder
from funcodec_tpu_torch.ops.stft import audio_to_mel, phase_aug
from funcodec_tpu_torch.parallel.dist import DataGroup, global_mean
from funcodec_tpu_torch.quant.rvq import RVQTensors

Discriminator = Union[nn.Module, Callable[[torch.Tensor], List[Tuple[torch.Tensor, List[torch.Tensor]]]]]


@dataclasses.dataclass(frozen=True)
class EncodecConfig:
    """funcodec_tpu's EncodecConfig (model-level knobs and loss weights)."""

    input_size: int = 1
    odim: int = 128
    target_sample_hz: int = 16_000
    audio_normalize: bool = True
    segment_dur: Optional[float] = None
    overlap_ratio: Optional[float] = 0.01
    recon_loss_weight: float = 1.0
    multi_spectral_recon_loss_weight: float = 1.0
    adversarial_loss_weight: float = 1.0 / 9
    feat_match_loss_weight: float = 100.0 / 9
    enc_quant_loss_weight: float = 1.0
    multi_spectral_window_powers_of_two: Tuple[int, ...] = (5, 6, 7, 8, 9, 10)
    multi_spectral_n_mels: int = 64
    use_power_spec_loss: bool = False
    bypass_quantizer: bool = False
    # the context loss (codec_basic.py:224-238, models/context.py): off
    # unless the weight is positive and the flattened conf is given
    context_loss_weight: float = 0.0
    context_loss_conf: Optional[Tuple[Tuple[str, Any], ...]] = None

    @property
    def segment_length(self) -> Optional[int]:
        if self.segment_dur is None:
            return None
        return int(self.segment_dur * self.target_sample_hz)

    @property
    def segment_stride(self) -> Optional[int]:
        sl = self.segment_length
        if sl is None:
            return None
        return max(1, int((1 - (self.overlap_ratio or 0.0)) * sl))


def linear_overlap_add(frames: List[torch.Tensor], stride: int) -> torch.Tensor:
    """Triangular-window overlap-add of frames [(B, L)]."""
    assert frames
    dtype, device = frames[0].dtype, frames[0].device
    shape = frames[0].shape[:-1]
    total_size = stride * (len(frames) - 1) + frames[-1].shape[-1]
    frame_length = frames[0].shape[-1]
    t = torch.linspace(0.0, 1.0, frame_length + 2, dtype=dtype, device=device)[1:-1]
    weight = 0.5 - (t - 0.5).abs()
    sum_weight = torch.zeros(total_size, dtype=dtype, device=device)
    out = torch.zeros(*shape, total_size, dtype=dtype, device=device)
    offset = 0
    for frame in frames:
        fl = frame.shape[-1]
        out[..., offset : offset + fl] += weight[:fl] * frame
        sum_weight[offset : offset + fl] += weight[:fl]
        offset += stride
    return out / sum_weight


class Encodec(nn.Module):
    """EnCodec assembly; submodules ``encoder``, ``quantizer``, ``decoder``
    and, with the context loss, ``context`` (models/context.py, its weights
    drawn from `generator` on `device`, the encoder's by default)."""

    def __init__(
        self,
        cfg: EncodecConfig,
        encoder: SEANetEncoder,
        quantizer: Quantizer,
        decoder: SEANetDecoder,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.encoder = encoder
        self.quantizer = quantizer
        self.decoder = decoder
        self.context = None
        if cfg.context_loss_weight > 0 and cfg.context_loss_conf is not None:
            from funcodec_tpu_torch.models.context import ContextConfig, ContextModule

            conf = dict(cfg.context_loss_conf)
            conf.setdefault("odim", cfg.odim)
            if device is None:
                device = next(encoder.parameters()).device
            self.context = ContextModule(ContextConfig(**conf), device=device, generator=generator)

    # -- encode / decode ------------------------------------------------------

    def _segments(self, length: int) -> List[Tuple[int, int]]:
        """Static (offset, end) list; one frame when segment_dur is None."""
        seg = self.cfg.segment_length
        if seg is None:
            return [(0, length)]
        stride = self.cfg.segment_stride or 1
        return [(off, min(off + seg, length)) for off in range(0, length, stride)]

    def _encode_frame(self, x: torch.Tensor):
        """(B, T) -> (emb (B, T', D), scale (B, 1) fp32 or None)."""
        if self.cfg.audio_normalize:
            volume = x.float().square().mean(dim=-1, keepdim=True).sqrt()
            scale = 1e-8 + volume
            x = x / scale.to(x.dtype)
        else:
            scale = None
        return self.encoder(x), scale

    def _encode(self, x: torch.Tensor):
        return [self._encode_frame(x[:, off:end]) for off, end in self._segments(x.shape[-1])]

    def _decode_frame(self, emb: torch.Tensor, scale) -> torch.Tensor:
        """(B, T', D) -> (B, T)."""
        out = self.decoder(emb)[..., 0]
        if scale is not None:
            out = out * scale.to(out.dtype)
        return out

    def _decode(self, frames) -> torch.Tensor:
        decoded = [self._decode_frame(emb, scale) for emb, scale in frames]
        if self.cfg.segment_length is None:
            assert len(decoded) == 1
            return decoded[0]
        return linear_overlap_add(decoded, self.cfg.segment_stride or 1)

    # -- inference modes ------------------------------------------------------

    def inference(
        self,
        speech: torch.Tensor,
        need_recon: bool = True,
        bit_width: Optional[int] = None,
        use_scale: bool = True,
    ) -> Dict[str, Any]:
        """Full encode -> quantize -> decode."""
        codes, code_idxs, all_sub_quants = [], [], []
        for emb, scale in self._encode(speech):
            if self.cfg.bypass_quantizer:
                code_embs, indices, sub_quants = emb, None, None
            else:
                code_embs, indices, sub_quants = self.quantizer.inference(emb, bandwidth=bit_width)
            codes.append((code_embs, scale if use_scale else None))
            code_idxs.append(indices)
            all_sub_quants.append(sub_quants)
        recon = None
        if need_recon:
            recon = self._decode(codes)[..., : speech.shape[-1]]
        return dict(
            recon_speech=recon,
            code_indices=code_idxs,
            code_embeddings=codes,
            sub_quants=all_sub_quants,
        )

    def inference_encoding(
        self,
        speech: torch.Tensor,
        need_recon: bool = False,
        bit_width: Optional[int] = None,
        use_scale: bool = True,
    ) -> Dict[str, Any]:
        """Encode to token ids with the greedy fp32 encode path."""
        codes, code_idxs = [], []
        for emb, scale in self._encode(speech):
            indices = self.quantizer.encode(emb, bandwidth=bit_width)
            code_idxs.append(indices)
            if need_recon:
                codes.append((self.quantizer.decode(indices), scale if use_scale else None))
        recon = None
        if need_recon:
            recon = self._decode(codes)[..., : speech.shape[-1]]
        return dict(recon_speech=recon, code_indices=code_idxs, code_embeddings=codes)

    def inference_decoding(self, token_idx: torch.Tensor, need_recon: bool = True) -> Dict[str, Any]:
        """Token ids (B, T, n_q) -> waveform; no scale at decode."""
        tokens = token_idx.permute(2, 0, 1)  # (n_q, B, T)
        codes = [(self.quantizer.decode(tokens), None)]
        recon = self._decode(codes) if need_recon else None
        return dict(recon_speech=recon, code_indices=None, code_embeddings=codes)

    def inference_decoding_emb(self, emb: torch.Tensor) -> Dict[str, Any]:
        """Dense code embeddings (B, T, D) -> waveform."""
        recon = self._decode([(emb, None)])
        return dict(recon_speech=recon, code_indices=None, code_embeddings=[(emb, None)])

    # -- training forwards ----------------------------------------------------

    def forward(self, method: str, *args, **kwargs):
        """getattr(self, method)(*args, **kwargs), so that
        torch.func.functional_call can run a training method on other
        parameters (the train step's compute-dtype copies)."""
        return getattr(self, method)(*args, **kwargs)

    def _reconstruct(self, speech: torch.Tensor, generator: torch.Generator,
                     rvq_state: Optional[RVQTensors] = None, training: bool = True,
                     group: Optional[DataGroup] = None):
        """encode -> RVQ -> decode. Returns (recon (B, T), aux); aux's
        enc_quant_mses holds each frame's latent MSE, this rank's (the
        enc-quant loss squares the global ones).

        training=False (validation) runs the eval quantizer: no EMA update,
        no dropout, commit 0, the state unchanged."""
        state = self.quantizer.state.tensors() if rvq_state is None else rvq_state
        commit_losses, mses, codes = [], [], []
        all_indices, all_sub_quants, all_embs = [], [], []
        for emb, scale in self._encode(speech):
            if training:
                quant_out, indices, commit, sub_quants, state = self.quantizer.train_forward(
                    emb, generator, state, group=group)
            else:
                quant_out, indices, sub_quants = self.quantizer.inference(emb)
                commit = torch.zeros((), device=emb.device)
            commit_losses.append(commit)
            mses.append((quant_out.float() - emb.float()).square().mean())
            codes.append((quant_out, scale))
            all_indices.append(indices)
            all_sub_quants.append(sub_quants)
            all_embs.append(emb)
        recon = self._decode(codes)[..., : speech.shape[-1]]
        aux = dict(
            commit_loss=torch.stack(commit_losses).sum(),
            enc_quant_mses=torch.stack(mses),
            indices=all_indices,
            sub_quants=all_sub_quants,
            embs=all_embs,
            rvq_state=state,
        )
        return recon, aux

    def _multi_spectral_loss(self, orig: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
        """L1 + L2 of log mels (and, with use_power_spec_loss, log power
        spectra) over the window sizes 2**p, n_fft 1024, hop win / 4; fp32."""
        cfg = self.cfg
        total = torch.zeros((), device=orig.device)
        for p in cfg.multi_spectral_window_powers_of_two:
            win = 2**p
            kw = dict(n_fft=1024, hop_length=win // 4, win_length=win, sampling_rate=cfg.target_sample_hz,
                      n_mel_channels=cfg.multi_spectral_n_mels)
            if not cfg.use_power_spec_loss:
                d = audio_to_mel(orig, **kw) - audio_to_mel(recon, **kw)
                l1, l2 = d.abs().mean(), d.square().mean()
            else:
                om, op = audio_to_mel(orig, return_power_spec=True, **kw)
                rm, rp = audio_to_mel(recon, return_power_spec=True, **kw)
                dm, dp = om - rm, op - rp
                l1 = dm.abs().mean() * 0.5 + dp.abs().mean() * 0.5
                l2 = dm.square().mean() * 0.5 + dp.square().mean() * 0.5
            total = total + l1 + l2
        return total / len(cfg.multi_spectral_window_powers_of_two)

    def forward_generator(self, discriminator: Discriminator, speech: torch.Tensor, generator: torch.Generator,
                          rvq_state: Optional[RVQTensors] = None, training: bool = True,
                          group: Optional[DataGroup] = None):
        """The generator turn: (loss, out) with out = {stats, rvq_state,
        gen_loss (detached, the disc gate's carry), real, fake}.
        Differentiate with respect to the generator's parameters; the
        discriminator's parameters carry no gradient here."""
        orig = speech.float()
        recon, aux = self._reconstruct(speech, generator, rvq_state, training=training, group=group)
        return self._generator_losses(discriminator, orig, recon, aux, generator=generator, group=group)

    def _context_terms(self, aux, generator: Optional[torch.Generator], group: Optional[DataGroup]):
        """(context loss, prediction accuracy): models/context.py's loss of
        each frame's latents on its first quantizer's codes and codewords
        against the detached first codebook of the step's new state, summed
        over the frames (the accuracy averaged); this rank's means."""
        loss = acc = torch.zeros((), device=aux["embs"][0].device)
        codebook0 = aux["rvq_state"].embed[0].detach()
        for emb, idx, subq in zip(aux["embs"], aux["indices"], aux["sub_quants"]):
            c_loss, c_acc = self.context.loss(emb, idx[0], subq[0], codebook0, generator, group=group)
            loss = loss + c_loss
            acc = acc + c_acc / len(aux["embs"])
        return loss, acc

    def _generator_losses(self, discriminator: Discriminator, orig: torch.Tensor, recon: torch.Tensor, aux,
                          generator: Optional[torch.Generator] = None, group: Optional[DataGroup] = None):
        """The generator's losses from a reconstruction: L1, multi-spectral,
        hinge adversarial and feature matching against the real signal's
        fmaps (computed without grad), commit and enc-quant (each frame's
        latent MSE, squared), and with a context module the context loss
        (its spans drawn from `generator`) times context_loss_weight. The
        discriminator sees the reconstruction in its compute type. The terms
        are the global batch's (one global_mean)."""
        cfg = self.cfg
        disc = _without_param_grad(discriminator)
        disc_in_dtype = recon.dtype
        recon = recon.float()
        recon_loss = (orig - recon).abs().mean()
        multi_spectral = (self._multi_spectral_loss(orig, recon) if cfg.multi_spectral_recon_loss_weight > 0
                          else torch.zeros((), device=orig.device))
        fake_outs = disc(recon.to(disc_in_dtype))
        with torch.no_grad():
            real_outs = disc(orig.to(disc_in_dtype))
        adv_losses, feat_losses = [], []
        fm_start = getattr(cfg, "feat_match_layer_start", -1)
        for (_, real_fmap), (fake_logits, fake_fmap) in zip(real_outs, fake_outs):
            adv_losses.append(F.relu(1.0 - fake_logits.float()).mean())
            for li, (rf, ff) in enumerate(zip(real_fmap, fake_fmap)):
                if li >= fm_start:  # FreqCodec's feat_match_layer_start (default -1: every layer)
                    # the difference in the disc's type, its mean in fp32
                    feat_losses.append((rf - ff).abs().float().mean())
        adversarial_loss = torch.stack(adv_losses).mean()
        feat_match_loss = torch.stack(feat_losses).mean()
        zero = torch.zeros((), device=orig.device)
        context_loss, context_acc = (zero, zero) if self.context is None else self._context_terms(
            aux, generator, group)
        terms = global_mean(torch.stack([recon_loss, multi_spectral, adversarial_loss, feat_match_loss,
                                         aux["commit_loss"], context_loss, context_acc,
                                         *aux["enc_quant_mses"]]), group)
        recon_loss, multi_spectral, adversarial_loss, feat_match_loss, commit_loss, context_loss, context_acc = (
            terms[:7])
        enc_quant_loss = terms[7:].square().sum()
        gen_loss = (
            recon_loss * cfg.recon_loss_weight
            + multi_spectral * cfg.multi_spectral_recon_loss_weight
            + adversarial_loss * cfg.adversarial_loss_weight
            + feat_match_loss * cfg.feat_match_loss_weight
        )
        loss = (gen_loss + commit_loss + enc_quant_loss * cfg.enc_quant_loss_weight
                + context_loss * cfg.context_loss_weight)
        stats = {k: v.detach() for k, v in dict(
            context_loss=context_loss,
            context_pred_acc=context_acc,
            generator_loss=loss,
            generator_recon_loss=recon_loss,
            generator_multi_spectral_recon_loss=multi_spectral,
            generator_adv_loss=adversarial_loss,
            generator_feat_match_loss=feat_match_loss,
            generator_commit_loss=commit_loss,
            generator_enc_quant_loss=enc_quant_loss,
        ).items()}
        out = dict(stats=stats, rvq_state=aux["rvq_state"], gen_loss=gen_loss.detach(), real=orig, fake=recon)
        return loss, out

    def forward_discriminator(self, discriminator: Discriminator, speech: torch.Tensor, generator: torch.Generator,
                              gen_loss_carry: torch.Tensor, rvq_state: Optional[RVQTensors] = None,
                              training: bool = True, group: Optional[DataGroup] = None):
        """The discriminator turn: the generator's forward without grad (its
        quantizer in train mode, so the EMA advances), then
        ``_discriminator_losses``. Returns (loss, out) with the new RVQ state."""
        with torch.no_grad():
            recon, aux = self._reconstruct(speech, generator, rvq_state, training=training, group=group)
        loss, out = self._discriminator_losses(discriminator, speech.to(recon.dtype), recon, gen_loss_carry,
                                               training=training, generator=generator, group=group)
        out["rvq_state"] = aux["rvq_state"]
        return loss, out

    def _discriminator_losses(self, discriminator: Discriminator, orig: torch.Tensor, fake: torch.Tensor,
                              gen_loss_carry: torch.Tensor, training: bool = True,
                              generator: Optional[torch.Generator] = None, group: Optional[DataGroup] = None):
        """Hinge loss on real and (detached) fake, in fp32; in training it is
        gated to 0 while the discriminator already wins (disc_loss <=
        gen_loss_carry). The losses and the gate are the global batch's (one
        global_mean).

        With ``phase_invariant_training`` (FreqCodec) the discriminator is
        also penalized for telling a phase-rotated copy of the real signal
        (ops/stft.phase_aug with n_fft 512, hop 160, its rotation drawn from
        `generator`) from the real signal: per
        discriminator the L1 of the logits plus pit_feat_loss_weight times
        the mean L1 of the feature maps from feat_match_layer_start on;
        their mean, gated like the hinge loss, enters the loss times
        pit_disc_loss_weight and the stats as ``pit_disc_loss``."""
        cfg = self.cfg
        pit = getattr(cfg, "phase_invariant_training", False)
        fake = fake.detach()
        real_outs = discriminator(orig)
        fake_outs = discriminator(fake)
        disc_loss = torch.stack([
            F.relu(1.0 - r.float()).mean() + F.relu(1.0 + f.float()).mean()
            for (r, _), (f, _) in zip(real_outs, fake_outs)
        ]).mean()
        terms = [disc_loss]
        if pit:
            with torch.no_grad():
                real_aug = phase_aug(orig, generator, group=group)
            aug_outs = discriminator(real_aug)
            pit_losses = []
            for (r_logits, r_fmap), (a_logits, a_fmap) in zip(real_outs, aug_outs):
                fls = [(r.float() - a.float()).abs().mean()
                       for i, (r, a) in enumerate(zip(r_fmap, a_fmap)) if i >= cfg.feat_match_layer_start]
                pit_losses.append((r_logits - a_logits).abs().mean()
                                  + torch.stack(fls).mean() * cfg.pit_feat_loss_weight)
            terms.append(torch.stack(pit_losses).mean())
        terms = global_mean(torch.stack(terms), group)
        disc_loss = terms[0]
        mask = (disc_loss > gen_loss_carry).to(disc_loss.dtype) if training else None
        loss = disc_loss * mask if training else disc_loss
        stats = dict(discriminator_total_loss=loss, discriminator_loss=disc_loss)
        if pit:
            pit_disc_loss = terms[1]
            if training:
                pit_disc_loss = pit_disc_loss * mask
            loss = loss + pit_disc_loss * cfg.pit_disc_loss_weight
            stats.update(discriminator_total_loss=loss, pit_disc_loss=pit_disc_loss)
        stats = {k: v.detach() for k, v in stats.items()}
        return loss, dict(stats=stats, real=orig, fake=fake)


def _without_param_grad(discriminator: Discriminator):
    """The discriminator as a function of x whose parameters carry no
    gradient (a module's detached parameters; a function as given)."""
    if not isinstance(discriminator, nn.Module):
        return discriminator
    params = {name: p.detach() for name, p in discriminator.named_parameters()}
    return lambda x: torch.func.functional_call(discriminator, params, (x,))
