"""FreqCodec: the EnCodec skeleton with STFT-domain encode/decode (port of
funcodec_tpu/models/freqcodec.py).

Only the frame transforms differ from Encodec. The encoder side turns the
waveform into features of the `codec_domain[0]` domain, the decoder side
turns the decoder's output of the `codec_domain[1]` domain back into a
waveform. The domains: time, stft, mag, mag_phase, mag_angle,
mag_oracle_phase and mel (encode only). Spectral features are built in the
2D SEANet's (B, C, F, T) layout. The STFT and the decode math (softplus,
the complex spectrum, istft) run in fp32 whatever the compute type; the
encoder sees the features in the input's type.

Phase-invariant training (``phase_invariant_training``) is in
models/encodec.py's discriminator losses, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from funcodec_tpu_torch.models.encodec import Encodec, EncodecConfig
from funcodec_tpu_torch.ops.stft import istft, mel_filterbank, stft


@dataclasses.dataclass(frozen=True)
class FreqCodecConfig(EncodecConfig):
    codec_domain: Tuple[str, str] = ("mag_phase", "mag_phase")
    domain_n_fft: int = 512
    domain_hop_length: int = 160
    phase_invariant_training: bool = False
    pit_feat_loss_weight: float = 1.0
    pit_disc_loss_weight: float = 1000.0
    feat_match_layer_start: int = -1


class FreqCodec(Encodec):
    """Encodec with frequency-domain frame transforms."""

    cfg: FreqCodecConfig

    def _enc_spec(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) -> complex (B, F, T'): center=True, reflect pad, hann, fp32."""
        return stft(x.float(), self.cfg.domain_n_fft, self.cfg.domain_hop_length, center=True)

    def _dec_spec(self, spec: torch.Tensor, length: Optional[int] = None) -> torch.Tensor:
        return istft(spec, self.cfg.domain_n_fft, self.cfg.domain_hop_length, center=True, length=length)

    def _encode_frame(self, x: torch.Tensor):
        cfg = self.cfg
        if cfg.audio_normalize:
            volume = x.float().square().mean(dim=-1, keepdim=True).sqrt()
            scale = 1e-8 + volume
            x = x / scale.to(x.dtype)
        else:
            scale = None

        domain = cfg.codec_domain[0]
        if domain == "time":
            return self.encoder(x), scale

        spec = self._enc_spec(x)  # (B, F, T') complex64
        if domain == "stft":
            feats = torch.stack([spec.real, spec.imag], dim=1)
        elif domain == "mag":
            feats = spec.abs()[:, None]
        elif domain == "mag_angle":
            mag = spec.abs()
            feats = torch.stack([mag.clamp_min(1e-6).log(), spec.angle()], dim=1)
        elif domain == "mag_phase":
            mag = spec.abs()
            phase = spec / mag.clamp_min(1e-6)
            feats = torch.stack([mag.clamp_min(1e-6).log(), phase.real, phase.imag], dim=1)
        elif domain == "mag_oracle_phase":
            feats = spec.abs()[:, None]
            scale = (scale, spec.angle())
        elif domain == "mel":
            power = spec.real.square() + spec.imag.square()
            basis = torch.from_numpy(mel_filterbank(cfg.target_sample_hz, cfg.domain_n_fft, 80)).to(power.device)
            feats = torch.einsum("mf,bft->bmt", basis, power)[:, None]
        else:
            raise ValueError(domain)
        return self.encoder(feats.to(x.dtype)), scale

    def _decode_frame(self, emb: torch.Tensor, scale) -> torch.Tensor:
        cfg = self.cfg
        out = self.decoder(emb)
        domain = cfg.codec_domain[1]
        if domain == "time":
            wav = out[..., 0]
            if cfg.codec_domain[0] != "time":
                # a time decoder over spectral tokens: trim the transform's padding
                hop = cfg.domain_hop_length
                wav = wav[:, hop // 2 : -(hop // 2)]
        elif domain == "stft":
            wav = self._dec_spec(torch.complex(out[:, 0].float(), out[:, 1].float()))
        elif domain == "mag_phase":
            mag = F.softplus(out[:, 0].float())
            wav = self._dec_spec(mag * torch.complex(out[:, 1].float(), out[:, 2].float()))
        elif domain == "mag_angle":
            mag = F.softplus(out[:, 0].float())
            angle = torch.sin(out[:, 1].float()) * math.pi
            wav = self._dec_spec(torch.complex(torch.cos(angle) * mag, torch.sin(angle) * mag))
        elif domain == "mag_oracle_phase":
            scale, angle = scale
            mag = out[:, 0].float()
            wav = self._dec_spec(torch.complex(torch.cos(angle) * mag, torch.sin(angle) * mag))
        else:
            raise ValueError(domain)
        if scale is not None:
            wav = wav * scale.to(wav.dtype)
        return wav
