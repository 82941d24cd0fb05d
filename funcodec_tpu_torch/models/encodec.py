"""EnCodec-style codec, inference (port of funcodec_tpu/models/encodec.py).

normalize -> SEANet encode -> RVQ -> SEANet decode -> overlap-add -> trim.
Waveforms are (B, T) mono, latents (B, T', D), indices (n_q, B, T'), as in
the JAX package. The GAN training forwards are ROADMAP.md slice B.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from funcodec_tpu_torch.models.quantizer import Quantizer
from funcodec_tpu_torch.models.seanet import SEANetDecoder, SEANetEncoder


@dataclasses.dataclass(frozen=True)
class EncodecConfig:
    """The inference fields of funcodec_tpu's EncodecConfig; the loss
    weights are ignored in a config until slice B."""

    input_size: int = 1
    odim: int = 128
    target_sample_hz: int = 16_000
    audio_normalize: bool = True
    segment_dur: Optional[float] = None
    overlap_ratio: Optional[float] = 0.01
    bypass_quantizer: bool = False
    context_loss_weight: float = 0.0

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
    """EnCodec assembly; submodules ``encoder``, ``quantizer``, ``decoder``."""

    def __init__(
        self,
        cfg: EncodecConfig,
        encoder: SEANetEncoder,
        quantizer: Quantizer,
        decoder: SEANetDecoder,
    ):
        super().__init__()
        if cfg.context_loss_weight > 0:
            raise NotImplementedError("the context loss is not ported yet (ROADMAP.md slice C)")
        self.cfg = cfg
        self.encoder = encoder
        self.quantizer = quantizer
        self.decoder = decoder

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
