"""Encodec's context loss: masked prediction or a context LM over the first
quantizer's codes (port of funcodec_tpu/models/context.py).

Behavioral reference: funcodec/models/codec_basic.py (build_context_model
:244-275, build_context_mask :277-285, _context_lm_loss :410-424,
_cal_context_loss :426-469). Two variants:

- masked prediction (ce_loss_weight): time spans of the encoder output are
  zeroed (ops/augment.mask_along_axis_variable_max_width), a context model
  (a transformer with abs_pos and a linear_relu input layer under a pad
  mask, or a stacked LSTM without skip) runs over it, and each frame is
  classified against the first codebook by negative squared distances;
  with mask_pred_weight the masked and unmasked frames' losses are weighted;
- context LM (lm_loss_weight): the input shifted right by one frame through
  the causal transformer, predicting each frame's code.

The spans are drawn from a ``torch.Generator`` (at the global batch's shape
under data parallelism) or given (``ContextModule.mask``'s ``spans``), so a
caller can replay another package's draw.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from funcodec_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerEncoder,
    causal_mask,
    make_pad_mask_bool,
)
from funcodec_tpu_torch.ops.augment import Spans, mask_along_axis_variable_max_width
from funcodec_tpu_torch.ops.rnn import apply_slstm
from funcodec_tpu_torch.parallel.dist import DataGroup, global_sum


@dataclasses.dataclass(frozen=True)
class ContextConfig:
    """The context_loss_conf subset the JAX package reads (codec_basic.py:224-238)."""

    model: str = "transformer"  # transformer | lstm
    odim: int = 128
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    lstm_layers: int = 4
    use_quant_for_context: bool = False
    mask_pred_weight: Optional[float] = None
    ce_loss_weight: float = 0.0
    lm_loss_weight: float = 0.0
    contrast_loss_weight: float = 0.0
    mask_ratio_range: Tuple[float, float] = (0.0, 0.05)
    num_mask: int = 2

    def transformer_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            input_size=self.odim,
            attention_dim=self.odim,
            attention_heads=self.attention_heads,
            linear_units=self.linear_units,
            num_blocks=self.num_blocks,
            input_layer="linear_relu",
            pos_enc_type="abs_pos",
            block_names="transformer",
        )


class ContextModule(nn.Module):
    """The context model at ``.encoder`` (a TransformerEncoder) or ``.lstm``
    (an nn.LSTM, torch's default init from `generator`), and its losses."""

    def __init__(self, cfg: ContextConfig, *, device=None, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        if cfg.model == "transformer":
            self.encoder = TransformerEncoder(cfg.transformer_cfg(), device=device, generator=generator)
        else:
            self.lstm = nn.LSTM(cfg.odim, cfg.odim, cfg.lstm_layers, device=device)
            bound = 1.0 / math.sqrt(cfg.odim)
            with torch.no_grad():
                for p in self.lstm.parameters():
                    p.uniform_(-bound, bound, generator=generator)

    def _run(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        """(B, T, D) -> (B, T, D)."""
        if self.cfg.model != "transformer":
            return apply_slstm(self.lstm, x.transpose(1, 2), skip=False).transpose(1, 2)
        B, T, _ = x.shape
        lengths = torch.full((B,), T, device=x.device)
        mask = causal_mask(lengths, T) if causal else make_pad_mask_bool(lengths, T)[:, None, :]
        return self.encoder(x, mask)

    @staticmethod
    def _dist_logits(outs: torch.Tensor, code_emb: torch.Tensor) -> torch.Tensor:
        """-(||o||^2 - 2 o.e + ||e||^2) in fp32 over the codebook (bins, D),
        less its detached max (codec_basic.py:415-421)."""
        o32, e32 = outs.float(), code_emb.float()
        dist = -((o32 * o32).sum(dim=-1, keepdim=True) - 2.0 * o32 @ e32.T + (e32 * e32).sum(dim=-1))
        return dist - dist.amax(dim=-1, keepdim=True).detach()

    def mask(self, x: torch.Tensor, generator: Optional[torch.Generator], spans: Optional[Spans] = None,
             group: Optional[DataGroup] = None):
        """(masked x, mask (B, T, 1)): the masked-prediction spans, drawn from
        `generator` or the given (widths, starts) at the global batch's shape."""
        widths, starts = spans if spans is not None else (None, None)
        return mask_along_axis_variable_max_width(x, generator, self.cfg.mask_ratio_range, self.cfg.num_mask,
                                                  axis=1, return_mask=True, widths=widths, starts=starts,
                                                  group=group)

    def loss(self, enc_out: torch.Tensor, indices0: torch.Tensor, quant0: torch.Tensor, codebook0: torch.Tensor,
             generator: Optional[torch.Generator], spans: Optional[Spans] = None, group: Optional[DataGroup] = None):
        """(loss, pred_acc) of _cal_context_loss (codec_basic.py:426-469) on
        the encoder output (B, T, D), the first quantizer's codes (B, T), its
        codewords (B, T, D) and codebook (bins, D, to be detached by the
        caller); the masked-prediction spans drawn from `generator` or given.

        Under data parallelism (`group`, this rank's equal block of rows) the
        means are this rank's, which the caller's global_mean makes the global
        batch's; the mask_pred_weight variant's ratios of masked sums are
        summed over the ranks here (global already, which a global_mean keeps)."""
        cfg = self.cfg
        if cfg.use_quant_for_context:
            enc_out = enc_out + (quant0 - enc_out).detach()
        if cfg.lm_loss_weight > 0:
            # causal next-frame prediction (codec_basic.py:410-424)
            outs = self._run(F.pad(enc_out, (0, 0, 1, 0))[:, :-1], causal=True)
            weight, loss_mask = cfg.lm_loss_weight, None
        else:
            masked, loss_mask = self.mask(enc_out, generator, spans=spans, group=group)
            outs = self._run(masked, causal=False)
            weight = cfg.ce_loss_weight
        dist = self._dist_logits(outs, codebook0)
        labels = indices0.long()
        pred_acc = (dist.argmax(dim=-1) == labels).float().mean()
        ce = -torch.log_softmax(dist, dim=-1).gather(-1, labels[..., None])[..., 0]  # (B, T)
        if loss_mask is None or cfg.mask_pred_weight is None:
            return ce.mean() * weight, pred_acc
        m = loss_mask[..., 0].float()
        sums = global_sum(torch.stack([(ce * m).sum(), (ce * (1 - m)).sum()]), group)
        counts = global_sum(torch.stack([m.sum(), (1 - m).sum()]), group).clamp_min(1e-12)
        masked_loss, unmasked_loss = sums / counts
        loss = masked_loss * cfg.mask_pred_weight + unmasked_loss * (1 - cfg.mask_pred_weight)
        return loss * weight, pred_acc
