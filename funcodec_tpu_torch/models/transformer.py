"""Transformer / Conformer encoder stacks with a KV cache (port of
funcodec_tpu/models/transformer.py).

ESPnet semantics, as in the JAX package: pre-norm (or post-norm) layers,
standard or relative-position ("latest" rel_shift) multi-head attention with
an fp32 softmax, a relu or swish FFN, the conformer's macaron FFN and
convolution module (eval-mode BatchNorm), and the input layers ``linear``,
``linear_relu``, ``embed`` and ``none``. Masks are boolean, True = attend.

The modules carry the reference FunCodec names (``embed.0``, ``encoders.N.
self_attn.linear_q``, ``feed_forward.w_1``, ``after_norm``...), so
funcodec_tpu/models/transformer.import_encoder reads their state_dict.
TransformerEncoder_s0 layers name their norms ``norm1``/``norm2``, conformer
layers ``norm_mha``/``norm_ff``: ``TransformerConfig.block_names`` picks one.

The JAX function ``apply_embed`` is ``TransformerEncoder.embed_input``,
``apply_encoder`` is ``forward``, ``precompute_rel_proj`` is
``rel_proj`` and ``apply_encoder_step`` is ``step``. ``step`` writes the new
keys and values in place into a preallocated ``KVCache`` at each row's
``length`` (an index write, not a masked select over the whole cache), and
selects each row's relative-position window by a gather of the projected
distance table.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

NEG_INF = float(np.finfo(np.float32).min)
LN_EPS = 1e-12  # ESPnet LayerNorm


# ---------------------------------------------------------------------------
# positional encodings (numpy tables, as in the JAX package)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def sinusoidal_pe(length: int, d_model: int) -> np.ndarray:
    """ESPnet PositionalEncoding table (length, d_model)."""
    position = np.arange(length, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe = np.zeros((length, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    pe.setflags(write=False)
    return pe


@functools.lru_cache(maxsize=64)
def rel_pe(length: int, d_model: int) -> np.ndarray:
    """RelPositionalEncoding table, distances length-1 .. -(length-1): (2*length-1, d_model)."""
    position = np.arange(length, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe_pos = np.zeros((length, d_model), np.float32)
    pe_neg = np.zeros((length, d_model), np.float32)
    pe_pos[:, 0::2] = np.sin(position * div_term)
    pe_pos[:, 1::2] = np.cos(position * div_term)
    pe_neg[:, 0::2] = np.sin(-position * div_term)
    pe_neg[:, 1::2] = np.cos(-position * div_term)
    out = np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=64)
def _device_table(kind: str, length: int, d_model: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    pe = torch.from_numpy(np.array(sinusoidal_pe(length, d_model) if kind == "abs" else rel_pe(length, d_model)))
    with torch.inference_mode(False):  # a normal tensor, usable outside inference mode too
        if device.type == "cuda":  # through pinned memory: made mid-stream, it does not wait for the card
            return pe.pin_memory().to(device=device, non_blocking=True).to(dtype)
        return pe.to(device=device, dtype=dtype)


def table(kind: str, length: int, like: torch.Tensor) -> torch.Tensor:
    """The "abs" (sinusoidal_pe) or "rel" (rel_pe) table of width like's last
    axis, on like's device in its dtype (a fp32 table must not promote a bf16
    stream); kept on the device once made."""
    return _device_table(kind, length, like.shape[-1], like.device, like.dtype)


def apply_abs_pos(x: torch.Tensor) -> torch.Tensor:
    """x * sqrt(d) + pe (embedding.py PositionalEncoding)."""
    return x * math.sqrt(x.shape[-1]) + table("abs", x.shape[1], x)


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Latest rel_shift: (B, H, T1, 2T1-1) -> (B, H, T1, T1)."""
    b, h, t1, n = x.shape
    x_padded = torch.cat([x.new_zeros(b, h, t1, 1), x], dim=-1).reshape(b, h, n + 1, t1)
    return x_padded[:, :, 1:].reshape(b, h, t1, n)[:, :, :, : n // 2 + 1]


def softmax32(scores: torch.Tensor) -> torch.Tensor:
    """The attention softmax as an fp32 island."""
    return torch.softmax(scores.float(), dim=-1).to(scores.dtype)


def masked_softmax32(scores: torch.Tensor, visible: torch.Tensor) -> torch.Tensor:
    """softmax32 over the visible keys: hidden scores set to the type's
    lowest value (NEG_INF in fp32), hidden weights to 0."""
    lowest = NEG_INF if scores.dtype == torch.float32 else torch.finfo(scores.dtype).min
    return softmax32(scores.masked_fill(~visible, lowest)).masked_fill(~visible, 0.0)


def make_pad_mask_bool(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """(B, maxlen) True where valid."""
    return torch.arange(maxlen, device=lengths.device)[None, :] < lengths[:, None]


def causal_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """(B, T, T) causal & padding mask."""
    valid = make_pad_mask_bool(lengths, maxlen)
    tri = torch.ones(maxlen, maxlen, dtype=torch.bool, device=lengths.device).tril()
    return valid[:, None, :] & tri[None]


# ---------------------------------------------------------------------------
# configuration and modules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's TransformerConfig, plus the reference's norm names."""

    input_size: int
    attention_dim: int = 256
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    dropout_rate: float = 0.1
    positional_dropout_rate: float = 0.1
    attention_dropout_rate: float = 0.0
    input_layer: str = "linear"  # linear | linear_relu | embed | none
    pos_enc_type: str = "abs_pos"  # abs_pos | rel_pos | none
    normalize_before: bool = True
    activation: str = "relu"  # relu | swish (FFN)
    macaron_style: bool = False
    use_cnn_module: bool = False
    cnn_module_kernel: int = 31
    vocab_size: int = 0  # for input_layer == "embed"
    block_names: str = "conformer"  # conformer: norm_mha/norm_ff; transformer: norm1/norm2

    @property
    def rel(self) -> bool:
        return self.pos_enc_type == "rel_pos"


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def _is_meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def linear(d_in: int, d_out: int, *, device, generator: torch.Generator, bias: bool = True) -> nn.Linear:
    """nn.Linear with torch's default bounds, drawn from `generator`."""
    m = nn.Linear(d_in, d_out, bias=bias, device=device)
    if not _is_meta(device):
        _uniform_(m.weight, 1.0 / math.sqrt(d_in), generator)
        if bias:
            _uniform_(m.bias, 1.0 / math.sqrt(d_in), generator)
    return m


class MultiHeadedAttention(nn.Module):
    """Standard or rel-pos attention (linear_q/k/v/out, linear_pos, pos_bias_u/v)."""

    def __init__(self, dim: int, heads: int, rel: bool, *, device, generator):
        super().__init__()
        self.heads, self.d_k, self.rel = heads, dim // heads, rel
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            setattr(self, name, linear(dim, dim, device=device, generator=generator))
        if rel:
            self.linear_pos = linear(dim, dim, device=device, generator=generator, bias=False)
            a = math.sqrt(6.0 / (self.d_k + heads))
            self.pos_bias_u = nn.Parameter(torch.empty(heads, self.d_k, device=device))
            self.pos_bias_v = nn.Parameter(torch.empty(heads, self.d_k, device=device))
            if not _is_meta(device):
                _uniform_(self.pos_bias_u, a, generator)
                _uniform_(self.pos_bias_v, a, generator)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        return x.reshape(b, t, self.heads, self.d_k)

    def forward(self, query, key, value, mask: Optional[torch.Tensor], pos_emb: Optional[torch.Tensor] = None):
        """mask: bool (B, Tq, Tk) or (B, 1, Tk), True = attend."""
        d = query.shape[-1]
        q = self._split(self.linear_q(query))  # (B, Tq, H, dk)
        k = self._split(self.linear_k(key))
        v = self._split(self.linear_v(value))
        if pos_emb is not None:
            pe = self._split(self.linear_pos(pos_emb))  # (1, 2T-1, H, dk)
            q_u = (q + self.pos_bias_u).transpose(1, 2)  # (B, H, Tq, dk)
            q_v = (q + self.pos_bias_v).transpose(1, 2)
            matrix_ac = q_u @ k.permute(0, 2, 3, 1)
            matrix_bd = _rel_shift(q_v @ pe.permute(0, 2, 3, 1))
            scores = (matrix_ac + matrix_bd[..., : k.shape[1]]) / math.sqrt(self.d_k)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.d_k)
        if mask is not None:
            attn = masked_softmax32(scores, mask[:, None])
        else:
            attn = softmax32(scores)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(q.shape[0], q.shape[1], d)
        return self.linear_out(ctx)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, activation: str, *, device, generator):
        super().__init__()
        self.w_1 = linear(dim, hidden, device=device, generator=generator)
        self.w_2 = linear(hidden, dim, device=device, generator=generator)
        self.act = F.relu if activation == "relu" else F.silu

    def forward(self, x):
        return self.w_2(self.act(self.w_1(x)))


class LayerNorm(nn.LayerNorm):
    """ESPnet LayerNorm (eps 1e-12), computed in fp32."""

    def __init__(self, dim: int, *, device):
        super().__init__(dim, eps=LN_EPS, device=device)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class ConvModule(nn.Module):
    """Conformer convolution module; BatchNorm from its running statistics."""

    def __init__(self, size: int, kernel: int, activation: str, *, device, generator):
        super().__init__()
        self.pointwise_conv1 = nn.Conv1d(size, 2 * size, 1, device=device)
        self.depthwise_conv = nn.Conv1d(size, size, kernel, padding=(kernel - 1) // 2, groups=size, device=device)
        self.norm = nn.BatchNorm1d(size, device=device)
        self.pointwise_conv2 = nn.Conv1d(size, size, 1, device=device)
        self.act = F.silu if activation == "swish" else F.relu
        if not _is_meta(device):
            _uniform_(self.pointwise_conv1.weight, 1.0 / math.sqrt(size), generator)
            _uniform_(self.depthwise_conv.weight, 1.0 / math.sqrt(kernel), generator)
            _uniform_(self.pointwise_conv2.weight, 1.0 / math.sqrt(size), generator)
            for conv in (self.pointwise_conv1, self.depthwise_conv, self.pointwise_conv2):
                nn.init.zeros_(conv.bias)

    def forward(self, x):  # (B, T, C)
        y = F.glu(self.pointwise_conv1(x.transpose(1, 2)), dim=1)
        y = self.depthwise_conv(y)
        n = self.norm
        y = ((y - n.running_mean[:, None]) * torch.rsqrt(n.running_var[:, None] + 1e-5) * n.weight[:, None]
             + n.bias[:, None])
        return self.pointwise_conv2(self.act(y)).transpose(1, 2)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device, generator):
        super().__init__()
        d = cfg.attention_dim
        self.cfg = cfg
        self.self_attn = MultiHeadedAttention(d, cfg.attention_heads, cfg.rel, device=device, generator=generator)
        self.feed_forward = FeedForward(d, cfg.linear_units, cfg.activation, device=device, generator=generator)
        if cfg.macaron_style:
            self.feed_forward_macaron = FeedForward(d, cfg.linear_units, cfg.activation, device=device,
                                                    generator=generator)
            self.norm_ff_macaron = LayerNorm(d, device=device)
        if cfg.use_cnn_module:
            self.conv_module = ConvModule(d, cfg.cnn_module_kernel, cfg.activation, device=device,
                                          generator=generator)
            self.norm_conv = LayerNorm(d, device=device)
            self.norm_final = LayerNorm(d, device=device)
        mha, ff = ("norm1", "norm2") if cfg.block_names == "transformer" else ("norm_mha", "norm_ff")
        setattr(self, mha, LayerNorm(d, device=device))
        setattr(self, ff, LayerNorm(d, device=device))
        self._norm_names = (mha, ff)

    @property
    def norm_mha(self) -> LayerNorm:
        return self._modules[self._norm_names[0]]

    @property
    def norm_ff(self) -> LayerNorm:
        return self._modules[self._norm_names[1]]

    def _sub(self, x, norm, fn, scale=1.0):
        pre = self.cfg.normalize_before
        y = x + scale * fn(norm(x) if pre else x)
        return y if pre else norm(y)

    def forward(self, x, mask, pos_emb):
        cfg = self.cfg
        ff_scale = 0.5 if cfg.macaron_style else 1.0
        if cfg.macaron_style:
            x = self._sub(x, self.norm_ff_macaron, self.feed_forward_macaron, ff_scale)
        x = self._sub(x, self.norm_mha, lambda h: self.self_attn(h, h, h, mask, pos_emb))
        if cfg.use_cnn_module:
            x = self._sub(x, self.norm_conv, self.conv_module)
        x = self._sub(x, self.norm_ff, self.feed_forward, ff_scale)
        if cfg.use_cnn_module:
            x = self.norm_final(x)
        return x


@dataclasses.dataclass
class KVCache:
    """Per-layer key/value caches (B, max_len, H, dk), preallocated.

    `length` is the fill: a Python int (every row at the same position) or
    a (B,) int64 tensor on the cache's device (a position per row)."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    length: Union[int, torch.Tensor]


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=torch.float32, device=None) -> KVCache:
    h, dk = cfg.attention_heads, cfg.attention_dim // cfg.attention_heads

    def zeros():
        return torch.zeros(batch, max_len, h, dk, dtype=dtype, device=device)

    return KVCache(k=[zeros() for _ in range(cfg.num_blocks)], v=[zeros() for _ in range(cfg.num_blocks)],
                   length=0)


class TransformerEncoder(nn.Module):
    """TransformerEncoder_s0 / ConformerEncoder under the reference names."""

    def __init__(self, cfg: TransformerConfig, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.attention_dim
        if cfg.input_layer in ("linear", "linear_relu"):
            self.embed = nn.Sequential(linear(cfg.input_size, d, device=device, generator=generator),
                                       LayerNorm(d, device=device))
        elif cfg.input_layer == "embed":
            self.embed = nn.Sequential(nn.Embedding(cfg.vocab_size, d, device=device))
            if not _is_meta(device):
                with torch.no_grad():
                    self.embed[0].weight.normal_(generator=generator)
        self.encoders = nn.ModuleList(
            [EncoderLayer(cfg, device=device, generator=generator) for _ in range(cfg.num_blocks)])
        if cfg.normalize_before:
            self.after_norm = LayerNorm(d, device=device)

    # -- forwards ------------------------------------------------------------

    def embed_input(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Input layer + positional encoding (JAX apply_embed): (x, pos_emb or None)."""
        cfg = self.cfg
        if cfg.input_layer in ("linear", "linear_relu"):
            x = self.embed(x)
            if cfg.input_layer == "linear_relu":
                x = F.relu(x)
        elif cfg.input_layer == "embed":
            x = self.embed(x)
        if cfg.pos_enc_type == "abs_pos":
            return apply_abs_pos(x), None
        if cfg.pos_enc_type == "rel_pos":
            return x * math.sqrt(x.shape[-1]), table("rel", x.shape[1], x)[None]
        return x, None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full encoder forward (JAX apply_encoder). x: (B, T, input_size) or ids."""
        x, pos_emb = self.embed_input(x)
        for layer in self.encoders:
            x = layer(x, mask, pos_emb)
        if self.cfg.normalize_before:
            x = self.after_norm(x)
        return x

    # -- KV-cache decode -----------------------------------------------------

    @torch.no_grad()
    def rel_proj(self, max_len: int) -> Optional[List[torch.Tensor]]:
        """Per-layer pos-projected relative-PE tables (2*max_len-1, H, dk)
        (JAX precompute_rel_proj), projected once per decode."""
        if not self.cfg.rel:
            return None
        h, dk = self.cfg.attention_heads, self.cfg.attention_dim // self.cfg.attention_heads
        out = []
        for layer in self.encoders:
            w = layer.self_attn.linear_pos.weight
            pe = _device_table("rel", max_len, self.cfg.attention_dim, w.device, torch.float32)
            out.append(F.linear(pe, w.float()).to(w.dtype).reshape(-1, h, dk))
        return out

    def step(
        self,
        cache: KVCache,
        x_new: torch.Tensor,  # (B, n_new, D) already embedded and scaled
        attend_mask: Optional[torch.Tensor] = None,  # (B, n_new, max_len)
        rel_proj: Optional[List[torch.Tensor]] = None,
        write_mask: Optional[torch.Tensor] = None,  # (B,) rows that write and advance
    ) -> Tuple[torch.Tensor, KVCache]:
        """Incremental forward over n_new positions against the cached prefix
        (JAX apply_encoder_step). The new keys and values are written into
        `cache` in place; the returned cache holds the advanced lengths.

        A scalar `cache.length` puts every row at the same positions
        (batched decode); a (B,) tensor gives each row its own (the serving
        session), where `write_mask` gates which rows write and advance:
        masked-off rows leave their cache rows and length untouched."""
        cfg = self.cfg
        if cfg.macaron_style or cfg.use_cnn_module:
            raise NotImplementedError("KV-cache decode covers plain transformer layers (no macaron, no conv module)")
        b, n_new, _ = x_new.shape
        dev = x_new.device
        max_len = cache.k[0].shape[1]
        h, d = cfg.attention_heads, cfg.attention_dim
        d_k = d // h
        start = cache.length
        per_row = isinstance(start, torch.Tensor) and start.dim() == 1
        key_pos = torch.arange(max_len, device=dev)
        steps = torch.arange(n_new, device=dev)
        if per_row:
            pos_new = start[:, None] + steps  # (B, n)
            visible = key_pos[None, None, :] <= pos_new[:, :, None]  # (B, n, M)
            write_pos = pos_new.clamp(max=max_len - 1)
            rows = torch.arange(b, device=dev)[:, None]
            keep = None if write_mask is None else write_mask[:, None, None, None]
        else:
            pos_new = start + steps  # (n,)
            visible = (key_pos[None, :] <= pos_new[:, None])[None]  # (1, n, M)
        if attend_mask is not None:
            visible = visible & attend_mask
        visible = visible.expand(b, n_new, max_len)[:, None]  # (B, 1, n, M)
        if cfg.rel:
            # distance q - k, as a row of the (2M-1) table: the same numbers as
            # the full forward's rel_shift
            rel_idx = ((max_len - 1) - (pos_new[..., None] - key_pos)).clamp(0, 2 * max_len - 2)
            rel_idx = (rel_idx if per_row else rel_idx[None])[:, None].expand(b, h, n_new, max_len)
            if rel_proj is None:
                rel_proj = self.rel_proj(max_len)

        x = x_new
        for li, layer in enumerate(self.encoders):
            ap = layer.self_attn
            residual = x
            hdd = layer.norm_mha(x) if cfg.normalize_before else x
            q = ap._split(ap.linear_q(hdd))  # (B, n, H, dk)
            k_new = ap._split(ap.linear_k(hdd)).to(cache.k[li].dtype)
            v_new = ap._split(ap.linear_v(hdd)).to(cache.v[li].dtype)
            k_cache, v_cache = cache.k[li], cache.v[li]
            if per_row:
                if keep is not None:  # masked-off rows write their old values back
                    k_new = torch.where(keep, k_new, k_cache[rows, write_pos])
                    v_new = torch.where(keep, v_new, v_cache[rows, write_pos])
                k_cache[rows, write_pos] = k_new
                v_cache[rows, write_pos] = v_new
            else:
                k_cache[:, start:start + n_new] = k_new
                v_cache[:, start:start + n_new] = v_new
            if cfg.rel:
                q_u = q + ap.pos_bias_u
                q_v = q + ap.pos_bias_v
                scores_ac = torch.einsum("bnhd,bmhd->bhnm", q_u, k_cache)
                full = torch.einsum("bnhd,thd->bhnt", q_v, rel_proj[li].to(q_v.dtype))  # (B, H, n, 2M-1)
                scores = (scores_ac + full.gather(-1, rel_idx)) / math.sqrt(d_k)
            else:
                scores = torch.einsum("bnhd,bmhd->bhnm", q, k_cache) / math.sqrt(d_k)
            attn = masked_softmax32(scores, visible)
            ctx = torch.einsum("bhnm,bmhd->bnhd", attn, v_cache.to(attn.dtype)).reshape(b, n_new, d)
            x = residual + ap.linear_out(ctx)
            if not cfg.normalize_before:
                x = layer.norm_mha(x)
            residual = x
            hdd = layer.norm_ff(x) if cfg.normalize_before else x
            x = residual + layer.feed_forward(hdd)
            if not cfg.normalize_before:
                x = layer.norm_ff(x)
        if cfg.normalize_before:
            x = self.after_norm(x)
        if per_row:
            new_len = start + n_new if write_mask is None else torch.where(write_mask, start + n_new, start)
        else:
            new_len = start + n_new
        return x, KVCache(k=cache.k, v=cache.v, length=new_len)
