"""Plain PyTorch LauraTTS of a FunCodec text2audio config: the text-encoder
conformer, the rel-pos codec LM's full forward (no cache), the NAR codec
encoder, the top-k sampler's draws, and the synthesis of a request's AR
tokens through the SEANet decoder of ``reference/codec.py``.

LauraTTS is FunCodec's ``laura_gen_model`` (arXiv:2309.07405;
``egs/LibriTTS/text2speech_laura``): a decoder-only codec LM over [sos, text,
task, codec embeddings] predicts the first ``predict_nq`` token groups, a
flattened (codebook_size + 1) x predict_nq softmax whose last entry of each
group is eos; a non-autoregressive codec encoder predicts the dense codec
embedding of every frame from the encoded text and those groups' codewords;
the codec decodes that embedding. It reads a state dict under FunCodec's
names (``text_encoder.encoders.{i}.self_attn.linear_pos.weight``,
``codec_lm.encoder.encoders.{i}.norm1.weight``, ``codec_lm.decoder.weight``,
``quantizer_codebook.embed`` ...) and computes in float32 with TF32 off. It
imports nothing of the program under test.

The layers are ESPnet's, as FunCodec builds them:

- the conformers (``text_encoder``, ``codec_encoder``): input ``linear``
  (Linear, LayerNorm), x sqrt(d) and the relative positional table
  (``RelPositionalEncoding``, distances T - 1 ... -(T - 1)), blocks of
  pre-norm ``RelPositionMultiHeadedAttention`` (``rel_pos_type: latest``:
  scores ((q + u) k + (q + v) p) / sqrt(d_k), p the projected table at the
  query's distance to the key) and a swish FFN, norms ``norm_mha`` /
  ``norm_ff``, no macaron FFN and no conv module (the recipe's
  ``use_cnn_module: false``), a final ``after_norm``;
- the codec LM (``TransformerEmbedLM``, ``pe_type: uni``): input Linear
  (embed_unit -> att_unit), LayerNorm, ReLU, x sqrt(d), the same relative
  table; pre-norm layers of the same attention and a ReLU FFN, norms
  ``norm1`` / ``norm2``; ``after_norm``; the ``decoder`` Linear to the
  flattened groups. Its inputs are the sum of the frozen codebooks' vectors
  of a frame's ``predict_nq`` groups;
- the NAR stage (``pos_emb_type`` split): the encoded text and the groups'
  codeword sums each x sqrt(d) plus absolute sinusoids from position 0,
  concatenated, through the codec encoder and ``codec_encoder_out_layer``.

Departures from the published description, each what the program serves:

- the LM's prefix is causal at inference (every position attends to the
  ones before it), as the KV-cache decode prefills it; training's
  bidirectional [sos, text] prefix is not used;
- no dropout, LayerNorm eps 1e-12 (ESPnet's), attention softmax in fp32;
- the sampler is a Gumbel-max over the top-k candidates whose uniforms come
  from a counter-based splitmix64 hash of (seed, step, group, index)
  (``draw_uniforms``, copied), not torch's generator, so one request's
  draws do not depend on its batch or slot.

``Precision`` (``reference/codec.py``) runs the same code as the control:
every Linear's weight and input, the embeddings and the codebooks go
through ``Precision.cast``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import codec as ref

LN_EPS = 1e-12
# the LayerNorms' gain 1 + U(-NORM_GAIN, NORM_GAIN) and shift U(-NORM_SHIFT, NORM_SHIFT)
NORM_GAIN, NORM_SHIFT = 0.1, 0.1


@dataclasses.dataclass(frozen=True)
class Stack:
    """One encoder stack: `kind` "conformer" (swish FFN, norm_mha / norm_ff)
    or "lm" (input ReLU, ReLU FFN, norm1 / norm2)."""

    kind: str
    input_size: int
    dim: int
    heads: int
    ffn: int
    blocks: int

    @property
    def norms(self) -> Tuple[str, str]:
        return ("norm_mha", "norm_ff") if self.kind == "conformer" else ("norm1", "norm2")


@dataclasses.dataclass(frozen=True)
class Laura:
    vocab: int
    input_size: int
    text_encoder: Stack
    codec_encoder: Stack
    lm: Stack
    n_q: int
    bins: int
    dim: int
    predict_nq: int

    @property
    def eos(self) -> int:
        return self.bins  # the last entry of each group's (bins + 1) logits

    @property
    def out_voc(self) -> int:
        return (self.bins + 1) * self.predict_nq

    @staticmethod
    def from_config(config: dict, vocab: int) -> "Laura":
        """The recipe yaml's dict (conformer text and codec encoders with
        rel_pos attention and no conv module, a rel_pos ``uni`` codec LM) and
        the size of its token list."""
        mc = config["model_conf"]
        lm = mc["codec_lm_conf"]
        if lm.get("pe_type") != "uni" or lm.get("pos_enc") != "rel_pos" or mc.get("pos_emb_type", "split") != "split":
            raise ValueError("the reference covers the rel_pos uni-PE codec LM with a split-PE codec encoder")

        def conformer(conf: dict, input_size: int) -> Stack:
            if (conf.get("use_cnn_module", True) or conf.get("macaron_style", False)
                    or conf.get("pos_enc_layer_type") != "rel_pos" or conf.get("input_layer", "linear") != "linear"
                    or not conf.get("normalize_before", True)):
                raise ValueError("the reference covers pre-norm rel_pos conformers without conv module or macaron")
            return Stack("conformer", input_size, conf["output_size"], conf["attention_heads"], conf["linear_units"],
                         conf["num_blocks"])

        cc = mc["codec_conf"]
        return Laura(
            vocab=vocab, input_size=config["input_size"],
            text_encoder=conformer(config["text_encoder_conf"], config["input_size"]),
            codec_encoder=conformer(config["codec_encoder_conf"], cc["codebook_dim"]),
            lm=Stack("lm", lm["embed_unit"], lm["att_unit"], lm["head"], lm["unit"], lm["layer"]),
            n_q=cc["num_quantizers"], bins=cc["codebook_size"], dim=cc["codebook_dim"], predict_nq=mc["predict_nq"])

    def param_specs(self, codebook: str) -> List[Tuple[str, Tuple[int, ...], str, float]]:
        """(name, shape, law, bound) of every tensor of the model's state dict
        (``harness/weights.py``'s laws): Linears torch's default bounds, the
        rel-pos biases Xavier's, the embeddings unit variance, LayerNorms a
        gain of 1 +- NORM_GAIN and a shift of +- NORM_SHIFT, the frozen
        codebooks a copy of the tensor named `codebook` (the codec's)."""
        specs: list = []

        def linear(name, d_in, d_out, bias=True):
            b = 1.0 / math.sqrt(d_in)
            specs.append((f"{name}.weight", (d_out, d_in), "uniform", b))
            if bias:
                specs.append((f"{name}.bias", (d_out,), "uniform", b))

        def norm(name, d):
            specs.extend([(f"{name}.weight", (d,), "one_plus_uniform", NORM_GAIN),
                          (f"{name}.bias", (d,), "uniform", NORM_SHIFT)])

        def stack(prefix, s: Stack):
            linear(f"{prefix}.embed.0", s.input_size, s.dim)
            norm(f"{prefix}.embed.1", s.dim)
            dk = s.dim // s.heads
            for i in range(s.blocks):
                p = f"{prefix}.encoders.{i}"
                xavier = math.sqrt(6.0 / (dk + s.heads))
                specs.extend([(f"{p}.self_attn.pos_bias_u", (s.heads, dk), "uniform", xavier),
                              (f"{p}.self_attn.pos_bias_v", (s.heads, dk), "uniform", xavier)])
                for n in ("linear_q", "linear_k", "linear_v", "linear_out"):
                    linear(f"{p}.self_attn.{n}", s.dim, s.dim)
                linear(f"{p}.self_attn.linear_pos", s.dim, s.dim, bias=False)
                linear(f"{p}.feed_forward.w_1", s.dim, s.ffn)
                linear(f"{p}.feed_forward.w_2", s.ffn, s.dim)
                for n in s.norms:
                    norm(f"{p}.{n}", s.dim)
            norm(f"{prefix}.after_norm", s.dim)

        stack("text_encoder", self.text_encoder)
        linear("text_enc_out_layer", self.text_encoder.dim, self.dim)
        unit = math.sqrt(3.0)  # U(-sqrt 3, sqrt 3): unit variance, as the normal initialiser
        specs.append(("token_embedding.weight", (self.vocab, self.input_size), "uniform", unit))
        specs.append(("lm_embedding.weight", (2, self.dim), "uniform", unit))
        stack("codec_lm.encoder", self.lm)
        linear("codec_lm.decoder", self.lm.dim, self.out_voc)
        stack("codec_encoder", self.codec_encoder)
        linear("codec_encoder_out_layer", self.codec_encoder.dim, self.dim)
        specs.append(("quantizer_codebook.embed", (self.n_q, self.bins, self.dim), f"copy:{codebook}", 0.0))
        return specs


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _linear(x, sd, name: str, p: ref.Precision) -> torch.Tensor:
    b = sd.get(f"{name}.bias")
    return F.linear(p.cast(x), p.cast(sd[f"{name}.weight"]), None if b is None else b.float())


def _norm(x, sd, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"].float(), sd[f"{name}.bias"].float(), LN_EPS)


def sinusoids(positions: torch.Tensor, d: int) -> torch.Tensor:
    """sin / cos (even / odd dims) of positions (any sign) x 10000^(-2m / d): (N, d)."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) * (-math.log(10000.0) / d))
    ang = positions.float()[:, None] * div[None]
    return torch.stack([ang.sin(), ang.cos()], dim=-1).reshape(len(positions), d)


def _attention(x, sd, prefix: str, s: Stack, visible: torch.Tensor, p: ref.Precision) -> torch.Tensor:
    """Rel-pos self-attention of x (T, d); visible (T, T) bool, True = attend."""
    T, H, dk = x.shape[0], s.heads, s.dim // s.heads
    q = _linear(x, sd, f"{prefix}.linear_q", p).reshape(T, H, dk)
    k = _linear(x, sd, f"{prefix}.linear_k", p).reshape(T, H, dk)
    v = _linear(x, sd, f"{prefix}.linear_v", p).reshape(T, H, dk)
    # the projected table of the distances T - 1 ... -(T - 1); query i and key j read distance i - j
    table = _linear(sinusoids(torch.arange(T - 1, -T, -1, device=x.device), s.dim), sd, f"{prefix}.linear_pos", p)
    pos = torch.arange(T, device=x.device)
    at = ((T - 1) - (pos[:, None] - pos[None, :]))[None].expand(H, T, T)
    ac = torch.einsum("qhd,khd->hqk", q + sd[f"{prefix}.pos_bias_u"].float(), k)
    bd = torch.einsum("qhd,nhd->hqn", q + sd[f"{prefix}.pos_bias_v"].float(), table.reshape(2 * T - 1, H, dk))
    bd = bd.gather(-1, at)
    scores = ((ac + bd) / math.sqrt(dk)).masked_fill(~visible[None], float("-inf"))
    ctx = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v).reshape(T, s.dim)
    return _linear(ctx, sd, f"{prefix}.linear_out", p)


def run_stack(x: torch.Tensor, sd, prefix: str, s: Stack, visible: torch.Tensor, p: ref.Precision) -> torch.Tensor:
    """One encoder stack over x (T, input_size): (T, dim)."""
    x = _norm(_linear(x, sd, f"{prefix}.embed.0", p), sd, f"{prefix}.embed.1")
    if s.kind == "lm":
        x = F.relu(x)
    x = x * math.sqrt(s.dim)
    act = F.silu if s.kind == "conformer" else F.relu
    n_mha, n_ff = s.norms
    for i in range(s.blocks):
        b = f"{prefix}.encoders.{i}"
        x = x + _attention(_norm(x, sd, f"{b}.{n_mha}"), sd, f"{b}.self_attn", s, visible, p)
        h = _norm(x, sd, f"{b}.{n_ff}")
        x = x + _linear(act(_linear(h, sd, f"{b}.feed_forward.w_1", p)), sd, f"{b}.feed_forward.w_2", p)
    return _norm(x, sd, f"{prefix}.after_norm")


def _all(T: int, device) -> torch.Tensor:
    return torch.ones(T, T, dtype=torch.bool, device=device)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def encode_text(m: Laura, sd, ids: torch.Tensor, p: ref.Precision = ref.Precision()) -> torch.Tensor:
    """Token ids (Lt,) -> the encoded text (Lt, dim)."""
    x = p.cast(sd["token_embedding.weight"])[ids.long()]
    h = run_stack(x, sd, "text_encoder", m.text_encoder, _all(len(ids), ids.device), p)
    return _linear(h, sd, "text_enc_out_layer", p)


def dense(m: Laura, sd, groups: torch.Tensor, p: ref.Precision = ref.Precision()) -> torch.Tensor:
    """The sum of the frozen codebooks' vectors of each frame's groups: (G, nq) -> (G, dim)."""
    embed = sd["quantizer_codebook.embed"]
    out = torch.zeros(groups.shape[0], m.dim, device=groups.device)
    for q in range(groups.shape[1]):
        out = out + p.cast(embed[q])[groups[:, q].long()]
    return out


def lm_logits(m: Laura, sd, text_h: torch.Tensor, groups: torch.Tensor,
              p: ref.Precision = ref.Precision()) -> torch.Tensor:
    """The codec LM's full forward over [sos, text, task, dense(groups)]:
    the logits (G + 1, out_voc) from which group i is drawn (i <= G: the
    last row follows every group), causal."""
    emb = p.cast(sd["lm_embedding.weight"])
    x = torch.cat([emb[0:1], text_h, emb[1:2], dense(m, sd, groups, p)])
    T = x.shape[0]
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    h = run_stack(x, sd, "codec_lm.encoder", m.lm, causal, p)
    return _linear(h[text_h.shape[0] + 1:], sd, "codec_lm.decoder", p)


def codec_embedding(m: Laura, sd, text_h: torch.Tensor, groups: torch.Tensor,
                    p: ref.Precision = ref.Precision()) -> torch.Tensor:
    """The NAR stage: the dense codec embedding (G, dim) of every frame."""
    def posed(x):
        return x * math.sqrt(m.dim) + sinusoids(torch.arange(x.shape[0], device=x.device), m.dim)

    x = torch.cat([posed(text_h), posed(dense(m, sd, groups, p))])
    h = run_stack(x, sd, "codec_encoder", m.codec_encoder, _all(x.shape[0], x.device), p)
    return _linear(h[text_h.shape[0]:], sd, "codec_encoder_out_layer", p)


def synthesize(m: Laura, codec: ref.Codec, sd_lm, sd_codec, ids: torch.Tensor, groups: torch.Tensor, frames: int,
               p: ref.Precision = ref.Precision()) -> torch.Tensor:
    """A request's `gen` waveform, (G * hop,) float: the NAR embedding of
    its G frames, wrap-padded with its own frames to `frames` (the decode
    length the program states), through the codec's decoder (no scale), cut
    to its G frames."""
    emb = codec_embedding(m, sd_lm, encode_text(m, sd_lm, ids, p), groups, p)
    G = emb.shape[0]
    emb = emb[torch.arange(frames, device=emb.device) % G]
    return ref.decode(codec, sd_codec, emb[None], None, p)[0, : G * codec.hop]


# ---------------------------------------------------------------------------
# the sampler (models/laura.draw_uniforms' hash, copied)
# ---------------------------------------------------------------------------

_GOLDEN = 0x9E3779B97F4A7C15
_MUL1, _MUL2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB


def _signed(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    return (z >> s) & ((1 << (64 - s)) - 1)


def splitmix64(z: torch.Tensor) -> torch.Tensor:
    z = z + _signed(_GOLDEN)
    z = (z ^ _srl(z, 30)) * _signed(_MUL1)
    z = (z ^ _srl(z, 27)) * _signed(_MUL2)
    return z ^ _srl(z, 31)


def draw_uniforms(seed: int, steps: torch.Tensor, groups: int, vocab: int) -> torch.Tensor:
    """float64 uniforms in (0, 1), (S, groups, vocab), of one request's seed
    at each of `steps` (S,) int64: element (i, g, v) hashes (seed, steps[i], g, v)."""
    dev = steps.device
    row = splitmix64(splitmix64(torch.tensor(int(seed), dtype=torch.int64, device=dev)) ^ steps)
    gv = torch.arange(groups * vocab, dtype=torch.int64, device=dev).reshape(groups, vocab)
    h = splitmix64(row[:, None, None] ^ splitmix64(gv))
    return (_srl(h, 11).double() + 0.5) * (1.0 / (1 << 53))


def sample_top_k(logits: torch.Tensor, k: int, u: torch.Tensor) -> torch.Tensor:
    """One draw per group from logits (..., V) over each group's k most
    probable entries (ties to the lower index): argmax of log p - log(-log u)."""
    prob = torch.softmax(logits.float(), dim=-1)
    order = torch.sort(prob, dim=-1, descending=True, stable=True).indices[..., :k]
    keep = torch.zeros_like(prob, dtype=torch.bool).scatter_(-1, order, True)
    logp = torch.log(prob.clamp_min(1e-20)).double().masked_fill(~keep, float("-inf"))
    return (logp - torch.log(-torch.log(u))).argmax(dim=-1)


def draws(m: Laura, logits: torch.Tensor, seed: int, top_k: int) -> torch.Tensor:
    """The groups (S, nq) that a request with `seed` draws from each row of
    logits (S, out_voc), row i at step i."""
    V = m.bins + 1
    steps = torch.arange(logits.shape[0], dtype=torch.int64, device=logits.device)
    return sample_top_k(logits.reshape(-1, m.predict_nq, V), top_k, draw_uniforms(seed, steps, m.predict_nq, V))


def relative_rows(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per-row relative L2 distance of got from want, (S,)."""
    return torch.linalg.vector_norm(got.float() - want, dim=-1) / torch.linalg.vector_norm(want, dim=-1).clamp_min(
        1e-12)


def state_dicts(sd: Dict[str, torch.Tensor], prefix: str = "lm.") -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(LM's, codec's) of one drawn dict whose LM tensors carry `prefix`."""
    lm = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return lm, {k: v for k, v in sd.items() if not k.startswith(prefix)}


def request_numbers(m: Laura, codec: ref.Codec, sd_lm, sd_codec, ids, groups, seed: int, top_k: int, frames: int,
                    p: ref.Precision = ref.Precision()) -> Dict[str, torch.Tensor]:
    """What precision p gives for one request's served groups (G, nq): its
    LM logits of steps 0 .. G - 1 (G, out_voc), the reference's draws from
    them with the request's uniforms, and the PCM16 (before rounding) of its
    `gen` synthesis."""
    text_h = encode_text(m, sd_lm, ids, p)
    logits = lm_logits(m, sd_lm, text_h, groups, p)[: groups.shape[0]]
    wav = synthesize(m, codec, sd_lm, sd_codec, ids, groups, frames, p)
    pcm = ref.pcm16_float(wav[None], torch.tensor([wav.shape[0]], device=wav.device))[0]
    return {"logits": logits, "draws": draws(m, logits, seed, top_k), "pcm": pcm}
