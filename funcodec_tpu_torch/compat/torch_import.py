"""FunCodec PyTorch state_dicts as the JAX package's parameter trees, in numpy
(port of funcodec_tpu/compat/torch_import.py and of
funcodec_tpu/models/transformer.import_encoder).

Each ``import_*`` takes a state_dict under the reference FunCodec names
(torch tensors or numpy arrays; the port's modules carry these names) and
returns the tree that the JAX package's function of the same name returns,
with numpy arrays for its leaves: lists where JAX keeps lists (SEANet
layers, LSTM layers, transformer blocks), ``None`` for a layer without
parameters, and ``RVQState`` (a namedtuple with the JAX struct's fields, in
its order) for the codebooks. Weight-norm pairs are fused into plain
kernels as the JAX importer fuses them (``fuse_torch_weight_norm``), so a
weight-normed model comes back through compat/from_jax within rounding;
a model without weight norm comes back bit for bit.

With compat/flax_msgpack.to_bytes, these trees make the JAX package's own
weights files (train/checkpoint.save_jax_weights) without JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Sequence

import numpy as np

from funcodec_tpu_torch.models.seanet import Layer, seq_tfm_cfg
from funcodec_tpu_torch.ops.conv import ConvSpec

Array = np.ndarray


class RVQState(NamedTuple):
    """The JAX package's RVQState (quant/rvq.py), field for field."""

    inited: Any  # (n_q,) float {0, 1}
    cluster_size: Any  # (n_q, bins)
    embed: Any  # (n_q, bins, dim)
    embed_avg: Any  # (n_q, bins, dim)


def _np(x) -> Array:
    """A torch tensor or an array as an owned numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.array(x, copy=True)


def fuse_torch_weight_norm(g: Array, v: Array) -> Array:
    """w = g * v / ||v|| with the norm over all dims except dim 0 (torch default)."""
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
    return (g * v / np.maximum(norm, 1e-12)).astype(v.dtype)


def _conv_kernel_from_torch(w: Array, spec: ConvSpec) -> Array:
    """Torch conv weight -> the JAX package's gather-form kernel.

    forward 1D: (O, I/g, K) -> (K, I/g, O)
    forward 2D: (O, I/g, Kf, Kt) -> (Kf, Kt, I/g, O)
    transposed 1D: (I, O/g, K) -> (K, I/g, O) unflipped gather form
    transposed 2D: (I, O/g, Kf, Kt) -> (Kf, Kt, I/g, O)
    """
    if not spec.transposed:
        return np.ascontiguousarray(np.transpose(w, (2, 1, 0) if spec.ndim == 1 else (2, 3, 1, 0)))
    g = spec.groups
    if spec.ndim == 1:
        i_total, o_per_g, k = w.shape
        wg = w.reshape(g, i_total // g, o_per_g, k)
        return np.transpose(wg, (3, 1, 0, 2)).reshape(k, i_total // g, g * o_per_g)
    i_total, o_per_g, kf, kt = w.shape
    wg = w.reshape(g, i_total // g, o_per_g, kf, kt)
    return np.transpose(wg, (3, 4, 1, 0, 2)).reshape(kf, kt, i_total // g, g * o_per_g)


def import_conv(sd: Mapping[str, Any], base: str, spec: ConvSpec) -> Dict[str, Array]:
    """One NormConv/SConv (conv.py:144-221); `base` ends at the S-module."""
    inner = "convtr" if spec.transposed else "conv"
    wbase = f"{base}.{inner}.{inner}"
    if f"{wbase}.weight_v" in sd:
        w = fuse_torch_weight_norm(_np(sd[f"{wbase}.weight_g"]), _np(sd[f"{wbase}.weight_v"]))
    else:
        w = _np(sd[f"{wbase}.weight"])
    params = {"kernel": _conv_kernel_from_torch(w, spec)}
    if f"{wbase}.bias" in sd:
        params["bias"] = _np(sd[f"{wbase}.bias"])
    nbase = f"{base}.{inner}.norm"
    if f"{nbase}.weight" in sd:
        params["norm_scale"] = _np(sd[f"{nbase}.weight"])
        params["norm_bias"] = _np(sd[f"{nbase}.bias"])
    return params


def import_lstm(sd: Mapping[str, Any], base: str, num_layers: int) -> List[Dict[str, Array]]:
    """torch nn.LSTM weights in the right-multiplication layout."""
    return [{"w_ih": np.ascontiguousarray(_np(sd[f"{base}.weight_ih_l{l}"]).T),
             "w_hh": np.ascontiguousarray(_np(sd[f"{base}.weight_hh_l{l}"]).T),
             "b_ih": _np(sd[f"{base}.bias_ih_l{l}"]),
             "b_hh": _np(sd[f"{base}.bias_hh_l{l}"])} for l in range(num_layers)]


def import_encoder(sd: Mapping[str, Any], prefix: str, cfg) -> Dict[str, Any]:
    """A TransformerEncoder_s0 / ConformerEncoder (`cfg`, the port's
    TransformerConfig) as funcodec_tpu/models/transformer.import_encoder
    reads it."""
    pfx = f"{prefix}." if prefix else ""

    def t(name):
        return _np(sd[f"{pfx}{name}"])

    def lin(name, bias=True):
        p = {"w": np.ascontiguousarray(t(f"{name}.weight").T)}
        if bias and f"{pfx}{name}.bias" in sd:
            p["b"] = t(f"{name}.bias")
        return p

    def ln(name):
        return {"scale": t(f"{name}.weight"), "bias": t(f"{name}.bias")}

    def pointwise(name):
        return {"w": np.ascontiguousarray(t(f"{name}.weight").transpose(2, 1, 0)), "b": t(f"{name}.bias")}

    p: Dict[str, Any] = {}
    if cfg.input_layer in ("linear", "linear_relu"):
        p["embed_linear"] = lin("embed.0")
        p["embed_norm"] = ln("embed.1")
    elif cfg.input_layer == "embed":
        p["embed_table"] = t("embed.0.weight")
    layers = []
    for i in range(cfg.num_blocks):
        base = f"encoders.{i}"
        attn = {key: lin(f"{base}.self_attn.linear_{key}") for key in ("q", "k", "v", "out")}
        if cfg.rel:
            attn["pos"] = lin(f"{base}.self_attn.linear_pos", bias=False)
            attn["bias_u"] = t(f"{base}.self_attn.pos_bias_u")
            attn["bias_v"] = t(f"{base}.self_attn.pos_bias_v")
        lp: Dict[str, Any] = {"attn": attn}
        # transformer blocks name their norms norm1/norm2, conformer blocks norm_mha/norm_ff
        if f"{pfx}{base}.norm1.weight" in sd:
            lp["norm_mha"], lp["norm_ff"] = ln(f"{base}.norm1"), ln(f"{base}.norm2")
        else:
            lp["norm_mha"], lp["norm_ff"] = ln(f"{base}.norm_mha"), ln(f"{base}.norm_ff")
        lp["ff"] = {"w1": lin(f"{base}.feed_forward.w_1"), "w2": lin(f"{base}.feed_forward.w_2")}
        if cfg.macaron_style:
            lp["ff_macaron"] = {"w1": lin(f"{base}.feed_forward_macaron.w_1"),
                                "w2": lin(f"{base}.feed_forward_macaron.w_2")}
            lp["norm_ff_macaron"] = ln(f"{base}.norm_ff_macaron")
        if cfg.use_cnn_module:
            cm = f"{base}.conv_module"
            lp["conv"] = {
                "pw1": pointwise(f"{cm}.pointwise_conv1"),
                "dw": pointwise(f"{cm}.depthwise_conv"),
                "bn_scale": t(f"{cm}.norm.weight"),
                "bn_bias": t(f"{cm}.norm.bias"),
                "bn_mean": t(f"{cm}.norm.running_mean"),
                "bn_var": t(f"{cm}.norm.running_var"),
                "pw2": pointwise(f"{cm}.pointwise_conv2"),
            }
            lp["norm_conv"] = ln(f"{base}.norm_conv")
            lp["norm_final"] = ln(f"{base}.norm_final")
        layers.append(lp)
    p["layers"] = layers
    if cfg.normalize_before:
        p["after_norm"] = ln("after_norm")
    return p


def import_seanet_layers(sd: Mapping[str, Any], prefix: str, layers: Sequence[Layer]) -> List[Any]:
    """A SEANet encoder/decoder layer list from `{prefix}.model.{i}`."""
    params: List[Any] = []
    for i, (kind, spec) in enumerate(layers):
        base = f"{prefix}.model.{i}"
        if kind == "conv":
            params.append(import_conv(sd, base, spec))
        elif kind == "lstm":
            params.append(import_lstm(sd, f"{base}.lstm", spec[1]))
        elif kind == "tfm":
            params.append(import_encoder(sd, base, seq_tfm_cfg(spec)))
        elif kind == "snake":
            params.append({"alpha": _np(sd[f"{base}.alpha"]).reshape(-1)})
        elif kind == "resblock":
            block, shortcut = spec
            bp: List[Any] = []
            for j, (bkind, bspec) in enumerate(block):
                if bkind == "conv":
                    bp.append(import_conv(sd, f"{base}.block.{j}", bspec))
                elif bkind == "snake":
                    bp.append({"alpha": _np(sd[f"{base}.block.{j}.alpha"]).reshape(-1)})
                else:
                    bp.append(None)
            sp = None if shortcut is None else import_conv(sd, f"{base}.shortcut", shortcut)
            params.append({"block": bp, "shortcut": sp})
        elif kind in ("act", "squeeze", "unsqueeze"):
            params.append(None)
        else:
            raise ValueError(kind)
    return params


def import_rvq_state(sd: Mapping[str, Any], prefix: str = "quantizer.rq.model") -> RVQState:
    """The stacked codebook buffers (ddp_core_vq.py:349-352)."""
    return RVQState(
        inited=_np(sd[f"{prefix}.inited"]).reshape(-1).astype(np.float32),
        cluster_size=_np(sd[f"{prefix}.cluster_size"]),
        embed=_np(sd[f"{prefix}.embed"]),
        embed_avg=_np(sd[f"{prefix}.embed_avg"]),
    )


def import_quantizer(sd: Mapping[str, Any], prefix: str = "quantizer"):
    """CostumeQuantizer params (the optional projections) and its RVQState."""
    params: Dict[str, Any] = {}
    if f"{prefix}.input_proj.weight" in sd:
        for name in ("input_proj", "output_proj"):
            params[name] = {"kernel": np.ascontiguousarray(_np(sd[f"{prefix}.{name}.weight"]).T),
                            "bias": _np(sd[f"{prefix}.{name}.bias"])}
    return params, import_rvq_state(sd, prefix=f"{prefix}.rq.model")


def import_encodec(sd: Mapping[str, Any], model) -> Any:
    """A full Encodec state_dict -> (params, rvq_state); `model` (the port's
    Encodec) gives the layer lists."""
    q_params, rvq_state = import_quantizer(sd, "quantizer")
    params = {
        "encoder": import_seanet_layers(sd, "encoder", model.encoder.layers),
        "quantizer": q_params,
        "decoder": import_seanet_layers(sd, "decoder", model.decoder.layers),
    }
    return params, rvq_state


def import_laura(sd: Mapping[str, Any], model) -> Dict[str, Any]:
    """A LauraGenModel state_dict (laura_model.py:58-146 naming); `model`
    (the port's LauraGenModel) gives the encoders' configs."""

    def lin(name):
        p = {"w": np.ascontiguousarray(_np(sd[f"{name}.weight"]).T)}
        if f"{name}.bias" in sd:
            p["b"] = _np(sd[f"{name}.bias"])
        return p

    params: Dict[str, Any] = {}
    if model.text_encoder_cfg is not None:
        params["text_encoder"] = import_encoder(sd, "text_encoder", model.text_encoder_cfg)
    params["text_enc_out_layer"] = lin("text_enc_out_layer")
    if "token_embedding.weight" in sd:
        params["token_embedding"] = _np(sd["token_embedding.weight"])
    params["lm_embedding"] = _np(sd["lm_embedding.weight"])
    params["codec_lm"] = import_encoder(sd, "codec_lm.encoder", model.codec_lm_cfg)
    if "codec_lm.input_layer.weight" in sd:
        params["lm_input_layer"] = lin("codec_lm.input_layer")
    params["lm_decoder"] = lin("codec_lm.decoder")
    params["codec_encoder"] = import_encoder(sd, "codec_encoder", model.codec_encoder_cfg)
    params["codec_encoder_out_layer"] = lin("codec_encoder_out_layer")
    params["quantizer_codebook"] = _np(sd["quantizer_codebook.embed"])
    return params


def import_hifigan_generator(state_dict: Mapping[str, Any], model) -> Dict[str, Any]:
    """A reference HiFiGANGenerator state_dict (hifigan.py:108-247) as
    models/hifigan_gen.HiFiGANGenerator params (weights fused); `model`, the
    port's HiFiGANGenerator, gives the config."""
    cfg = model.cfg
    sd = {k: _np(v) for k, v in state_dict.items()}

    def conv(prefix, transposed=False):
        if f"{prefix}.weight_v" in sd:
            w = fuse_torch_weight_norm(sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"])
        else:
            w = sd[f"{prefix}.weight"]
        # torch Conv1d (Cout, Cin, K) -> (K, Cin, Cout); ConvTranspose1d (Cin, Cout, K) -> (K, Cin, Cout)
        p = {"kernel": np.ascontiguousarray(np.transpose(w, (2, 0, 1) if transposed else (2, 1, 0)))}
        if f"{prefix}.bias" in sd:
            p["bias"] = sd[f"{prefix}.bias"]
        return p

    nb = len(cfg.resblock_kernel_sizes)
    params: Dict[str, Any] = {"input_conv": conv("input_conv")}
    params["upsamples"] = [conv(f"upsamples.{i}.1", transposed=True) for i in range(len(cfg.upsample_scales))]
    blocks = []
    for k in range(len(cfg.upsample_scales) * nb):
        n = len(cfg.resblock_dilations[k % nb])
        blocks.append({"convs1": [conv(f"blocks.{k}.convs1.{j}.1") for j in range(n)],
                       "convs2": [conv(f"blocks.{k}.convs2.{j}.1") for j in range(n)]
                       if cfg.use_additional_convs else []})
    params["blocks"] = blocks
    params["output_conv"] = conv("output_conv.1")
    if cfg.global_channels > 0:
        params["global_conv"] = conv("global_conv")
    return params
