"""Carry weights into the port: from funcodec_tpu parameter pytrees, or from a .pth.

``state_dict_from_jax`` inverts funcodec_tpu/compat/torch_import.py: it walks
the port's own layer list (the same (kind, spec) list as the JAX package's)
beside the JAX params and returns a state_dict under the reference FunCodec
names, which the port's modules carry; ``discriminator_state_dict_from_jax``
does the same for the discriminators' parameters (every registry kind),
``hifigan_generator_state_dict_from_jax`` for the HiFiGAN vocoder, and
``train_state_from_jax``
carries a whole GAN train state (both modules, the Adam moments and counts,
the gate carry and the step). 1D and 2D convs (FreqCodec's SEANet2d)
carry their kernels into torch's layouts; weight-normed convs carry
``v``/``g`` across as ``weight_v``/``weight_g``, and all four RVQ buffers
come along. ``encoder_state_dict_from_jax`` and ``laura_state_dict_from_jax``
do the same for the transformer/conformer stacks and a whole LauraGenModel,
under the names funcodec_tpu/compat/torch_import.import_laura reads. The
JAX params arrive as numpy arrays (``np.asarray`` of each
leaf); this module never imports jax.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch

from funcodec_tpu_torch.models.seanet import Layer
from funcodec_tpu_torch.ops.conv import ConvSpec

RVQ_BUFFERS = ("inited", "cluster_size", "embed", "embed_avg")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def torch_conv_weight(kernel: np.ndarray, spec: ConvSpec) -> np.ndarray:
    """JAX gather-form kernel -> torch conv weight (K... is K or Kf, Kt).

    forward:    (K..., Cin/g, Cout) -> (Cout, Cin/g, K...)
    transposed: (K..., Cin/g, Cout) -> (Cin, Cout/g, K...)  (stored unflipped;
                the groups reshuffled: the inverse of funcodec_tpu's
                compat/torch_import._conv_kernel_from_torch)
    """
    kernel = np.asarray(kernel)
    n = kernel.ndim - 2  # spatial axes
    spatial = tuple(range(n))
    if not spec.transposed:
        return np.transpose(kernel, (n + 1, n) + spatial)
    i_per_g, o = kernel.shape[n:]
    g = spec.groups
    wg = kernel.reshape(*kernel.shape[:n], i_per_g, g, o // g)
    return np.transpose(wg, (n + 1, n, n + 2) + spatial).reshape(g * i_per_g, o // g, *kernel.shape[:n])


def _weight_g(g, rank: int) -> torch.Tensor:
    """A weight-norm g (per dim-0 slice of the torch weight, in any of the
    JAX layouts: keepdims or 1-D) as torch's (n, 1, ..., 1) of the weight's rank."""
    return _t(np.asarray(g).reshape(-1, *([1] * (rank - 1))))


def _fused_jax_kernel(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """g * v / ||v||, the norm over the axes where g's keepdims shape is 1
    (funcodec_tpu ops/conv.fused_kernel), in fp32."""
    v, g = np.asarray(v, np.float32), np.asarray(g, np.float32)
    axes = tuple(i for i in range(v.ndim) if g.shape[i] == 1) if g.ndim == v.ndim else tuple(range(v.ndim - 1))
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
    return (v * (g / np.maximum(norm, 1e-12))).astype(np.float32)


def _conv(sd: Dict[str, torch.Tensor], base: str, spec: ConvSpec, p: Mapping[str, Any]) -> None:
    inner = "convtr" if spec.transposed else "conv"
    if "kernel" in p:
        sd[f"{base}.{inner}.{inner}.weight"] = _t(torch_conv_weight(p["kernel"], spec))
    else:
        v = torch_conv_weight(p["v"], spec)
        g = np.asarray(p["g"])
        if g.size != v.shape[0]:
            # a grouped transposed conv: the JAX norm runs per Cin/g slice
            # across the groups, torch's per input channel; carry the fused
            # weight as v, with its torch norm as g (the same weight)
            v = torch_conv_weight(_fused_jax_kernel(p["v"], g), spec)
            g = np.sqrt(np.square(v.astype(np.float64)).sum(axis=tuple(range(1, v.ndim))))
        sd[f"{base}.{inner}.{inner}.weight_v"] = _t(v)
        sd[f"{base}.{inner}.{inner}.weight_g"] = _weight_g(g, v.ndim)
    if "bias" in p:
        sd[f"{base}.{inner}.{inner}.bias"] = _t(p["bias"])
    if "norm_scale" in p:
        sd[f"{base}.{inner}.norm.weight"] = _t(p["norm_scale"])
        sd[f"{base}.{inner}.norm.bias"] = _t(p["norm_bias"])


def _layers(sd: Dict[str, torch.Tensor], prefix: str, layers: Sequence[Layer], params) -> None:
    for i, ((kind, spec), p) in enumerate(zip(layers, params, strict=True)):
        base = f"{prefix}.{i}"
        if kind == "conv":
            _conv(sd, base, spec, p)
        elif kind == "lstm":
            _lstm(sd, f"{base}.lstm", p)
        elif kind == "snake":
            sd[f"{base}.alpha"] = _t(np.asarray(p["alpha"]).reshape(1, -1, 1))
        elif kind == "resblock":
            block, shortcut = spec
            _layers(sd, f"{base}.block", block, p["block"])
            if shortcut is not None:
                _conv(sd, f"{base}.shortcut", shortcut, p["shortcut"])
        elif kind == "tfm":
            from funcodec_tpu_torch.models.seanet import seq_tfm_cfg

            encoder_state_dict_from_jax(sd, base, seq_tfm_cfg(spec), p)
        elif kind in ("act", "squeeze", "unsqueeze"):
            continue
        else:
            raise NotImplementedError(f"layer kind {kind!r} is not ported yet")


def _lstm(sd: Dict[str, torch.Tensor], base: str, layers) -> None:
    """A JAX stacked LSTM's per-layer {w_ih, w_hh, b_ih, b_hh} ((in, 4H)
    layouts) as nn.LSTM's tensors under `base`."""
    for l, lp in enumerate(layers):
        sd[f"{base}.weight_ih_l{l}"] = _t(np.asarray(lp["w_ih"]).T)
        sd[f"{base}.weight_hh_l{l}"] = _t(np.asarray(lp["w_hh"]).T)
        sd[f"{base}.bias_ih_l{l}"] = _t(lp["b_ih"])
        sd[f"{base}.bias_hh_l{l}"] = _t(lp["b_hh"])


def state_dict_from_jax(model, params: Mapping[str, Any], rvq_state) -> Dict[str, torch.Tensor]:
    """funcodec_tpu Encodec (params, rvq_state) as numpy -> the port's state_dict.

    `model` is the port's Encodec, FreqCodec or CodecSemanticAug (its layer
    lists drive the walk); `rvq_state` has the four codebook buffers as
    attributes or keys. Carried too: the context model (``params["context"]``)
    and the semantic codec's ``ppg_*`` / ``utt_level_proj`` layers. The
    identity quantizer holds no codebooks in the port (the JAX one's unused
    one-quantizer state is dropped); a residual_quantizer's are its inner
    quantizer's.
    """
    sd: Dict[str, torch.Tensor] = {}
    _layers(sd, "encoder.model", model.encoder.layers, params["encoder"])
    _layers(sd, "decoder.model", model.decoder.layers, params["decoder"])
    qp = params.get("quantizer") or {}
    for name in ("input_proj", "output_proj"):
        if name in qp:
            sd[f"quantizer.{name}.weight"] = _t(np.asarray(qp[name]["kernel"]).T)
            sd[f"quantizer.{name}.bias"] = _t(qp[name]["bias"])
    empty = model.quantizer.state.embed.shape[0] == 0
    for name in RVQ_BUFFERS:
        value = rvq_state[name] if isinstance(rvq_state, Mapping) else getattr(rvq_state, name)
        sd[f"quantizer.rq.model.{name}"] = _t(np.asarray(value)[:0] if empty else value)
    context = getattr(model, "context", None)
    if context is not None:
        if context.cfg.model == "transformer":
            encoder_state_dict_from_jax(sd, "context.encoder", context.encoder.cfg, params["context"])
        else:
            _lstm(sd, "context.lstm", params["context"])
    if "ppg_embedding" in params:
        sd["ppg_embedding.weight"] = _t(params["ppg_embedding"])
        _layers(sd, "ppg_ds_layer", model.ppg_ds_layers, params["ppg_ds_layer"])
        _layers(sd, "ppg_cond_layer", model.ppg_cond_layers, params["ppg_cond_layer"])
        if "ppg_classifier" in params:
            _layers(sd, "ppg_classifier", model.ppg_classifier_layers, params["ppg_classifier"])
        if "utt_level_proj" in params:
            sd["utt_level_proj.weight"] = _t(np.asarray(params["utt_level_proj"]["kernel"]).T)
            sd["utt_level_proj.bias"] = _t(params["utt_level_proj"]["bias"])
    return sd


def _linear(sd: Dict[str, torch.Tensor], base: str, p: Mapping[str, Any]) -> None:
    sd[f"{base}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{base}.bias"] = _t(p["b"])


def _layer_norm(sd: Dict[str, torch.Tensor], base: str, p: Mapping[str, Any]) -> None:
    sd[f"{base}.weight"] = _t(p["scale"])
    sd[f"{base}.bias"] = _t(p["bias"])


def encoder_state_dict_from_jax(sd: Dict[str, torch.Tensor], prefix: str, cfg, p: Mapping[str, Any]) -> None:
    """One funcodec_tpu transformer/conformer encoder's params (numpy) into
    `sd` under `prefix` (the port's TransformerEncoder names; `cfg` is the
    port's TransformerConfig, whose block_names picks the norms' names)."""
    pfx = f"{prefix}." if prefix else ""
    if cfg.input_layer in ("linear", "linear_relu"):
        _linear(sd, f"{pfx}embed.0", p["embed_linear"])
        _layer_norm(sd, f"{pfx}embed.1", p["embed_norm"])
    elif cfg.input_layer == "embed":
        sd[f"{pfx}embed.0.weight"] = _t(p["embed_table"])
    norm_mha, norm_ff = ("norm1", "norm2") if cfg.block_names == "transformer" else ("norm_mha", "norm_ff")
    for i, lp in enumerate(p["layers"]):
        base = f"{pfx}encoders.{i}"
        a = lp["attn"]
        for name, key in (("linear_q", "q"), ("linear_k", "k"), ("linear_v", "v"), ("linear_out", "out")):
            _linear(sd, f"{base}.self_attn.{name}", a[key])
        if cfg.rel:
            _linear(sd, f"{base}.self_attn.linear_pos", a["pos"])
            sd[f"{base}.self_attn.pos_bias_u"] = _t(a["bias_u"])
            sd[f"{base}.self_attn.pos_bias_v"] = _t(a["bias_v"])
        _layer_norm(sd, f"{base}.{norm_mha}", lp["norm_mha"])
        _layer_norm(sd, f"{base}.{norm_ff}", lp["norm_ff"])
        _linear(sd, f"{base}.feed_forward.w_1", lp["ff"]["w1"])
        _linear(sd, f"{base}.feed_forward.w_2", lp["ff"]["w2"])
        if cfg.macaron_style:
            _linear(sd, f"{base}.feed_forward_macaron.w_1", lp["ff_macaron"]["w1"])
            _linear(sd, f"{base}.feed_forward_macaron.w_2", lp["ff_macaron"]["w2"])
            _layer_norm(sd, f"{base}.norm_ff_macaron", lp["norm_ff_macaron"])
        if cfg.use_cnn_module:
            c, cm = lp["conv"], f"{base}.conv_module"
            for name, key in (("pointwise_conv1", "pw1"), ("depthwise_conv", "dw"), ("pointwise_conv2", "pw2")):
                sd[f"{cm}.{name}.weight"] = _t(np.transpose(np.asarray(c[key]["w"]), (2, 1, 0)))
                sd[f"{cm}.{name}.bias"] = _t(c[key]["b"])
            for name, key in (("weight", "bn_scale"), ("bias", "bn_bias"), ("running_mean", "bn_mean"),
                              ("running_var", "bn_var")):
                sd[f"{cm}.norm.{name}"] = _t(c[key])
            sd[f"{cm}.norm.num_batches_tracked"] = torch.tensor(0)
            _layer_norm(sd, f"{base}.norm_conv", lp["norm_conv"])
            _layer_norm(sd, f"{base}.norm_final", lp["norm_final"])
    if cfg.normalize_before:
        _layer_norm(sd, f"{pfx}after_norm", p["after_norm"])


def laura_state_dict_from_jax(model, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """funcodec_tpu LauraGenModel params (numpy) -> the port's state_dict
    under the reference names (`model` is the port's LauraGenModel, whose
    configs drive the walk)."""
    sd: Dict[str, torch.Tensor] = {}
    if model.text_encoder_cfg is not None:
        encoder_state_dict_from_jax(sd, "text_encoder", model.text_encoder_cfg, params["text_encoder"])
    _linear(sd, "text_enc_out_layer", params["text_enc_out_layer"])
    if "token_embedding" in params:
        sd["token_embedding.weight"] = _t(params["token_embedding"])
    sd["lm_embedding.weight"] = _t(params["lm_embedding"])
    encoder_state_dict_from_jax(sd, "codec_lm.encoder", model.codec_lm_cfg, params["codec_lm"])
    if "lm_input_layer" in params:
        _linear(sd, "codec_lm.input_layer", params["lm_input_layer"])
    _linear(sd, "codec_lm.decoder", params["lm_decoder"])
    encoder_state_dict_from_jax(sd, "codec_encoder", model.codec_encoder_cfg, params["codec_encoder"])
    _linear(sd, "codec_encoder_out_layer", params["codec_encoder_out_layer"])
    sd["quantizer_codebook.embed"] = _t(params["quantizer_codebook"])
    return sd


def _conv2d(sd: Dict[str, torch.Tensor], base: str, p: Mapping[str, Any]) -> None:
    """One discriminator conv: HWIO (kt, kf, Cin, Cout) -> torch (Cout, Cin, kt, kf)."""
    if "kernel" in p:
        sd[f"{base}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    else:
        sd[f"{base}.weight_v"] = _t(np.transpose(np.asarray(p["v"]), (3, 2, 0, 1)))
        sd[f"{base}.weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1, 1))
    sd[f"{base}.bias"] = _t(p["bias"])


def _conv1d(sd: Dict[str, torch.Tensor], base: str, p: Mapping[str, Any]) -> None:
    """One discriminator or vocoder Conv1d: (K, Cin/g, Cout) -> torch (Cout, Cin/g, K)."""
    if "kernel" in p:
        sd[f"{base}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
    else:
        sd[f"{base}.weight_v"] = _t(np.transpose(np.asarray(p["v"]), (2, 1, 0)))
        sd[f"{base}.weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1))
    if "bias" in p:
        sd[f"{base}.bias"] = _t(p["bias"])


def _msstft(sd, base, p) -> None:
    for j, scale in enumerate(p):
        sbase = f"{base}.discriminators.{j}"
        for k, cp in enumerate(scale["convs"]):
            _conv2d(sd, f"{sbase}.convs.{k}.conv", cp)
        _conv2d(sd, f"{sbase}.conv_post.conv", scale["conv_post"])


def _period(sd, base, p) -> None:
    for k, cp in enumerate(p["convs"]):
        _conv2d(sd, f"{base}.convs.{k}.0", cp)
    _conv2d(sd, f"{base}.output_conv", p["out"])


def _scale(sd, base, p) -> None:
    for k, cp in enumerate(p["convs"]):
        _conv1d(sd, f"{base}.layers.{k}.0", cp)
    _conv1d(sd, f"{base}.layers.{len(p['convs'])}", p["out"])


def _each(fn):
    def walk(sd, base, p):
        for k, q in enumerate(p):
            fn(sd, f"{base}.discriminators.{k}", q)

    return walk


def _msmpd(sd, base, p) -> None:
    _each(_scale)(sd, f"{base}.msd", p["msd"])
    _each(_period)(sd, f"{base}.mpd", p["mpd"])


def _soundstream(sd, base, p) -> None:
    for d, q in enumerate(p):
        dbase = f"{base}.discriminators.{d}"
        _conv1d(sd, f"{dbase}.init_conv", q["init"])
        for i, cp in enumerate(q["convs"]):
            _conv1d(sd, f"{dbase}.conv_layers.{i}.0", cp)
        _conv1d(sd, f"{dbase}.final_conv.0", q["final"][0])
        _conv1d(sd, f"{dbase}.final_conv.2", q["final"][1])


def _complex_stft(sd, base, p) -> None:
    def complex_conv(cbase, q):
        _conv2d(sd, f"{cbase}.re", q["re"])
        _conv2d(sd, f"{cbase}.im", q["im"])

    complex_conv(f"{base}.init_conv", p["init"])
    for i, u in enumerate(p["units"]):
        complex_conv(f"{base}.units.{i}.c1", u["c1"])
        sd[f"{base}.units.{i}.b"] = _t(u["b"])
        complex_conv(f"{base}.units.{i}.c2", u["c2"])
    complex_conv(f"{base}.final_conv", p["final"])


# the port's discriminator class -> the walk of its JAX params
_DISC_WALKS = {
    "MultiScaleSTFTDiscriminator": _msstft,
    "HiFiGANPeriodDiscriminator": _period,
    "HiFiGANMultiPeriodDiscriminator": _each(_period),
    "HiFiGANScaleDiscriminator": _scale,
    "HiFiGANMultiScaleDiscriminator": _each(_scale),
    "HiFiGANMultiScaleMultiPeriodDiscriminator": _msmpd,
    "MultiScaleDiscriminator": _soundstream,
    "ComplexSTFTDiscriminator": _complex_stft,
}


def discriminator_state_dict_from_jax(disc_params: Sequence[Any], discriminator) -> Dict[str, torch.Tensor]:
    """funcodec_tpu MultipleDiscriminator params (one entry per discriminator
    of the conf list) as numpy -> the port MultipleDiscriminator's
    state_dict. Each entry is walked by the kind of the port's sub-module
    at the same index of `discriminator`."""
    sd: Dict[str, torch.Tensor] = {}
    for i, p in enumerate(disc_params):
        _DISC_WALKS[type(discriminator.discriminators[i]).__name__](sd, f"discriminators.{i}", p)
    return sd


def hifigan_generator_state_dict_from_jax(model, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """funcodec_tpu HiFiGANGenerator params (numpy) -> the port's state_dict
    (`model`, the port's HiFiGANGenerator, gives the config). JAX keeps a
    transposed conv's weight-norm g per output channel, torch per input
    channel: such a conv carries its fused weight as v, with v's torch norm
    as g (the same weight)."""
    cfg = model.cfg
    sd: Dict[str, torch.Tensor] = {}

    def conv_transpose(base, p):
        if "kernel" in p:
            sd[f"{base}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (1, 2, 0)))
        else:
            v = np.transpose(_fused_jax_kernel(p["v"], p["g"]), (1, 2, 0))  # (K, Cin, Cout) -> (Cin, Cout, K)
            sd[f"{base}.weight_v"] = _t(v)
            sd[f"{base}.weight_g"] = _weight_g(np.sqrt(np.square(v.astype(np.float64)).sum(axis=(1, 2))), 3)
        sd[f"{base}.bias"] = _t(p["bias"])

    _conv1d(sd, "input_conv", params["input_conv"])
    for i, p in enumerate(params["upsamples"]):
        conv_transpose(f"upsamples.{i}.1", p)
    for k, blk in enumerate(params["blocks"]):
        for j, p in enumerate(blk["convs1"]):
            _conv1d(sd, f"blocks.{k}.convs1.{j}.1", p)
        for j, p in enumerate(blk["convs2"] if cfg.use_additional_convs else ()):
            _conv1d(sd, f"blocks.{k}.convs2.{j}.1", p)
    _conv1d(sd, "output_conv.1", params["output_conv"])
    if cfg.global_channels > 0:
        _conv1d(sd, "global_conv", params["global_conv"])
    return sd


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a FunCodec .pth state_dict (a codec's or a LauraGenModel's) onto
    the CPU, unwrapping {"model": sd}.

    The codebooks' `inited` flags become an (n_q,) float vector, as
    funcodec_tpu's importer reads them.
    """
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    sd = dict(sd)
    for key in [k for k in sd if k.endswith("rq.model.inited")]:
        sd[key] = sd[key].reshape(-1).float()
    return sd


def _jax_adam_states(tree) -> list:
    """The optax ScaleByAdamState nodes (count, mu, nu) of a JAX optimizer state."""
    if all(hasattr(tree, a) for a in ("count", "mu", "nu")):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [s for t in tree for s in _jax_adam_states(t)]
    return []


def _optimizer_state_from_jax(template, jax_opt_state, to_port: Callable[[Any], List[torch.Tensor]]):
    """A port optimizer state (`template`, a chain of make_optimizer's
    transformations) with the Adam moments and counts of `jax_opt_state`
    (an optax chain with one Adam); `to_port` maps a JAX parameter-shaped
    tree to the port's parameter list."""
    adams = _jax_adam_states(jax_opt_state)
    if len(adams) != 1:
        raise NotImplementedError(f"a JAX optimizer state with {len(adams)} Adam states does not carry across")
    count = int(np.asarray(adams[0].count))

    def carry(node):
        if isinstance(node, dict) and set(node) == {"count", "mu", "nu"}:
            return dict(count=count, mu=to_port(adams[0].mu), nu=to_port(adams[0].nu))
        if isinstance(node, tuple):
            return tuple(carry(n) for n in node)
        if isinstance(node, int):  # scale_by_learning_rate's update count
            return count
        raise NotImplementedError(f"optimizer state {type(node).__name__} does not carry across from JAX")

    return carry(template)


def train_state_from_jax(model, discriminator, jax_state, optimizer_g=None, optimizer_d=None):
    """A funcodec_tpu GANTrainState (JAX arrays or numpy) as the port's.

    Loads the generator's parameters and RVQ buffers into `model` and the
    discriminator's parameters into `discriminator`, and returns the port's
    GANTrainState over them with both optimizers' Adam moments and counts,
    the gate carry and the step. The optimizer states take the structure of
    `optimizer_g` / `optimizer_d` (default: ``make_optimizer()``, Adam)."""
    from funcodec_tpu_torch.train.step import GANTrainState, make_optimizer

    device = next(model.parameters()).device
    rvq_state = jax_state.rvq_state
    model.load_state_dict(state_dict_from_jax(model, jax_state.params, rvq_state))
    discriminator.load_state_dict(discriminator_state_dict_from_jax(jax_state.disc_params, discriminator))

    def gen_list(tree):
        sd = state_dict_from_jax(model, tree, rvq_state)
        return [sd[n].to(device) for n, _ in model.named_parameters()]

    def disc_list(tree):
        sd = discriminator_state_dict_from_jax(tree, discriminator)
        return [sd[n].to(device) for n, _ in discriminator.named_parameters()]

    opt_g = (optimizer_g or make_optimizer()).init(list(model.parameters()))
    opt_d = (optimizer_d or make_optimizer()).init(list(discriminator.parameters()))
    return GANTrainState(
        step=int(np.asarray(jax_state.step)),
        model=model,
        discriminator=discriminator,
        opt_state_g=_optimizer_state_from_jax(opt_g, jax_state.opt_state_g, gen_list),
        opt_state_d=_optimizer_state_from_jax(opt_d, jax_state.opt_state_d, disc_list),
        gen_loss_carry=torch.tensor(float(np.asarray(jax_state.gen_loss_carry)), device=device),
    )


def laura_train_state_from_jax(model, jax_state, optimizer=None):
    """A funcodec_tpu Laura TrainState (JAX arrays or numpy) as the port's
    LauraTrainState.

    Loads the parameters (the frozen codebook included) into `model`, the
    port's LauraGenModel, and returns the state over it with Adam's moments
    and counts and the step. The optimizer state takes the structure of
    `optimizer` (default: ``make_optimizer()``, Adam); the codebook's
    moments are dropped, since the port's optimizer does not hold it."""
    from funcodec_tpu_torch.train.laura_trainer import LauraTrainState, trainable
    from funcodec_tpu_torch.train.step import make_optimizer

    device = model.device
    model.load_state_dict(laura_state_dict_from_jax(model, jax_state.params))
    names = [n for n, p in model.named_parameters() if p.requires_grad]

    def to_list(tree):
        sd = laura_state_dict_from_jax(model, tree)
        return [sd[n].to(device) for n in names]

    template = (optimizer or make_optimizer()).init(trainable(model))
    return LauraTrainState(step=int(np.asarray(jax_state.step)), model=model,
                           opt_state=_optimizer_state_from_jax(template, jax_state.opt_state, to_list))
