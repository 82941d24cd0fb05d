"""Build codec models from FunCodec-style configs (port of funcodec_tpu/tasks/codec.py).

The same config dict or yaml that builds the JAX model builds this one, so
one file drives both packages and a released checkpoint's config.yaml
round-trips. Ported: the ``encodec`` (with its context loss),
``freq_codec`` and ``codec_semantic_aug`` models, the 1D and 2D SEANet
encoders/decoders (``encodec_seanet_{encoder,decoder}[_2d]``) and the
``costume_quantizer``, ``residual_quantizer`` and ``identity_quantizer``,
with the MS-STFT discriminator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from funcodec_tpu_torch.models.discriminators import MultipleDiscriminator
from funcodec_tpu_torch.models.encodec import Encodec, EncodecConfig
from funcodec_tpu_torch.models.freqcodec import FreqCodec, FreqCodecConfig
from funcodec_tpu_torch.models.quantizer import IdentityQuantizer, Quantizer, QuantizerConfig, ResidualQuantizer
from funcodec_tpu_torch.models.seanet import SEANetConfig, SEANetDecoder, SEANetEncoder
from funcodec_tpu_torch.models.seanet2d import SEANetConfig2d, SEANetDecoder2d, SEANetEncoder2d


def _freeze(v):
    """yaml lists -> hashable tuples (recursively) for frozen dataclasses."""
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


def _filter_fields(cls, conf: Dict[str, Any], rename=(), drop=()) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    rename = dict(rename)
    out = {}
    for k, v in conf.items():
        k = rename.get(k, k)
        if k in drop or k not in names:
            continue
        out[k] = _freeze(v) if isinstance(v, list) else v
    return out


def build_seanet_config(conf: Dict[str, Any], defaults: Dict[str, Any]) -> SEANetConfig:
    merged = dict(defaults)
    merged.update(
        _filter_fields(SEANetConfig, conf, rename={"channels": "input_size"}, drop=("norm_params",))
    )
    ap = conf.get("activation_params")
    if isinstance(ap, dict):
        merged["activation_params"] = tuple(sorted(ap.items()))
    return SEANetConfig(**merged)


def _require(name: str, value: str, supported) -> None:
    """Raise for a name that is not a registered choice (the JAX package
    raises ValueError for these too)."""
    if value not in supported:
        raise ValueError(f"unknown {name} {value!r}; the registered ones are {', '.join(supported)}")


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """torch.device(device); a CUDA device where torch sees no card raises,
    so a run that was meant for the card never drops to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: torch.cuda.is_available() is False. The port runs on a "
            "CUDA card by default; pass device='cpu' to run on the CPU."
        )
    return dev


# the lucidrains-surface kwargs of residual_quantizer (residual_quantizer.py:5-34)
RESIDUAL_QUANTIZER_KEYS = ("input_size", "codebook_size", "num_quantizers", "commitment_weight", "ema_decay",
                           "quantize_dropout_multiple_of", "quantize_dropout_cutoff_index", "kmeans_init",
                           "sync_kmeans", "sync_codebook", "quantize_dropout")


def build_quantizer(conf: Dict[str, Any], input_size: int, name: str = "costume_quantizer", *, device,
                    generator: torch.Generator):
    """The quantizer named `name` from quantizer_conf: costume_quantizer and
    identity_quantizer take QuantizerConfig's fields, residual_quantizer its
    own lucidrains-surface kwargs."""
    _require("quantizer", name, ("costume_quantizer", "residual_quantizer", "identity_quantizer"))
    if name == "residual_quantizer":
        rq_kw = {k: v for k, v in conf.items() if k in RESIDUAL_QUANTIZER_KEYS}
        rq_kw.setdefault("input_size", input_size)
        return ResidualQuantizer(**rq_kw, device=device, generator=generator)
    kw = _filter_fields(QuantizerConfig, conf)
    kw.setdefault("input_size", input_size)
    if name == "identity_quantizer":
        return IdentityQuantizer(QuantizerConfig(**kw), device=device)
    return Quantizer(QuantizerConfig(**kw), device=device, generator=generator)


CONTEXT_MODEL_KEYS = (("attention_heads", "attention_heads"), ("linear_units", "linear_units"),
                      ("num_blocks", "num_blocks"), ("num_layers", "lstm_layers"), ("output_size", "odim"))


def flat_context_conf(cc: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    """The reference's context_loss_conf layout ({model, model_conf,
    mask_conf, *_weight, ...}) flattened into ContextConfig's fields, sorted
    (the JAX package's tasks/codec.py:159-184)."""
    flat: Dict[str, Any] = {"model": cc.get("model", "transformer")}
    mc = cc.get("model_conf", {}) or {}
    for src_k, dst_k in CONTEXT_MODEL_KEYS:
        if src_k in mc:
            flat[dst_k] = mc[src_k]
    mask_conf = cc.get("mask_conf", {}) or {}
    if "mask_ratio_range" in mask_conf:
        flat["mask_ratio_range"] = tuple(mask_conf["mask_ratio_range"])
    if "num_mask" in mask_conf:
        flat["num_mask"] = mask_conf["num_mask"]
    for k in ("use_quant_for_context", "mask_pred_weight", "ce_loss_weight", "lm_loss_weight",
              "contrast_loss_weight"):
        if k in cc:
            flat[k] = cc[k]
    return tuple(sorted(flat.items()))


DEFAULT_DISCRIMINATOR_CONF = {"disc_conf_list": [{"name": "encodec_multi_scale_stft_discriminator", "filters": 32}]}


def build_discriminator(conf: Optional[Dict[str, Any]], *, device, generator: torch.Generator):
    """The discriminator of ``discriminator_conf`` (the MS-STFT one when
    None). It always sees the 1-channel waveform: the model's input_size is
    the encoder's channel count, not the discriminator's."""
    conf = conf or DEFAULT_DISCRIMINATOR_CONF
    return MultipleDiscriminator(input_size=conf.get("input_size", 1), disc_conf_list=conf["disc_conf_list"],
                                 device=device, generator=generator)


def build_codec_model(
    config: Dict[str, Any],
    *,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
):
    """Build (model, discriminator) from a FunCodec-style config dict.

    Both live on `device`, the card unless the caller asks for the CPU.
    Weights and (non-kmeans) codebooks are drawn from `generator`, the
    discriminator's after the model's; the default is a generator on
    `device` seeded with 0.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    input_size = config.get("input_size", 1)
    model_conf = dict(config.get("model_conf", {}))
    odim = model_conf.get("odim", 128)

    encoder_name = config.get("encoder", "encodec_seanet_encoder")
    decoder_name = config.get("decoder", "encodec_seanet_decoder")
    model_name = config.get("model", "encodec")
    _require("encoder", encoder_name, ("encodec_seanet_encoder", "encodec_seanet_encoder_2d"))
    _require("decoder", decoder_name, ("encodec_seanet_decoder", "encodec_seanet_decoder_2d"))
    _require("model", model_name, ("encodec", "freq_codec", "codec_semantic_aug"))

    enc_conf = config.get("encoder_conf", {})
    if encoder_name == "encodec_seanet_encoder_2d":
        encoder = SEANetEncoder2d(SEANetConfig2d.from_conf(enc_conf, input_size=input_size, dimension=odim),
                                  device=device, generator=generator)
    else:
        enc_cfg = build_seanet_config(enc_conf, dict(input_size=input_size, dimension=odim))
        encoder = SEANetEncoder(enc_cfg, device=device, generator=generator)

    quantizer = build_quantizer(config.get("quantizer_conf", {}), odim, config.get("quantizer", "costume_quantizer"),
                                device=device, generator=generator)

    dec_conf = dict(config.get("decoder_conf", {}))
    out_channels = dec_conf.pop("channels", input_size)
    if decoder_name == "encodec_seanet_decoder_2d":
        decoder = SEANetDecoder2d(SEANetConfig2d.from_conf(dec_conf, input_size=out_channels, dimension=odim),
                                  device=device, generator=generator)
    else:
        dec_cfg = build_seanet_config(dec_conf, dict(input_size=out_channels, dimension=odim))
        decoder = SEANetDecoder(dec_cfg, device=device, generator=generator)

    if model_name == "freq_codec":
        fc_kw = _filter_fields(FreqCodecConfig, model_conf)
        fc_kw["input_size"] = input_size
        domain_conf = model_conf.get("domain_conf", {}) or {}
        if "n_fft" in domain_conf:
            fc_kw["domain_n_fft"] = domain_conf["n_fft"]
        if "hop_length" in domain_conf:
            fc_kw["domain_hop_length"] = domain_conf["hop_length"]
        model = FreqCodec(FreqCodecConfig(**fc_kw), encoder, quantizer, decoder)
    elif model_name == "codec_semantic_aug":
        from funcodec_tpu_torch.models.semantic import CodecSemanticAug, SemanticCodecConfig

        sc_kw = _filter_fields(SemanticCodecConfig, model_conf)
        sc_kw["input_size"] = input_size
        ppg_conf = model_conf.get("ppg_conf", {}) or {}
        for k in ("ppg_dim", "ppg_ds_rate", "ppg_ds_type", "ppg_usage_mod"):
            if k in ppg_conf:
                sc_kw[k] = ppg_conf[k]
        model = CodecSemanticAug(SemanticCodecConfig(**sc_kw), encoder, quantizer, decoder, device=device,
                                 generator=generator)
    else:
        ec_kw = _filter_fields(EncodecConfig, model_conf, drop=("context_loss_conf",))
        ec_kw["input_size"] = input_size
        cc = model_conf.get("context_loss_conf")
        if cc and model_conf.get("context_loss_weight", 0) > 0:
            ec_kw["context_loss_conf"] = flat_context_conf(cc)
        model = Encodec(EncodecConfig(**ec_kw), encoder, quantizer, decoder, device=device, generator=generator)
    discriminator = build_discriminator(config.get("discriminator_conf"), device=device, generator=generator)
    return model, discriminator


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
