"""Build codec models from FunCodec-style configs (port of funcodec_tpu/tasks/codec.py).

The same config dict or yaml that builds the JAX model builds this one, so
one file drives both packages and a released checkpoint's config.yaml
round-trips. Ported: the ``encodec`` and ``freq_codec`` models, the 1D and
2D SEANet encoders/decoders (``encodec_seanet_{encoder,decoder}[_2d]``)
and the ``costume_quantizer``, with the MS-STFT discriminator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from funcodec_tpu_torch.models.discriminators import MultipleDiscriminator
from funcodec_tpu_torch.models.encodec import Encodec, EncodecConfig
from funcodec_tpu_torch.models.freqcodec import FreqCodec, FreqCodecConfig
from funcodec_tpu_torch.models.quantizer import Quantizer, QuantizerConfig
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


def _require(name: str, value: str, supported, where: str) -> None:
    if value not in supported:
        raise NotImplementedError(f"{name} {value!r} is not ported yet ({where})")


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
    _require("encoder", encoder_name, ("encodec_seanet_encoder", "encodec_seanet_encoder_2d"), "ROADMAP.md slice C")
    _require("decoder", decoder_name, ("encodec_seanet_decoder", "encodec_seanet_decoder_2d"), "ROADMAP.md slice C")
    _require("quantizer", config.get("quantizer", "costume_quantizer"),
             ("costume_quantizer",), "ROADMAP.md slice C")
    _require("model", model_name, ("encodec", "freq_codec"), "ROADMAP.md slice C, item 17")

    enc_conf = config.get("encoder_conf", {})
    if encoder_name == "encodec_seanet_encoder_2d":
        encoder = SEANetEncoder2d(SEANetConfig2d.from_conf(enc_conf, input_size=input_size, dimension=odim),
                                  device=device, generator=generator)
    else:
        enc_cfg = build_seanet_config(enc_conf, dict(input_size=input_size, dimension=odim))
        encoder = SEANetEncoder(enc_cfg, device=device, generator=generator)

    q_kw = _filter_fields(QuantizerConfig, config.get("quantizer_conf", {}))
    q_kw.setdefault("input_size", odim)
    quantizer = Quantizer(QuantizerConfig(**q_kw), device=device, generator=generator)

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
    else:
        ec_kw = _filter_fields(EncodecConfig, model_conf)
        ec_kw["input_size"] = input_size
        model = Encodec(EncodecConfig(**ec_kw), encoder, quantizer, decoder)
    discriminator = build_discriminator(config.get("discriminator_conf"), device=device, generator=generator)
    return model, discriminator


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
