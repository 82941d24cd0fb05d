"""Build LauraGenModel from FunCodec text2audio configs (port of
funcodec_tpu/tasks/text2audio.py).

The same yaml dict builds the JAX model and this one; the conformer
encoders carry conformer norm names, the codec LM (TransformerEncoder_s0)
transformer ones.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch

from funcodec_tpu_torch.models.laura import LauraConfig, LauraGenModel
from funcodec_tpu_torch.models.transformer import TransformerConfig
from funcodec_tpu_torch.tasks.codec import resolve_device

INIT_SEED = 0  # the weights of a model built without a generator


def _encoder_cfg_from_conf(conf: Dict[str, Any], input_size: int) -> TransformerConfig:
    """A conformer/transformer encoder yaml conf -> TransformerConfig."""
    pos_enc = conf.get("pos_enc_layer_type", conf.get("pos_enc", "rel_pos"))
    pos_map = {"rel_pos": "rel_pos", "abs_pos": "abs_pos", "sinusoidal": "abs_pos", None: "none"}
    return TransformerConfig(
        input_size=input_size,
        attention_dim=conf.get("output_size", 256),
        attention_heads=conf.get("attention_heads", 4),
        linear_units=conf.get("linear_units", 2048),
        num_blocks=conf.get("num_blocks", 6),
        dropout_rate=conf.get("dropout_rate", 0.1),
        positional_dropout_rate=conf.get("positional_dropout_rate", 0.1),
        attention_dropout_rate=conf.get("attention_dropout_rate", 0.0),
        input_layer=conf.get("input_layer", "linear"),
        pos_enc_type=pos_map.get(pos_enc, "rel_pos"),
        normalize_before=conf.get("normalize_before", True),
        activation="swish",  # the conformer default
        macaron_style=conf.get("macaron_style", False),
        use_cnn_module=conf.get("use_cnn_module", True),
        cnn_module_kernel=conf.get("cnn_module_kernel", 31),
        block_names="conformer",
    )


def _lm_cfg_from_conf(conf: Dict[str, Any]) -> TransformerConfig:
    """codec_lm_conf (TransformerEmbedLM kwargs) -> TransformerConfig."""
    pe_type = conf.get("pe_type", "split")
    pos_enc = conf.get("pos_enc", None)
    pos_map = {"rel_pos": "rel_pos", "sinusoidal": "abs_pos", "abs_pos": "abs_pos", None: "none"}
    if pe_type == "split":
        # the encoder's input layer is the identity; per-segment absolute
        # positions and the input Linear are applied by the model
        input_layer, enc_pos = "none", "none"
    else:
        input_layer, enc_pos = "linear_relu", pos_map.get(pos_enc, "none")
    return TransformerConfig(
        input_size=conf.get("att_unit", 256) if pe_type == "split" else conf.get("embed_unit", 128),
        attention_dim=conf.get("att_unit", 256),
        attention_heads=conf.get("head", 2),
        linear_units=conf.get("unit", 1024),
        num_blocks=conf.get("layer", 4),
        dropout_rate=conf.get("dropout_rate", 0.5),
        input_layer=input_layer,
        pos_enc_type=enc_pos,
        activation="relu",
        block_names="transformer",
    )


def build_laura_model(
    config: Dict[str, Any],
    token_list: Optional[List[str]] = None,
    *,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
) -> LauraGenModel:
    """The task's build_model: LauraGenModel on `device` (default the card;
    "meta" builds shapes only), weights drawn from `generator` (default:
    seeded with INIT_SEED), in eval mode."""
    device = torch.device(device) if str(device) == "meta" else resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(INIT_SEED)
    input_size = config.get("input_size", 512)
    model_conf = dict(config.get("model_conf", {}))
    codec_conf = model_conf.get("codec_conf", {})
    codec_lm_conf = dict(model_conf.get("codec_lm_conf", {}))
    lm_pe = codec_lm_conf.get("pe_type", "split")
    for k in ("name", "bidirectional_inputs", "codec_groups"):
        codec_lm_conf.pop(k, None)
    input_aug_conf = codec_lm_conf.pop("input_aug_conf", None)
    output_aug_conf = codec_lm_conf.pop("output_aug_conf", None)
    input_normalize = codec_lm_conf.pop("input_normalize", False)

    cfg = LauraConfig(
        input_size=input_size,
        vocab_size=len(token_list) if token_list else 0,
        num_quantizers=codec_conf.get("num_quantizers", 32),
        codebook_size=codec_conf.get("codebook_size", 1024),
        codebook_dim=codec_conf.get("codebook_dim", 128),
        predict_nq=model_conf.get("predict_nq", 1),
        codec_sampling_ratio=model_conf.get("codec_sampling_ratio", 0.0),
        lsm_weight=model_conf.get("lsm_weight", 0.1),
        length_normalized_loss=model_conf.get("length_normalized_loss", True),
        pos_emb_type=model_conf.get("pos_emb_type", "split"),
        lm_pe_type=lm_pe,
    )
    text_encoder_cfg = None
    if config.get("text_encoder") is not None:
        text_encoder_cfg = _encoder_cfg_from_conf(config.get("text_encoder_conf", {}), input_size)
    codec_encoder_cfg = _encoder_cfg_from_conf(config.get("codec_encoder_conf", {}), cfg.codebook_dim)
    lm_cfg = _lm_cfg_from_conf(codec_lm_conf)
    if lm_pe != "split":
        assert lm_cfg.input_size == cfg.codebook_dim, "codec LM embed_unit must equal codebook_dim"
    model = LauraGenModel(cfg, text_encoder_cfg, codec_encoder_cfg, lm_cfg, input_aug_conf=input_aug_conf,
                          output_aug_conf=output_aug_conf, input_normalize=input_normalize, device=device,
                          generator=generator)
    return model.eval()
