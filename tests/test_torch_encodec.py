"""The port's EnCodec serving slice against funcodec_tpu, on the CPU.

Both packages build the model from one config dict; the JAX parameters
cross over through compat/from_jax. The fp32 slice must give exactly the
JAX tokens with the reconstruction within 1e-4 (the contract of
tests/test_fullshape_parity.py); the FUSED_RVQ path (plain version on the
CPU) is held to >= 99% all-stage agreement with JAX's PALLAS_RVQ path.
"""

import ast
import copy
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import funcodec_tpu.quant.rvq as jrvq
import funcodec_tpu.quant.rvq_pallas as jrp
import funcodec_tpu_torch.quant.rvq as trvq
from funcodec_tpu.compat.torch_import import import_encodec
from funcodec_tpu.tasks.codec import build_codec_model as jbuild
from funcodec_tpu_torch.cli.codec_inference import Speech2Token, _bucket_length
from funcodec_tpu_torch.compat.from_jax import state_dict_from_jax
from funcodec_tpu_torch.tasks.codec import build_codec_model as tbuild
from funcodec_tpu_torch.tasks.codec import load_config

# one torch thread per test process: the suite runs in several processes at once,
# and the small CPU ops here gain nothing from more
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP_YAML = REPO / "egs/LibriTTS/codec/conf/encodec_16k_n32_600k_step.yaml"


def _config(causal=False, n_q=4, bins=32, dim=16, n_filters=4, codec_dim=None):
    seanet = {"norm": "time_group_norm", "n_filters": n_filters, "ratios": [4, 2], "causal": causal}
    q = {"codebook_size": bins, "num_quantizers": n_q, "kmeans_init": False,
         "sampling_rate": 16000, "encoder_hop_length": 8}
    if codec_dim is not None:
        q["codec_dim"] = codec_dim
    return {
        "input_size": 1,
        "encoder": "encodec_seanet_encoder", "encoder_conf": dict(seanet),
        "decoder": "encodec_seanet_decoder", "decoder_conf": dict(seanet),
        "quantizer": "costume_quantizer", "quantizer_conf": q,
        "model": "encodec",
        "model_conf": {"odim": dim, "target_sample_hz": 16000, "audio_normalize": True,
                       "segment_dur": None, "overlap_ratio": None},
    }


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _leaf(path, shape, rs):
    """A seeded value for one JAX parameter, at torch-init scale."""
    name = getattr(path[-1], "key", getattr(path[-1], "name", ""))
    if name == "kernel":
        return rs.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
    if name in ("w_ih", "w_hh", "b_ih", "b_hh"):
        return rs.uniform(-1, 1, shape) / np.sqrt(shape[-1] // 4)
    if name == "norm_scale":
        return 1.0 + 0.1 * rs.randn(*shape)
    if name == "embed":
        return rs.uniform(-1, 1, shape) * np.sqrt(1.0 / shape[-1])
    if name == "inited":
        return np.ones(shape)
    return 0.1 * rs.randn(*shape)  # biases, norm_bias, cluster sizes


def _pair(config, seed=0):
    """(jax model, params, rvq_state, port model with the same weights).

    The JAX params are numpy values from a seed, laid out by the JAX
    model's own init (traced for shapes only), then carried into the port
    by compat/from_jax."""
    jm, _ = jbuild(config)
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params, state = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(_leaf(p, a.shape, rs), a.dtype), shapes
    )
    state = state.replace(embed_avg=state.embed)
    tm, disc = tbuild(config, device="cpu")
    # the discriminator of the default discriminator_conf, as the JAX build returns
    assert type(disc).__name__ == "MultipleDiscriminator" and len(disc.discriminators) == 1
    tm.load_state_dict(state_dict_from_jax(tm, _np_tree(params), _np_tree(state)))
    return jm, params, state, tm.eval()


def _jit(fn, *args, **kwargs):
    """Run a JAX model method under one jit (eager op-by-op dispatch costs
    seconds per new shape on the CPU)."""
    return jax.jit(lambda *a: fn(*a, **kwargs))(*args)


def _speech(batch=2, length=800, seed=0):
    return (0.25 * np.random.RandomState(seed).randn(batch, length)).astype(np.float32)


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(causal=True), dict(n_q=3, bins=64, dim=32, n_filters=8), dict(codec_dim=8)],
    ids=["base", "causal", "wider", "codec_dim"],
)
@pytest.mark.parametrize("bit_width", [None, 250])
def test_fp32_slice_tokens_exact(kw, bit_width):
    jm, params, state, tm = _pair(_config(**kw))
    x = _speech(length=777)  # ragged: not a multiple of the hop
    out = _jit(jm.inference, params, state, jnp.asarray(x), need_recon=True, bit_width=bit_width)
    with torch.no_grad():
        tout = tm.inference(torch.from_numpy(x), bit_width=bit_width)
    np.testing.assert_array_equal(tout["code_indices"][0].numpy(), np.asarray(out["code_indices"][0]))
    np.testing.assert_allclose(
        tout["recon_speech"].numpy(), np.asarray(out["recon_speech"]), atol=1e-4, rtol=1e-4
    )
    assert tout["recon_speech"].shape == x.shape


def test_segmented_inference_matches_jax():
    """segment_dur set: per-segment tokens and the overlap-added recon."""
    config = _config()
    config["model_conf"].update(segment_dur=0.025, overlap_ratio=0.2)  # 400-sample segments
    jm, params, state, tm = _pair(config)
    x = _speech(length=1000, seed=4)
    assert tm._segments(1000) == jm._segments(1000) and len(tm._segments(1000)) == 4
    out = _jit(jm.inference, params, state, jnp.asarray(x), need_recon=True)
    with torch.no_grad():
        tout = tm.inference(torch.from_numpy(x))
    for t_idx, j_idx in zip(tout["code_indices"], out["code_indices"], strict=True):
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(
        tout["recon_speech"].numpy(), np.asarray(out["recon_speech"]), atol=1e-4, rtol=1e-4
    )


def test_linear_overlap_add_matches_jax():
    from funcodec_tpu.models.encodec import linear_overlap_add as j_ola
    from funcodec_tpu_torch.models.encodec import linear_overlap_add as t_ola

    rs = np.random.RandomState(5)
    frames = [rs.randn(2, 50).astype(np.float32) for _ in range(3)] + [rs.randn(2, 20).astype(np.float32)]
    ref = np.asarray(j_ola([jnp.asarray(f) for f in frames], 40))
    out = t_ola([torch.from_numpy(f) for f in frames], 40).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_encoding_and_decoding_modes_match_jax():
    jm, params, state, tm = _pair(_config())
    x = _speech(length=640, seed=1)
    jenc = _jit(jm.inference_encoding, params, state, jnp.asarray(x), need_recon=True)
    with torch.no_grad():
        tenc = tm.inference_encoding(torch.from_numpy(x), need_recon=True)
    tokens = np.asarray(jenc["code_indices"][0])
    np.testing.assert_array_equal(tenc["code_indices"][0].numpy(), tokens)
    np.testing.assert_allclose(tenc["recon_speech"].numpy(), np.asarray(jenc["recon_speech"]), atol=1e-4)
    btq = np.transpose(tokens, (1, 2, 0))  # (B, T, n_q)
    jdec = _jit(jm.inference_decoding, params, state, jnp.asarray(btq))
    emb = np.asarray(jdec["code_embeddings"][0][0])
    jemb = _jit(jm.inference_decoding_emb, params, state, jnp.asarray(emb))
    with torch.no_grad():
        tdec = tm.inference_decoding(torch.from_numpy(btq.copy()))
        temb = tm.inference_decoding_emb(torch.from_numpy(emb.copy()))
    np.testing.assert_allclose(tdec["recon_speech"].numpy(), np.asarray(jdec["recon_speech"]), atol=1e-4)
    np.testing.assert_allclose(temb["recon_speech"].numpy(), np.asarray(jemb["recon_speech"]), atol=1e-4)


def test_fused_rvq_matches_jax_pallas(monkeypatch):
    """FUSED_RVQ (plain version on the CPU) against PALLAS_RVQ + INTERPRET,
    both with fp32 convs: >= 99% of all-stage tokens agree."""
    jm, params, state, tm = _pair(_config(n_q=4, bins=64, dim=32, n_filters=4))
    x = _speech(batch=2, length=1600, seed=2)
    monkeypatch.setattr(jrvq, "PALLAS_RVQ", True)
    monkeypatch.setattr(jrp, "INTERPRET", True)
    monkeypatch.setattr(trvq, "FUSED_RVQ", True)
    out = _jit(jm.inference, params, state, jnp.asarray(x), need_recon=True)
    with torch.no_grad():
        tout = tm.inference(torch.from_numpy(x))
    j_idx = np.asarray(out["code_indices"][0])
    t_idx = tout["code_indices"][0].numpy()
    assert (t_idx == j_idx).mean() >= 0.99
    assert np.isfinite(tout["recon_speech"].numpy()).all()


def test_speech2token_round_trip(tmp_path):
    """inference, then encode, then decode through the public wrapper, with
    the weights loaded from a .pth the way a released checkpoint loads."""
    config = _config()
    jm, params, state, tm = _pair(config)
    pth = tmp_path / "model.pth"
    torch.save(tm.state_dict(), pth)
    s2t = Speech2Token(config, str(pth), dtype="float32", bit_width=None, device="cpu")
    x = _speech(batch=2, length=800, seed=3)

    codes, embs, recon, sub_quants = s2t(x, use_scale=False)
    ref = _jit(jm.inference, params, state, jnp.asarray(x), need_recon=True, use_scale=False)
    np.testing.assert_array_equal(codes[0], np.asarray(ref["code_indices"][0]))
    assert codes[0].dtype == np.int32 and codes[0].shape == (4, 2, 100)
    assert recon.shape == (2, 800) and sub_quants[0].shape == (4, 2, 100, 16)

    enc_codes, _, enc_recon, _ = s2t(x, run_mod="encode", need_recon=False)
    np.testing.assert_array_equal(enc_codes[0], codes[0])
    assert enc_recon is None

    _, _, dec_recon, _ = s2t(np.transpose(enc_codes[0], (1, 2, 0)), run_mod="decode", bit_width=None)
    np.testing.assert_allclose(dec_recon, recon, atol=1e-5)

    pcm = np.round(x * 32767).astype(np.int16)  # int16 PCM is dequantized on the device
    pcm_codes, _, _, _ = s2t(pcm)
    ref16 = _jit(jm.inference, params, state, jnp.asarray(pcm.astype(np.float32) / 32768.0))
    np.testing.assert_array_equal(pcm_codes[0], np.asarray(ref16["code_indices"][0]))

    assert _bucket_length(777, 8) == 896 and _bucket_length(1, 320) == 16 * 320


def test_speech2token_bfloat16_casts_params_not_codebooks(monkeypatch):
    """dtype="bfloat16" casts the parameters, keeps the codebooks fp32, and
    with FUSED_RVQ (the plain version on the CPU) stays close to fp32."""
    config = _config(n_q=4, bins=64, dim=16)
    s_fp = Speech2Token(config, None, dtype="float32", bit_width=None, device="cpu")
    s_bf = Speech2Token(config, None, dtype="bfloat16", bit_width=None, device="cpu")
    assert {p.dtype for p in s_bf.model.parameters()} == {torch.bfloat16}
    assert s_bf.model.quantizer.state.embed.dtype == torch.float32
    assert torch.equal(s_bf.model.quantizer.state.embed, s_fp.model.quantizer.state.embed)
    x = _speech(batch=2, length=1600, seed=6)
    codes_fp, _, recon_fp, _ = s_fp(x)
    monkeypatch.setattr(trvq, "FUSED_RVQ", True)
    codes_bf, embs, recon_bf, sub_quants = s_bf(x)
    assert embs[0][0].dtype == torch.bfloat16 and sub_quants[0].dtype == np.float32
    assert (codes_bf[0][0] == codes_fp[0][0]).mean() >= 0.9
    assert recon_bf.dtype == np.float32 and np.isfinite(recon_bf).all()
    _, _, dec_bf, _ = s_bf(np.transpose(codes_bf[0], (1, 2, 0)), run_mod="decode")
    _, _, emb_bf, _ = s_bf(embs[0][0].float().numpy(), run_mod="decode_emb")
    assert dec_bf.shape == emb_bf.shape == (2, 1600)
    assert np.isfinite(dec_bf).all() and np.isfinite(emb_bf).all()


def test_port_state_dict_imports_back_to_jax_params():
    """import_encodec(port state_dict) returns the original JAX params: the
    port's names are the reference FunCodec names a released .pth carries."""
    config = _config(codec_dim=8)
    jm, params, state, tm = _pair(config)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back, back_state = import_encodec(sd, jm)
    flat_a, tree_a = jax.tree_util.tree_flatten(params)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for name in ("inited", "cluster_size", "embed", "embed_avg"):
        np.testing.assert_array_equal(np.asarray(getattr(back_state, name)), np.asarray(getattr(state, name)))


def test_flagship_yaml_param_count_matches_jax():
    """Construct only: the shipped nq32ds320 yaml builds 14.85M parameters in
    both packages (JAX counted by shape, no init compute)."""
    config = load_config(str(FLAGSHIP_YAML))
    jm, _ = jbuild(copy.deepcopy(config))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))[0]
    j_count = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    tm, _ = tbuild(config, device="cpu")
    t_count = sum(p.numel() for p in tm.parameters())
    assert t_count == j_count
    assert abs(t_count / 1e6 - 14.85) / 14.85 < 0.02
    assert tuple(tm.quantizer.state.embed.shape) == (32, 1024, 128)


@pytest.mark.parametrize(
    "section,key,value",
    [("encoder_conf", "seq_model", "transformer"), ("encoder_conf", "norm", "weight_norm"),
     (None, "model", "freq_codec"), (None, "encoder", "encodec_seanet_encoder_2d"),
     (None, "model", "codec_semantic_aug")],
)
def test_unported_options_raise(section, key, value):
    """Options of later slices raise. weight_norm raised until the training
    slice ported it: that case now builds weight-normed encoder convs; the
    transformer seq_model raised until LauraTTS serving ported the
    transformer: that case now builds the bottleneck transformer; the
    freq_codec model and the 2D encoder raised until FreqCodec was ported:
    those cases now build a FreqCodec and a 2D encoder (given the (freq,
    time) ratio pairs a 2D encoder takes); codec_semantic_aug raised until
    the semantic codec was ported: that case now builds a CodecSemanticAug.
    A name that is not registered raises."""
    config = _config()
    (config[section] if section else config)[key] = value
    if value == "codec_semantic_aug":
        from funcodec_tpu_torch.models.semantic import CodecSemanticAug

        tm, _ = tbuild(config, device="cpu")
        assert isinstance(tm, CodecSemanticAug) and tm.cfg.ppg_usage_mod == "residual"
        with pytest.raises(ValueError, match="unknown model"):
            tbuild(dict(config, model="codec_semantic_aug_v2"), device="cpu")
        return
    if value == "freq_codec":
        from funcodec_tpu_torch.models.freqcodec import FreqCodec

        tm, _ = tbuild(config, device="cpu")
        assert isinstance(tm, FreqCodec) and tm.cfg.codec_domain == ("mag_phase", "mag_phase")
        return
    if value == "encodec_seanet_encoder_2d":
        config["encoder_conf"]["ratios"] = [[4, 1], [2, 2]]
        tm, _ = tbuild(config, device="cpu")
        assert tm.state_dict()["encoder.model.0.conv.conv.weight"].dim() == 4
        return
    if value == "weight_norm":
        tm, _ = tbuild(config, device="cpu")
        assert "encoder.model.0.conv.conv.weight_g" in tm.state_dict()
        return
    if value == "transformer":
        tm, _ = tbuild(config, device="cpu")
        assert any(k.endswith(".encoders.0.self_attn.linear_q.weight") for k in tm.state_dict())
        return
    with pytest.raises(NotImplementedError):
        tbuild(config, device="cpu")


def test_port_never_imports_jax():
    """A static scan: no module of funcodec_tpu_torch, and not chip_smoke.py,
    imports jax, flax, the JAX package, or msgpack and ml_dtypes (the card's
    machine has neither: compat/flax_msgpack reads the .ckpt format without them)."""
    banned = ("jax", "jaxlib", "flax", "optax", "funcodec_tpu", "msgpack", "ml_dtypes")
    offenders = []
    for path in sorted((REPO / "funcodec_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for name in names:
                if name.split(".")[0] in banned:
                    offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders
