"""The port's transformer/conformer stacks and KV-cache decode against
funcodec_tpu/models/transformer.py, on the CPU, fp32, max abs error 1e-5.

The JAX parameters are seeded numpy values laid out by the JAX init (traced
for shapes only) and carried into the port by compat/from_jax; each JAX
function is jitted once per configuration.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import funcodec_tpu.models.transformer as jt
import funcodec_tpu_torch.models.transformer as tt
from funcodec_tpu_torch.compat.from_jax import encoder_state_dict_from_jax

torch.set_num_threads(1)

ATOL = 1e-5


def _value(path, shape, rs):
    """A seeded value for one JAX leaf, at a scale that keeps activations O(1)."""
    name = getattr(path[-1], "key", getattr(path[-1], "name", ""))
    if name == "scale" or name == "bn_scale":
        return 1.0 + 0.1 * rs.randn(*shape)
    if name == "bn_var":
        return 1.0 + 0.2 * rs.rand(*shape)
    if name == "w" and len(shape) >= 2:
        return rs.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
    if name in ("embed_table", "token_embedding", "lm_embedding", "quantizer_codebook"):
        return rs.randn(*shape) * 0.5
    return 0.1 * rs.randn(*shape)


def seeded_params(init, seed=0):
    """numpy values for every leaf of `init`'s parameter tree."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(lambda p, a: np.asarray(_value(p, a.shape, rs), np.float32), shapes)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def encoder_pair(kw, seed=0, block_names="conformer"):
    """(JAX config, JAX params (numpy), port encoder with the same weights)."""
    jcfg = jt.TransformerConfig(**kw)
    params = seeded_params(lambda k: jt.init_encoder(k, jcfg), seed)
    tcfg = tt.TransformerConfig(**kw, block_names=block_names)
    enc = tt.TransformerEncoder(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = {}
    encoder_state_dict_from_jax(sd, "", tcfg, params)
    enc.load_state_dict(sd)
    return jcfg, params, enc.eval()


BASE = dict(input_size=12, attention_dim=16, attention_heads=2, linear_units=24, num_blocks=2)
ENCODERS = {
    "abs_linear": dict(BASE, pos_enc_type="abs_pos"),
    "rel_linear_relu": dict(BASE, pos_enc_type="rel_pos", input_layer="linear_relu"),
    "conformer": dict(BASE, pos_enc_type="rel_pos", activation="swish", macaron_style=True, use_cnn_module=True,
                      cnn_module_kernel=5),
    "embed": dict(BASE, input_layer="embed", vocab_size=10, pos_enc_type="abs_pos"),
    "none_rel_post_norm": dict(BASE, input_size=16, input_layer="none", pos_enc_type="rel_pos",
                               normalize_before=False),
}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_matches_jax(name):
    kw = ENCODERS[name]
    jcfg, params, enc = encoder_pair(kw, seed=1)
    rs = np.random.RandomState(2)
    B, T = 2, 9
    if kw.get("input_layer") == "embed":
        x = rs.randint(0, kw["vocab_size"], (B, T))
    else:
        x = rs.randn(B, T, kw["input_size"]).astype(np.float32)
    lengths = np.array([9, 6])
    jmask = jt.causal_mask(jnp.asarray(lengths), T)
    ref = jax.jit(lambda p, x, m: jt.apply_encoder(jcfg, p, x, m))(params, jnp.asarray(x), jmask)
    with torch.no_grad():
        out = enc(torch.from_numpy(x), tt.causal_mask(torch.from_numpy(lengths), T))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


LM = dict(BASE, input_layer="linear_relu", pos_enc_type="rel_pos")


@pytest.mark.parametrize("pos", ["rel_pos", "none"])
@pytest.mark.parametrize("chunk", [1, 3])
def test_step_matches_full_forward(pos, chunk):
    """Scalar-mode incremental decode over chunks equals the causal full forward."""
    _, _, enc = encoder_pair(dict(LM, pos_enc_type=pos), seed=3, block_names="transformer")
    T, B = 10, 2
    x = torch.from_numpy(np.random.RandomState(4).randn(B, T, 12).astype(np.float32))
    with torch.no_grad():
        full = enc(x, tt.causal_mask(torch.full((B,), T), T))
        emb = enc.embed_input(x)[0]
        cache = tt.init_kv_cache(enc.cfg, B, T + 2)
        rel_proj = enc.rel_proj(T + 2)
        outs = []
        for s in range(0, T, chunk):
            h, cache = enc.step(cache, emb[:, s: s + chunk], rel_proj=rel_proj)
            outs.append(h)
    assert cache.length == T
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def lm_pair():
    return encoder_pair(LM, seed=5, block_names="transformer")


def _jax_step(jcfg):
    def f(p, k, v, length, x, amask, wmask, rel_proj):
        cache = jt.KVCache(k=list(k), v=list(v), length=length)
        h, c = jt.apply_encoder_step(jcfg, p, cache, x, attend_mask=amask, rel_proj=rel_proj, write_mask=wmask)
        return h, c.k, c.v, c.length

    return jax.jit(f)


@pytest.mark.parametrize("n_new", [1, 3])
def test_per_row_step_matches_jax(lm_pair, n_new):
    """Per-row lengths with write_mask over a cache holding stale rows: the
    port's index write and gathered rel-pos window against JAX's where-write
    and one-hot window contraction. Outputs, caches and lengths agree."""
    jcfg, params, enc = lm_pair
    rs = np.random.RandomState(6)
    B, M, H, dk = 3, 12, 2, 8
    k0 = [rs.randn(B, M, H, dk).astype(np.float32) for _ in range(2)]  # stale contents
    v0 = [rs.randn(B, M, H, dk).astype(np.float32) for _ in range(2)]
    length = np.array([2, 5, 7])
    x = rs.randn(B, n_new, 16).astype(np.float32)
    amask = rs.rand(B, n_new, M) > 0.2
    amask[:, :, 0] = True
    wmask = np.array([True, False, True])
    rel_proj_j = jt.precompute_rel_proj(jcfg, params, M)
    h_j, k_j, v_j, len_j = _jax_step(jcfg)(params, k0, v0, jnp.asarray(length), jnp.asarray(x), jnp.asarray(amask),
                                           jnp.asarray(wmask), rel_proj_j)
    cache = tt.KVCache(k=[torch.from_numpy(a.copy()) for a in k0], v=[torch.from_numpy(a.copy()) for a in v0],
                       length=torch.from_numpy(length))
    with torch.no_grad():
        h_t, cache = enc.step(cache, torch.from_numpy(x), attend_mask=torch.from_numpy(amask),
                              rel_proj=enc.rel_proj(M), write_mask=torch.from_numpy(wmask))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL, rtol=0)
    for a, b in zip(cache.k + cache.v, list(k_j) + list(v_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(cache.length.numpy(), np.asarray(len_j))
    np.testing.assert_array_equal(cache.k[0][1].numpy(), k0[0][1])  # the masked-off row is untouched


def test_rel_proj_matches_jax(lm_pair):
    jcfg, params, enc = lm_pair
    ref = jt.precompute_rel_proj(jcfg, params, 7)
    with torch.no_grad():
        ours = enc.rel_proj(7)
    for a, b in zip(ours, ref, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("names", ["conformer", "transformer"])
def test_state_dict_names_read_by_import_encoder(names):
    """The port's state_dict, read by the JAX importer, gives back the params."""
    kw = ENCODERS["conformer"]
    jcfg, params, enc = encoder_pair(kw, seed=7, block_names=names)
    sd = {k: v.numpy() for k, v in enc.state_dict().items()}
    back = jt.import_encoder(sd, "", jcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(np_tree(back))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])
    assert any(f".{'norm1' if names == 'transformer' else 'norm_mha'}." in k for k in sd)


def test_masks_match_jax():
    lengths = np.array([4, 2, 0])
    np.testing.assert_array_equal(tt.causal_mask(torch.from_numpy(lengths), 5).numpy(),
                                  np.asarray(jt.causal_mask(jnp.asarray(lengths), 5)))
    np.testing.assert_array_equal(tt.make_pad_mask_bool(torch.from_numpy(lengths), 5).numpy(),
                                  np.asarray(jt.make_pad_mask_bool(jnp.asarray(lengths), 5)))


@pytest.mark.parametrize("causal", [False, True])
def test_seanet_transformer_bottleneck_matches_jax(causal):
    """SEANet with seq_model="transformer" (the encoder's and the decoder's
    bottleneck transformer) against the JAX SEANet: tokens exact, recon 1e-4."""
    from test_torch_encodec import _config, _jit, _pair, _speech

    config = _config(causal=causal)
    for side in ("encoder_conf", "decoder_conf"):
        config[side].update(seq_model="transformer", seq_layer_num=1)
    jm, params, state, tm = _pair(config, seed=3)
    assert any(type(m).__name__ == "SeqTransformer" for m in tm.modules())
    x = _speech(length=640, seed=5)
    out = _jit(jm.inference, params, state, jnp.asarray(x), need_recon=True, bit_width=None)
    with torch.no_grad():
        tout = tm.inference(torch.from_numpy(x), bit_width=None)
    np.testing.assert_array_equal(tout["code_indices"][0].numpy(), np.asarray(out["code_indices"][0]))
    np.testing.assert_allclose(tout["recon_speech"].numpy(), np.asarray(out["recon_speech"]), atol=1e-4, rtol=1e-4)
