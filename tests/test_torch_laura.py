"""The port's LauraGenModel (inference half) against funcodec_tpu/models/laura.py,
on the CPU, fp32.

Both packages build the model from one config dict; the JAX parameters are
seeded numpy values carried into the port by compat/from_jax. Pieces agree
within 1e-5, greedy decode tokens exactly. The port's sampler is held to its
own contract: the batched decode equals batch-1 decode row by row, draws
stay inside the top-k / top-p set and follow the renormalised probabilities
(chi-squared), and a float64 numpy sampler draws the same tokens.
"""

import pathlib

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import funcodec_tpu.tasks.text2audio as jtask
import funcodec_tpu_torch.models.laura as tl
import funcodec_tpu_torch.tasks.text2audio as ttask
from funcodec_tpu_torch.compat.from_jax import laura_state_dict_from_jax
from test_torch_transformer import np_tree, seeded_params

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SHIPPED_YAML = REPO / "egs/LibriTTS/text2speech_laura/conf/text2audio_codec_lm_nq2_uni_rel_pos.yaml"
ATOL = 1e-5
NQ, BINS, DIM, DIN = 4, 24, 12, 16


def tiny_config(pe_type="uni"):
    enc = dict(output_size=16, attention_heads=2, linear_units=24, num_blocks=1, input_layer="linear",
               pos_enc_layer_type="rel_pos", use_cnn_module=False, dropout_rate=0.0)
    return {
        "input_size": DIN,
        "text_encoder": "conformer", "text_encoder_conf": dict(enc),
        "codec_encoder": "conformer", "codec_encoder_conf": dict(enc),
        "model": "laura_gen_model",
        "model_conf": {
            "predict_nq": 2, "lsm_weight": 0.0,
            "codec_conf": {"num_quantizers": NQ, "codebook_size": BINS, "codebook_dim": DIM},
            "codec_lm_conf": {"name": "transformer", "pos_enc": "rel_pos", "embed_unit": DIM, "att_unit": 16,
                              "head": 2, "unit": 24, "layer": 2, "dropout_rate": 0.0, "pe_type": pe_type},
        },
    }


def laura_pair(config, token_list=None, seed=0, eos_bias=None):
    """(JAX model, JAX params (numpy), port model with the same weights).
    eos_bias, when given, is added to the LM's eos logits."""
    jm = jtask.build_laura_model(config, token_list=token_list)
    params = seeded_params(jm.init, seed)
    if eos_bias is not None:
        b = params["lm_decoder"]["b"].reshape(jm.cfg.predict_nq, -1)
        b[:, jm.cfg.codebook_size] += eos_bias
    tm = ttask.build_laura_model(config, token_list=token_list, device="cpu")
    tm.load_state_dict(laura_state_dict_from_jax(tm, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair_uni():
    return laura_pair(tiny_config("uni"), seed=1, eos_bias=-10.0)


@pytest.fixture(scope="module")
def pair_split():
    return laura_pair(tiny_config("split"), seed=2, eos_bias=-10.0)


def _inputs(rs, B=2, Lt=7, P=3):
    text = rs.randn(B, Lt, DIN).astype(np.float32)
    tlen = np.array([Lt, Lt - 3][:B])
    codec = rs.randint(0, BINS, (B, P, 2))
    clen = np.array([P, 1][:B])
    return text, tlen, codec, clen


def test_pieces_match_jax(pair_uni):
    """encode_text, build_llm_io (with a codec prompt), _lm_forward,
    cal_codec_emb and syn_audio's embedding."""
    jm, params, tm = pair_uni
    text, tlen, codec, clen = _inputs(np.random.RandomState(3))

    def jax_pieces(p, text, tlen, codec, clen):
        h, _ = jm.encode_text(p, text, tlen)
        inputs, ilen = jm.build_llm_io(p, h, tlen, codec=codec, codec_lengths=clen)
        logits = jm._lm_forward(p, inputs, ilen, tlen + 1)
        prob = jax.nn.one_hot(codec, BINS)
        emb, _ = jm.cal_codec_emb(p, h, tlen, prob, clen)
        return h, inputs, ilen, logits, emb

    ref = jax.jit(jax_pieces)(params, *map(jnp.asarray, (text, tlen, codec, clen)))
    with torch.no_grad():
        t, tle, c, cle = map(torch.from_numpy, (text, tlen, codec, clen))
        h, _ = tm.encode_text(t, tle)
        inputs, ilen = tm.build_llm_io(h, tle, codec=c, codec_lengths=cle)
        logits = tm._lm_forward(inputs, ilen, tle + 1)
        emb, _ = tm.cal_codec_emb(h, tle, torch.nn.functional.one_hot(c, BINS).float(), cle)
    for name, a, b in zip(("text", "inputs", "lengths", "logits", "codec_emb"), (h, inputs, ilen, logits, emb), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=name)

    # syn_audio hands the codec decoder the same embedding (prompt cut off)
    ours = tm.syn_audio(codec[:1], text[:1, :5], np.array([5]), lambda e: e, continual_length=1)
    ref = jax.jit(lambda p, c, t, n: jm.syn_audio(p, c, t, n, lambda e: e, continual_length=1))(
        params, jnp.asarray(codec[:1]), jnp.asarray(text[:1, :5]), jnp.asarray([5]))
    assert ours.shape == (1, 2, DIM)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("pe", ["uni", "split"])
def test_greedy_decode_codec_equals_jax(pe, pair_uni, pair_split):
    jm, params, tm = pair_uni if pe == "uni" else pair_split
    rs = np.random.RandomState(4)
    text = rs.randn(1, 6, DIN).astype(np.float32)
    prompt = rs.randint(0, BINS, (3, 2))
    for cont in (None, prompt):
        ref = jm.decode_codec(params, jnp.asarray(text), jnp.asarray([6]), max_length=10, sampling=False,
                              key=jax.random.PRNGKey(0), continual=cont)
        out = tm.decode_codec(text, np.array([6]), max_length=10, sampling=False, continual=cont, segment_steps=4)
        assert out.shape == (1, 10 + (0 if cont is None else 3), 2)
        np.testing.assert_array_equal(out, ref)


def test_batch_rows_equal_single_decode_with_sampling():
    """Ragged texts and prompts, top-k sampling, eos reachable (rows stop at
    different steps): each row equals decode_codec of it with its seed."""
    _, _, tm = laura_pair(tiny_config("uni"), seed=5)
    rs = np.random.RandomState(6)
    B, Lmax, Pmax = 4, 7, 3
    tlen = np.array([7, 3, 5, 6])
    plen = np.array([0, 3, 1, 2])
    text = rs.randn(B, Lmax, DIN).astype(np.float32)
    prompts = rs.randint(0, BINS, (B, Pmax, 2))
    seeds = [11, 12, 13, 14]
    rows = tm.decode_codec_batch(text, tlen, max_length=12, sampling=5, seed=seeds, continual=prompts,
                                 continual_lengths=plen, segment_steps=5)
    lengths = set()
    for b in range(B):
        one = tm.decode_codec(text[b: b + 1], tlen[b: b + 1], max_length=12, sampling=5, seed=seeds[b],
                              continual=prompts[b, : plen[b]])
        np.testing.assert_array_equal(rows[b], one.reshape(-1, 2))
        lengths.add(rows[b].shape[0] - plen[b])
    assert len(lengths) > 1, "every row stopped at the same step: the test shows nothing of ragged stops"


def _numpy_sampler(logits, nq, sampling, seeds, step):
    """A second code path: per-row numpy float64 sampler over uint64 splitmix64."""
    M = np.uint64((1 << 64) - 1)

    def sm(z):
        with np.errstate(over="ignore"):
            z = (z + np.uint64(0x9E3779B97F4A7C15)) & M
            z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & M
            z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & M
            return z ^ (z >> np.uint64(31))

    out = np.zeros((len(seeds), nq), np.int64)
    for b, seed in enumerate(seeds):
        row = sm(sm(np.uint64(seed)) ^ np.uint64(step))
        for g in range(nq):
            s = logits[b].reshape(nq, -1)[g].astype(np.float64)
            V = s.shape[0]
            u = ((sm(row ^ sm(np.arange(g * V, (g + 1) * V, dtype=np.uint64))) >> np.uint64(11)).astype(np.float64)
                 + 0.5) / 2.0 ** 53
            p = np.exp(s - s.max())
            p /= p.sum()
            order = np.argsort(-p, kind="stable")
            keep = np.zeros(V, bool)
            if isinstance(sampling, bool):
                keep[:] = True
                base = s
            else:
                if isinstance(sampling, int):
                    keep[order[:sampling]] = True
                else:
                    cum_before = np.cumsum(p[order]) - p[order]
                    keep[order] = cum_before < sampling
                base = np.log(np.maximum(p, 1e-20))
            out[b, g] = np.argmax(np.where(keep, base, -np.inf) - np.log(-np.log(u)))
    return out


@pytest.mark.parametrize("sampling", [True, 5, 0.7])
def test_sampler_matches_numpy_path_in_float64(sampling):
    rs = np.random.RandomState(7)
    logits = (rs.randn(6, 2 * 25) * 2).astype(np.float32)
    seeds = [0, 1, 2, 3, 2 ** 40 + 5, 7]
    ours = tl.sample_groups(torch.from_numpy(logits.astype(np.float64)).float(), 2, sampling,
                            torch.tensor(seeds), 9).numpy()
    np.testing.assert_array_equal(ours, _numpy_sampler(logits, 2, sampling, seeds, 9))
    per_row = tl.sample_groups(torch.from_numpy(logits), 2, sampling, torch.tensor(seeds), torch.full((6,), 9))
    np.testing.assert_array_equal(per_row.numpy(), ours)  # a per-row step tensor draws the same


@pytest.mark.parametrize("sampling", [4, 0.6, True])
def test_sampler_set_and_chi_squared(sampling):
    """20,000 seeded draws on a fixed logits vector: never outside the set,
    and distributed as the renormalised probabilities (chi-squared)."""
    V, N = 12, 20_000
    logits = torch.tensor(np.random.RandomState(8).randn(V) * 1.5, dtype=torch.float32)
    p = torch.softmax(logits, -1).double().numpy()
    order = np.argsort(-p, kind="stable")
    keep = np.zeros(V, bool)
    if sampling is True:
        keep[:] = True
    elif isinstance(sampling, int):
        keep[order[:sampling]] = True
    else:
        keep[order] = (np.cumsum(p[order]) - p[order]) < sampling
    draws = tl.sample_groups(logits.expand(N, V), 1, sampling, torch.arange(N), 3)[:, 0].numpy()
    counts = np.bincount(draws, minlength=V)
    assert counts[~keep].sum() == 0
    q = np.where(keep, p, 0) / p[keep].sum()
    chi2 = float(((counts[keep] - N * q[keep]) ** 2 / (N * q[keep])).sum())
    # the 0.999 quantile of chi-squared with up to 11 degrees of freedom is 31.3
    assert chi2 < 31.3, (chi2, counts, N * q)


def test_draws_depend_on_seed_step_group_and_index_only():
    u = tl.draw_uniforms(torch.tensor([5, 6, 5]), torch.tensor([2, 2, 2]), 2, 7)
    assert torch.equal(u[0], u[2]) and not torch.equal(u[0], u[1])
    assert not torch.equal(u[0, 0], u[0, 1])
    assert torch.equal(tl.draw_uniforms(torch.tensor([5]), 2, 2, 7)[0], u[0])
    assert float(u.min()) > 0 and float(u.max()) < 1


def test_full_width_parameter_count():
    """The shipped LauraTTS yaml with a 256-entry word list: 88,669,186
    parameters in both packages (the frozen 32 x 1024 x 128 codebook included)."""
    config = yaml.safe_load(SHIPPED_YAML.read_text())
    tokens = [f"w{i}" for i in range(256)]
    jm = jtask.build_laura_model(config, token_list=tokens)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    tm = ttask.build_laura_model(config, token_list=tokens, device="meta")
    n_port = sum(p.numel() for p in tm.parameters())
    assert n_jax == n_port == 88_669_186
    no_tokens = ttask.build_laura_model(config, device="meta")
    assert sum(p.numel() for p in no_tokens.parameters()) == 88_275_970


def test_port_state_dict_loads_in_jax_importer(pair_uni):
    """The JAX CLI's import_laura reads the port's state_dict back to the params."""
    from funcodec_tpu.compat.torch_import import import_laura

    jm, params, tm = pair_uni
    back = np_tree(import_laura({k: v.numpy() for k, v in tm.state_dict().items()}, jm))
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    leaves = jax.tree_util.tree_leaves_with_path(back)
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        np.testing.assert_array_equal(leaf, flat[path])
