"""The port's streaming session (models/streaming.py) against funcodec_tpu, on the CPU.

Mirrors tests/test_streaming.py: both packages build one causal weight_norm
codec from a config dict (n_filters 8, 16-d latents, ratios 8·5·4·2, a
2-layer LSTM, 4 codebooks of 32), the JAX values seeded numpy carried into
the port by compat/from_jax. Each case holds the port's streamed output
against the port's own whole-utterance path and against JAX's streamed
output on the same chunks.

Tolerances (fp32): encoder latents atol 2e-5 and decoder samples atol 2e-4
(the JAX test's own streamed-vs-whole limits, used for both comparisons);
tokens equal; the LSTM with carries 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from funcodec_tpu.models import streaming as jstream
from funcodec_tpu.ops import rnn as jrnn
from funcodec_tpu_torch.models import streaming as tstream
from funcodec_tpu_torch.ops import rnn as trnn
from tests.test_torch_gan_step import build_pair, np_tree

torch.set_num_threads(1)

ENC_ATOL, DEC_ATOL = 2e-5, 2e-4


def causal_config(**seanet):
    s = dict(causal=True, norm="weight_norm", pad_mode="reflect", n_filters=8, ratios=[8, 5, 4, 2],
             seq_model="lstm")
    s.update(seanet)
    return {
        "encoder_conf": dict(s), "decoder_conf": dict(s),
        "quantizer_conf": {"codebook_size": 32, "num_quantizers": 4, "kmeans_init": False,
                           "sampling_rate": 16000, "encoder_hop_length": 320},
        "model_conf": {"odim": 16, "audio_normalize": False},
    }


_PAIRS = {}


def pair_for(**seanet):
    key = tuple(sorted(seanet.items()))
    if key not in _PAIRS:
        _PAIRS[key] = build_pair(causal_config(**seanet))
    return _PAIRS[key]


def _port_stream(layers, modules, x, chunks, flush=False):
    """stream_layers over chunk splits of x (B, C, T); the outputs concatenated."""
    state = tstream.init_stream_state(layers, x.shape[0])
    outs, start = [], 0
    with torch.no_grad():
        for i, L in enumerate(chunks):
            y, state = tstream.stream_layers(layers, modules, state, x[:, :, start:start + L], primed=i > 0,
                                             flush=flush and i == len(chunks) - 1)
            outs.append(y)
            start += L
    assert start == x.shape[2]
    return torch.cat(outs, dim=2).numpy()


def _jax_stream(layers, params, x, chunks, flush=False):
    """The same over JAX's stream_layers, (B, T, C), each chunk jitted."""
    state = jstream.init_stream_state(layers, x.shape[0])
    outs, start = [], 0
    for i, L in enumerate(chunks):
        last = flush and i == len(chunks) - 1
        fn = jax.jit(lambda p, st, seg, primed=i > 0, last=last: jstream.stream_layers(
            layers, p, st, seg, primed=primed, flush=last))
        y, state = fn(params, state, x[:, start:start + L])
        outs.append(np.asarray(y))
        start += L
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("chunks,pad_mode", [
    ((2240, 640, 640, 640), "reflect"),  # the first chunk covers the deepest receptive field + 1
    ((2560, 320, 320), "reflect"),
    ((320, 320, 1600, 320), "constant"),  # no first-chunk minimum
])
def test_encoder_stream_matches_full(chunks, pad_mode):
    p = pair_for(pad_mode=pad_mode)
    x = np.random.RandomState(0).randn(2, sum(chunks)).astype(np.float32)
    enc = p.tm.encoder
    with torch.no_grad():
        full = enc(torch.from_numpy(x)).numpy()  # (B, T', D)
    streamed = _port_stream(enc.layers, list(enc.model), torch.from_numpy(x)[:, None], chunks).transpose(0, 2, 1)
    assert streamed.shape == full.shape
    np.testing.assert_allclose(streamed, full, rtol=0, atol=ENC_ATOL)
    j_streamed = _jax_stream(p.jm.encoder.layers, p.params["encoder"], jnp.asarray(x[:, :, None]), chunks)
    np.testing.assert_allclose(streamed, j_streamed, rtol=0, atol=ENC_ATOL)


def test_encoder_stream_snake_true_skip():
    p = pair_for(add_snake_activation=True, true_skip=True, n_residual_layers=2, seq_model="none",
                 pad_mode="constant")
    chunks = (320 * 7, 320 * 2, 320 * 3)
    x = np.random.RandomState(1).randn(1, sum(chunks)).astype(np.float32)
    enc = p.tm.encoder
    with torch.no_grad():
        full = enc(torch.from_numpy(x)).numpy()
    streamed = _port_stream(enc.layers, list(enc.model), torch.from_numpy(x)[:, None], chunks).transpose(0, 2, 1)
    np.testing.assert_allclose(streamed, full, rtol=0, atol=ENC_ATOL)
    j_streamed = _jax_stream(p.jm.encoder.layers, p.params["encoder"], jnp.asarray(x[:, :, None]), chunks)
    np.testing.assert_allclose(streamed, j_streamed, rtol=0, atol=ENC_ATOL)


@pytest.mark.parametrize("trim_right_ratio", [1.0, 0.5, 0.0])
def test_decoder_stream_matches_full(trim_right_ratio):
    p = pair_for(trim_right_ratio=trim_right_ratio)
    z = np.random.RandomState(2).randn(2, 24, 16).astype(np.float32)  # (B, frames, D)
    chunks = (8, 8, 4, 4)
    dec = p.tm.decoder
    with torch.no_grad():
        full = dec(torch.from_numpy(z)).numpy()  # (B, T, 1)
    streamed = _port_stream(dec.layers, list(dec.model), torch.from_numpy(z).transpose(1, 2), chunks,
                            flush=True).transpose(0, 2, 1)
    assert streamed.shape == full.shape, (streamed.shape, full.shape)
    np.testing.assert_allclose(streamed, full, rtol=0, atol=DEC_ATOL)
    j_streamed = _jax_stream(p.jm.decoder.layers, p.params["decoder"], jnp.asarray(z), chunks, flush=True)
    np.testing.assert_allclose(streamed, j_streamed, rtol=0, atol=DEC_ATOL)


def test_decoder_empty_input_flush_cascade():
    """A zero-length flush (the session's flush()): the held-back transposed-conv
    tails cascade through the layers below, and the concatenation equals the
    whole-utterance output (trim 0.5)."""
    p = pair_for(trim_right_ratio=0.5)
    dec = p.tm.decoder
    z = torch.from_numpy(np.random.RandomState(9).randn(1, 16, 16).astype(np.float32))
    with torch.no_grad():
        full = dec(z).numpy()
        zt = z.transpose(1, 2)
        state = tstream.init_stream_state(dec.layers, 1)
        outs = []
        for i, (lo, hi) in enumerate([(0, 8), (8, 16)]):
            y, state = tstream.stream_layers(dec.layers, list(dec.model), state, zt[:, :, lo:hi], primed=i > 0)
            outs.append(y)
        tail, _ = tstream.stream_layers(dec.layers, list(dec.model), state, torch.zeros(1, 16, 0), primed=True,
                                        flush=True)
        assert tail.shape[2] > 0
        outs.append(tail)
    streamed = torch.cat(outs, dim=2).numpy().transpose(0, 2, 1)
    assert streamed.shape == full.shape
    np.testing.assert_allclose(streamed, full, rtol=0, atol=DEC_ATOL)


def test_session_end_to_end_token_and_sample_parity():
    p = pair_for()
    wav = (0.1 * np.random.RandomState(4).randn(2, 320 * 20)).astype(np.float32)
    with torch.no_grad():
        out = p.tm.inference_encoding(torch.from_numpy(wav), need_recon=True, use_scale=False)
    full_tokens, full_recon = out["code_indices"][0].numpy(), out["recon_speech"].numpy()

    sess = tstream.StreamingCodecSession(p.tm, batch=2)
    jsess = jstream.StreamingCodecSession(p.jm, p.params, p.state, batch=2)
    toks, wavs, j_toks, j_wavs = [], [], [], []
    for lo, hi in ((0, 8), (8, 12), (12, 20)):
        chunk = wav[:, lo * 320:hi * 320]
        t = sess.encode_chunk(torch.from_numpy(chunk))
        toks.append(t.numpy())
        wavs.append(sess.decode_chunk(t).numpy())
        jt = jsess.encode_chunk(jnp.asarray(chunk))
        j_toks.append(np.asarray(jt))
        j_wavs.append(np.asarray(jsess.decode_chunk(jt)))
    tail, j_tail = sess.flush(), jsess.flush()
    assert (tail is None) == (j_tail is None)
    streamed_tokens = np.concatenate(toks, axis=2)
    streamed = np.concatenate(wavs, axis=1)
    np.testing.assert_array_equal(streamed_tokens, full_tokens)
    np.testing.assert_array_equal(streamed_tokens, np.concatenate(j_toks, axis=2))
    assert streamed.shape == full_recon.shape
    np.testing.assert_allclose(streamed, full_recon, rtol=0, atol=DEC_ATOL)
    np.testing.assert_allclose(streamed, np.concatenate(j_wavs, axis=1), rtol=0, atol=DEC_ATOL)


def test_session_n_q_and_bandwidth():
    p = pair_for()
    wav = torch.from_numpy((0.1 * np.random.RandomState(5).randn(1, 320 * 8)).astype(np.float32))
    full = tstream.StreamingCodecSession(p.tm).encode_chunk(wav)
    two = tstream.StreamingCodecSession(p.tm, n_q=2).encode_chunk(wav)
    assert two.shape == (2, 1, 8) and torch.equal(two, full[:2])
    assert tstream.StreamingCodecSession(p.tm, bandwidth=None).n_q == 4


@pytest.mark.parametrize("seanet", [{}, {"pad_mode": "constant"}, {"pad_mode": "replicate"},
                                    {"add_snake_activation": True, "true_skip": True, "n_residual_layers": 2}],
                         ids=["reflect", "constant", "replicate", "snake_true_skip"])
def test_min_first_chunk_matches_jax(seanet):
    p = pair_for(**seanet)
    for t_layers, j_layers in ((p.tm.encoder.layers, p.jm.encoder.layers),
                               (p.tm.decoder.layers, p.jm.decoder.layers)):
        assert tstream.min_first_chunk(t_layers) == jstream.min_first_chunk(j_layers)


def test_session_guards():
    p = pair_for()
    # the bottleneck conv k=7 (pt 6, reflect: 7 samples) at hop 320 dominates
    assert tstream.min_first_chunk(p.tm.encoder.layers) == 7 * 320
    assert tstream.min_first_chunk(pair_for(pad_mode="constant").tm.encoder.layers) == 0
    sess = tstream.StreamingCodecSession(p.tm, batch=1)
    with pytest.raises(ValueError, match="multiple of hop"):
        sess.encode_chunk(torch.zeros(1, 321))
    with pytest.raises(ValueError, match="first chunk"):
        sess.encode_chunk(torch.zeros(1, 320))
    with pytest.raises(ValueError, match="first chunk"):
        sess.decode_chunk(torch.zeros(4, 1, 2, dtype=torch.long))
    assert sess.flush() is None  # nothing decoded yet

    from funcodec_tpu_torch.tasks.codec import build_codec_model

    def port(**kw):
        cfg = causal_config(**{k: v for k, v in kw.items() if k != "audio_normalize"})
        if "audio_normalize" in kw:
            cfg["model_conf"]["audio_normalize"] = kw["audio_normalize"]
        return build_codec_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))[0]

    with pytest.raises(ValueError, match="causal"):
        tstream.StreamingCodecSession(port(causal=False))
    with pytest.raises(ValueError, match="time_group_norm"):
        tstream.StreamingCodecSession(port(norm="time_group_norm"))
    with pytest.raises(NotImplementedError, match="transformer"):
        tstream.StreamingCodecSession(port(seq_model="transformer"))
    with pytest.raises(ValueError, match="audio_normalize"):
        tstream.StreamingCodecSession(port(audio_normalize=True))


def test_apply_slstm_streaming_matches_jax():
    """Chunks through the LSTM with threaded (h, c) carries equal the whole
    sequence, in both packages, and the packages agree."""
    rs = np.random.RandomState(3)
    lstm = trnn.SLSTM(12, 2, True, device="cpu", generator=torch.Generator().manual_seed(0)).lstm
    params = [{"w_ih": getattr(lstm, f"weight_ih_l{k}").detach().numpy().T,
               "w_hh": getattr(lstm, f"weight_hh_l{k}").detach().numpy().T,
               "b_ih": getattr(lstm, f"bias_ih_l{k}").detach().numpy(),
               "b_hh": getattr(lstm, f"bias_hh_l{k}").detach().numpy()} for k in range(2)]
    x = rs.randn(3, 12, 20).astype(np.float32)  # (B, C, T)
    with torch.no_grad():
        whole = trnn.apply_slstm(lstm, torch.from_numpy(x)).numpy()
        carries = [(torch.zeros(3, 12), torch.zeros(3, 12)) for _ in range(2)]
        outs = []
        for lo, hi in ((0, 7), (7, 8), (8, 20)):
            y, carries = trnn.apply_slstm_streaming(lstm, torch.from_numpy(x[:, :, lo:hi]), carries)
            outs.append(y.numpy())
    streamed = np.concatenate(outs, axis=2)
    np.testing.assert_allclose(streamed, whole, rtol=0, atol=1e-5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jc = [(jnp.zeros((3, 12)), jnp.zeros((3, 12))) for _ in range(2)]
    j_outs = []
    for lo, hi in ((0, 7), (7, 8), (8, 20)):
        y, jc = jrnn.apply_slstm_streaming(jp, jnp.asarray(x[:, :, lo:hi].transpose(0, 2, 1)), jc)
        j_outs.append(np.asarray(y))
    np.testing.assert_allclose(streamed, np.concatenate(j_outs, axis=1).transpose(0, 2, 1), rtol=0, atol=1e-5)
    for (h, c), (jh, jcc) in zip(carries, jc):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
        np.testing.assert_allclose(c.numpy(), np.asarray(jcc), rtol=0, atol=1e-5)
