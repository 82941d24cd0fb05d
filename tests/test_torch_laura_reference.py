"""The port's LauraTTS serving path against the benchmark's plain reference
(benchmark/reference/laura.py), on the CPU in float32.

A small LauraTTS of the recipe's topology (conformer text and codec
encoders with rel-pos attention, no conv module; a 2-layer rel-pos uni-PE
codec LM predicting 2 groups) at widths of 16, over a small EnCodec (4 x 32
codebooks of 16 dims, the codebooks grafted into the LM), seeded weights
from the reference's parameter lists, served through
``Text2Audio.start_serving`` / ``submit`` / ``poll``.

Tolerances, fp32: logits within 1e-4 relative L2 a step (the same
arithmetic in another order: a cached step against a full forward, ~1e-7
here); the synthesis's PCM16 within 1e-3 relative L2 of the reference's
(rounding to integers at this small amplitude: ~1e-4); the NAR embedding of
a request's frames the same (within 1e-6) whatever its padding.
"""

import numpy as np
import pytest
import torch

from benchmark.harness import weights
from benchmark.reference import codec as ref
from benchmark.reference import laura as lref
from funcodec_tpu_torch.cli.codec_inference import Speech2Token
from funcodec_tpu_torch.cli.text2audio_inference import Text2Audio
from funcodec_tpu_torch.ops import conv
from funcodec_tpu_torch.quant import rvq

torch.set_num_threads(1)

SEED, SLOTS, TOP_K = 2**40 + 23, 3, 5
LOGIT_TOL, PCM_TOL = 1e-4, 1e-3
CODEBOOK = "quantizer.rq.model.embed"


def codec_config() -> dict:
    seanet = {"ratios": [4, 2], "norm": "time_group_norm", "causal": False, "n_filters": 2}
    return {
        "input_size": 1, "sampling_rate": 16000,
        "encoder": "encodec_seanet_encoder", "encoder_conf": dict(seanet),
        "quantizer": "costume_quantizer",
        "quantizer_conf": {"codebook_size": 32, "num_quantizers": 4, "ema_decay": 0.99, "kmeans_init": False,
                           "sampling_rate": 16000, "encoder_hop_length": 8},
        "decoder": "encodec_seanet_decoder", "decoder_conf": dict(seanet),
        "model": "encodec", "model_conf": {"odim": 16, "audio_normalize": True, "segment_dur": None},
    }


def laura_config() -> dict:
    enc = dict(output_size=16, attention_heads=2, linear_units=24, num_blocks=1, input_layer="linear",
               pos_enc_layer_type="rel_pos", use_cnn_module=False, normalize_before=True)
    return {
        "input_size": 24, "codec_token_rate": 25, "audio_max_duration": 2,
        "text_encoder": "conformer", "text_encoder_conf": dict(enc),
        "codec_encoder": "conformer", "codec_encoder_conf": dict(enc),
        "model": "laura_gen_model",
        "model_conf": {"predict_nq": 2, "codec_conf": {"num_quantizers": 4, "codebook_size": 32, "codebook_dim": 16},
                       "codec_lm_conf": {"name": "transformer", "pos_enc": "rel_pos", "embed_unit": 16,
                                         "att_unit": 16, "head": 2, "unit": 24, "layer": 2, "pe_type": "uni"}},
    }


TOKENS = [f"p{i}" for i in range(11)]


@pytest.fixture(scope="module")
def setup():
    """(reference model, reference codec, LM and codec state dicts, fp32 Text2Audio)."""
    m = lref.Laura.from_config(laura_config(), len(TOKENS))
    codec = ref.Codec.from_config(codec_config())
    specs = codec.param_specs() + [(f"lm.{n}", s, law, b) for n, s, law, b in m.param_specs(CODEBOOK)]
    sd_lm, sd_codec = lref.state_dicts(weights.draw(specs, SEED, "cpu", {}))
    t2a = Text2Audio(laura_config(), None, codec_config(), None, token_list=TOKENS, sampling=TOP_K, device="cpu")
    t2a.model.load_state_dict(sd_lm, strict=True)
    t2a.codec.model.load_state_dict(sd_codec, strict=True)
    return m, codec, sd_lm, sd_codec, t2a


@pytest.fixture(autouse=True)
def plain(monkeypatch):
    """The kernel switches off (another test may have set them): the CPU runs the plain path."""
    for module, flag in ((rvq, "FUSED_RVQ"), (conv, "FUSED_STRIDE1"), (conv, "FUSED_RESBLOCK")):
        monkeypatch.setattr(module, flag, False)


def _requests(n, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, len(TOKENS), int(rs.randint(3, 9))).astype(np.int64), int(rs.randint(6, 15)),
             int(rs.randint(0, 1 << 62))) for _ in range(n)]


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_cached_decode_with_slot_reuse_matches_the_full_forward(setup):
    """Two waves of requests through SLOTS slots: the second admitted over
    the first's stale rows, every row teacher-forced with its own groups;
    each step's logits against the reference's full forward."""
    m, _, sd_lm, _, t2a = setup
    sess = t2a.start_serving(SLOTS, max_length=16, prefix_budget=12)
    rs = np.random.RandomState(3)
    worst = 0.0
    for wave in range(2):
        reqs = _requests(SLOTS, seed=10 + wave)
        forced = torch.as_tensor(rs.randint(0, 32, (SLOTS, 16, 2)))
        sess._slot_uid = [None] * SLOTS
        for i, (ids, _, seed) in enumerate(reqs):
            sess.submit(f"w{wave}r{i}", ids, seed)
        sess._admit_ready()
        got = [sess.logits.clone()]
        with torch.inference_mode():
            for t in range(15):
                logits, sess.cache = t2a.model.lm_step(sess.cache, forced[:, t], None, sess.valid_key[:, None, :],
                                                       sess._rel_proj, sess.max_new,
                                                       write_mask=torch.ones(SLOTS, dtype=torch.bool))
                got.append(logits.float())
        got = torch.stack(got, 1)
        for i, (ids, _, _) in enumerate(reqs):
            want = lref.lm_logits(m, sd_lm, lref.encode_text(m, sd_lm, torch.as_tensor(ids)), forced[i])[:16]
            worst = max(worst, float(lref.relative_rows(got[i], want).max()))
    assert worst < LOGIT_TOL


def test_served_draws_match_the_reference_draws(setup):
    """Requests of several caps served through the session (top-k 5, a seed
    each; rows finish at different steps): the served groups are the ones the
    reference draws from its own logits with the same uniforms."""
    m, _, sd_lm, _, t2a = setup
    t2a.start_serving(SLOTS, max_length=16, prefix_budget=12, segment_steps=4)
    reqs = _requests(7, seed=4)
    for i, (ids, cap, seed) in enumerate(reqs):
        t2a.submit(f"r{i}", ids, seed=seed, cap=cap)
    served = {}
    while t2a.serving_busy:
        served.update(t2a.poll())
    assert t2a.stats["synthesized"] == t2a.stats["admitted"] == len(reqs)
    for i, (ids, cap, seed) in enumerate(reqs):
        tokens = torch.as_tensor(served[f"r{i}"]["tokens"], dtype=torch.int64)
        logits = lref.lm_logits(m, sd_lm, lref.encode_text(m, sd_lm, torch.as_tensor(ids)), tokens)
        want = lref.draws(m, logits, seed, TOP_K)
        n = int(tokens.shape[0])
        if n < cap:  # ended at eos: the reference draws eos in some group there
            assert (want[n] == m.eos).any()
        assert torch.equal(want[:n], tokens)


@pytest.mark.parametrize("slots", [1, SLOTS])
def test_bucketed_synthesis_matches_the_reference(setup, slots):
    """gen through poll (the requests that finish at one tick synthesised
    together, each wrap-padded to the decode length the service states)
    against the reference's synthesis of the served groups at that length."""
    m, codec, sd_lm, sd_codec, t2a = setup
    t2a.start_serving(slots, max_length=16, prefix_budget=12)
    assert t2a.synth_frames == 16
    reqs = _requests(3, seed=5)
    for i, (ids, cap, seed) in enumerate(reqs):
        t2a.submit(f"r{i}", ids, seed=seed, cap=cap)
    served = {}
    while t2a.serving_busy:
        served.update(t2a.poll())
    for i, (ids, _, _) in enumerate(reqs):
        out = served[f"r{i}"]
        tokens = torch.as_tensor(out["tokens"], dtype=torch.int64)
        want = lref.synthesize(m, codec, sd_lm, sd_codec, torch.as_tensor(ids), tokens, t2a.synth_frames)
        assert out["gen"].shape == (tokens.shape[0] * 8,) and set(out) == {"tokens", "gen"}
        got = torch.from_numpy(out["gen"])
        scale = lambda w: ref.pcm16_float(w[None], torch.tensor([w.shape[0]]))[0]  # noqa: E731
        assert _rel(torch.round(scale(got)), scale(want)) < PCM_TOL


def test_nar_embedding_does_not_depend_on_the_padding(setup):
    """The NAR stage's embedding of a request's frames is the same with its
    text and frames padded (the padding masked), and beside a longer row in
    one batch, as alone and unpadded."""
    _, _, _, _, t2a = setup
    model = t2a.model
    rs = np.random.RandomState(6)
    ids = [rs.randint(0, len(TOKENS), n) for n in (5, 8)]
    tokens = [rs.randint(0, 32, (n, 2)) for n in (9, 13)]
    with torch.inference_mode():
        alone = [model.dense_embedding(torch.as_tensor(t[None]), torch.tensor([len(t)]), torch.as_tensor(i[None]),
                                       torch.tensor([len(i)])) for i, t in zip(ids, tokens)]
        text = torch.full((2, 16), -1, dtype=torch.int64)
        codec = torch.as_tensor(rs.randint(0, 32, (2, 16, 2)))  # the padding's groups are noise
        for r, (i, t) in enumerate(zip(ids, tokens)):
            text[r, : len(i)] = torch.as_tensor(i)
            codec[r, : len(t)] = torch.as_tensor(t)
        both = model.dense_embedding(codec, torch.tensor([9, 13]), text, torch.tensor([5, 8]))
    assert both.shape == (2, 16, 16)
    for r, n in enumerate((9, 13)):
        assert torch.equal(both[r, n:], torch.zeros(16 - n, 16))
        torch.testing.assert_close(both[r: r + 1, :n], alone[r], rtol=0, atol=1e-6)


def test_decode_modes_fp32_unchanged_and_bf16_decodes_in_bf16(setup, monkeypatch):
    """fp32: decode and decode_emb return exactly the model's own decode of
    the codewords / embeddings (the cast is a no-op). bf16: the decoder
    receives bf16 codewords and embeddings."""
    *_, sd_codec, _ = setup
    s_fp = Speech2Token(codec_config(), None, dtype="float32", bit_width=None, device="cpu")
    s_fp.model.load_state_dict(sd_codec)
    rs = np.random.RandomState(9)
    toks = rs.randint(0, 32, (2, 6, 4))
    emb = rs.randn(2, 6, 16).astype(np.float32)
    with torch.inference_mode():
        want_dec = s_fp.model.inference_decoding(torch.as_tensor(toks))["recon_speech"].numpy()
        want_emb = s_fp.model.inference_decoding_emb(torch.as_tensor(emb))["recon_speech"].numpy()
    np.testing.assert_array_equal(s_fp(toks, run_mod="decode", bit_width=None)[2], want_dec)
    np.testing.assert_array_equal(s_fp(emb, run_mod="decode_emb")[2], want_emb)
    s_bf = Speech2Token(codec_config(), None, dtype="bfloat16", bit_width=None, device="cpu")
    seen = []
    decode = s_bf.model._decode
    monkeypatch.setattr(s_bf.model, "_decode", lambda frames: seen.append(frames[0][0].dtype) or decode(frames))
    s_bf(toks, run_mod="decode", bit_width=None)
    s_bf(emb, run_mod="decode_emb")
    assert seen == [torch.bfloat16, torch.bfloat16]
