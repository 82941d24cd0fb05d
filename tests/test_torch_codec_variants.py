"""The port's other quantizers and codec models against funcodec_tpu, on the CPU.

- ResidualQuantizer: the cases of tests/test_residual_quantizer.py (the
  forward contract, commitment scaling, the dropout depth multiset, the
  registry) and, on weights carried from JAX, its training forward's
  output, indices and commit loss (atol 1e-6; the effective expiry's fresh
  rows are draws, which touch only the new state) and its encode /
  inference / decode (tokens equal, values atol 1e-6); a GAN step through
  the same train step as costume_quantizer.
- IdentityQuantizer: the pass-through, decode raising, and a GAN step with
  its empty codebook state (the generator turn's loss and stats against
  JAX's at rtol 1e-4; checkpoint save and resume); cli/codec_train with it
  at world 2 (gloo ranks) and resumed at world 1.
- The context loss (tests/test_context_loss.py's three variants): loss and
  pred_acc with JAX's spans fed in, fp32, rtol 1e-5; one shared GAN step
  (SGD, lr 1e-3) with the masked-prediction transformer against JAX's
  jitted step: stats at rtol 2e-4 / atol 2e-5, and every generator
  parameter after the step within 2e-4 lr of JAX's plus 2e-3 of the
  tensor's largest move (SGD moves a parameter by lr x its gradient, so
  this holds the gradients to JAX's as tests/test_torch_gan_step.py does).
- CodecSemanticAug in its five ppg modes: forward_generator_ppg's loss and
  stats within rtol 1e-5 (atol 1e-6), inference_ppg's tokens equal and
  reconstruction within 1e-5.
- build_codec_model for every new name: the same parameter count as JAX's
  and the JAX weights carried by compat/from_jax (strict load).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from funcodec_tpu.models.quantizer import ResidualQuantizer as JRQ
from funcodec_tpu.train import step as jstep
from funcodec_tpu_torch.models.quantizer import IdentityQuantizer, ResidualQuantizer
from funcodec_tpu_torch.tasks.codec import build_quantizer
from funcodec_tpu_torch.train import step as tstep
from tests.test_torch_gan_step import LR, assert_stats_close, build_pair, config, np_tree, speech

torch.set_num_threads(1)


def _rq_pair(seed=0, **kw):
    """A ResidualQuantizer in both packages with JAX's (uniform) codebooks."""
    kw = dict(dict(input_size=16, codebook_size=32, num_quantizers=4, kmeans_init=False), **kw)
    jrq = JRQ(**kw)
    params, state = jrq.init(jax.random.PRNGKey(seed))
    trq = ResidualQuantizer(**kw, device="cpu", generator=torch.Generator().manual_seed(seed))
    trq.load_state_dict({f"rq.model.{k}": torch.from_numpy(np.array(getattr(state, k))) for k in
                         ("inited", "cluster_size", "embed", "embed_avg")})
    return jrq, params, state, trq


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# ResidualQuantizer
# ---------------------------------------------------------------------------


def test_residual_quantizer_forward_contract_matches_jax():
    """tests/test_residual_quantizer.py:16 on the port, and the values of JAX's."""
    jrq, params, state, trq = _rq_pair()
    x = _x((2, 10, 16))
    q, idx, loss, new_state = trq(torch.from_numpy(x), torch.Generator().manual_seed(2))
    assert q.shape == (2, 10, 16) and idx.shape == (2, 10, 4) and loss.shape == ()
    assert trq.output_size() == 16

    def j_modes(xx):
        jq, jidx, jloss, _ = jrq(params, state, xx, jax.random.PRNGKey(2))
        codes = jrq.encode(params, state, xx)
        return jq, jidx, jloss, codes, jrq.inference(params, state, xx)[0], jrq.decode(params, state, codes)

    jq, jidx, jloss, jcodes, jq2, jdec = jax.jit(j_modes)(jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    # the eval modes on the buffers (the new state's expiry is a draw: not committed here)
    codes = trq.encode(torch.from_numpy(x))
    dec = trq.decode(codes)
    q2, idx2, _ = trq.inference(torch.from_numpy(x), bandwidth=1.0)  # the bandwidth is ignored: all layers
    np.testing.assert_allclose(dec.numpy(), q2.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(codes.numpy(), idx2.numpy())
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(q2.numpy(), np.asarray(jq2), atol=1e-6)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=1e-6)
    assert new_state.embed.shape == (4, 32, 16)


def test_residual_quantizer_commitment_weight_scales_loss():
    """tests/test_residual_quantizer.py:37."""
    kw = dict(input_size=8, codebook_size=16, num_quantizers=2, kmeans_init=False)
    x = torch.from_numpy(_x((1, 6, 8)))
    losses = []
    for w in (1.0, 3.0):
        rq = ResidualQuantizer(commitment_weight=w, **kw, device="cpu", generator=torch.Generator().manual_seed(0))
        losses.append(rq(x, torch.Generator().manual_seed(2))[2].item())
    np.testing.assert_allclose(losses[1], 3.0 * losses[0], rtol=1e-6)


@pytest.mark.parametrize("cutoff,multiple,n_q,expect", [
    (1, 1, 4, (2, 3, 4)),
    (2, 1, 4, (3, 4)),
    (1, 2, 8, (2, 4, 4, 6, 6, 8, 8)),
    (3, 4, 8, (4, 8, 8, 8, 8)),
])
def test_residual_quantizer_dropout_depth_set(cutoff, multiple, n_q, expect):
    """tests/test_residual_quantizer.py:61: the multiset of lucidrains'
    randrange(cutoff, n_q) rounded up to multiple_of, as JAX enumerates it;
    a training forward drops the layers past one of them."""
    kw = dict(input_size=8, codebook_size=16, num_quantizers=n_q, quantize_dropout=True,
              quantize_dropout_cutoff_index=cutoff, quantize_dropout_multiple_of=multiple, kmeans_init=False)
    rq = ResidualQuantizer(**kw, device="cpu", generator=torch.Generator().manual_seed(0))
    assert rq.cfg.rand_num_quant == expect == JRQ(**kw).cfg.rand_num_quant
    _, idx, _, _ = rq(torch.from_numpy(_x((1, 6, 8))), torch.Generator().manual_seed(5))
    depth = int((idx[0, 0] >= 0).sum())
    assert depth in expect and bool((idx[..., depth:] == -1).all())


def test_residual_quantizer_from_the_registry():
    """tests/test_residual_quantizer.py:74: build_quantizer's name switch and
    kwarg filter (sync_codebook accepted and ignored, unknown keys dropped)."""
    rq = build_quantizer({"codebook_size": 32, "num_quantizers": 4, "commitment_weight": 2.0, "sync_codebook": True,
                          "kmeans_init": False, "encoder_hop_length": 8}, input_size=16, name="residual_quantizer",
                         device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(rq, ResidualQuantizer) and rq.commitment_weight == 2.0 and rq.cfg.num_quantizers == 4
    assert rq.cfg.expiry_mode == "effective" and rq.cfg.ema_decay == 0.95
    with pytest.raises(ValueError, match="unknown quantizer"):
        build_quantizer({}, 16, "vq_quantizer", device="cpu", generator=torch.Generator())


def _port_step_run(cfg, shared=True, steps=2, optim="adam"):
    p = build_pair(cfg)
    opt_g = tstep.make_optimizer(lr=LR, name=optim)
    opt_d = tstep.make_optimizer(lr=LR, name=optim)
    state = tstep.create_gan_train_state(p.tm, p.tdisc, opt_g, opt_d)
    step = tstep.make_gan_train_step(p.tm, p.tdisc, opt_g, opt_d, shared_forward=shared)
    before = {n: t.detach().clone() for n, t in p.tm.named_parameters()}
    x = {"speech": torch.from_numpy(speech())}
    gen = torch.Generator().manual_seed(7)
    all_stats = []
    for _ in range(steps):
        state, stats = step(state, x, gen)
        all_stats.append({k: float(v) for k, v in stats.items()})
        assert all(np.isfinite(v) for v in all_stats[-1].values()), all_stats[-1]
    moved = {n for n, t in p.tm.named_parameters() if not torch.equal(t, before[n])}
    return p, state, all_stats, moved


def test_residual_quantizer_trains_through_the_gan_step():
    """quantizer: residual_quantizer through make_gan_train_step, as
    costume_quantizer: the codebooks' EMA and effective expiry advance."""
    cfg = config()
    cfg["quantizer"] = "residual_quantizer"
    cfg["quantizer_conf"] = {"codebook_size": 32, "num_quantizers": 4, "kmeans_init": False,
                             "quantize_dropout": True, "commitment_weight": 0.5}
    p, state, stats, moved = _port_step_run(cfg)
    assert isinstance(p.tm.quantizer, ResidualQuantizer)
    assert p.tm.quantizer.cfg.rand_num_quant == (2, 3, 4)
    assert {n for n, _ in p.tm.named_parameters()} - moved <= {"decoder.model.9.conv.conv.bias"}
    assert not torch.equal(state.rvq_state.cluster_size, torch.from_numpy(np.asarray(p.state.cluster_size)))
    assert "rvq_dead_codes" in stats[-1] and stats[-1]["generator_commit_loss"] > 0


# ---------------------------------------------------------------------------
# IdentityQuantizer
# ---------------------------------------------------------------------------


def _identity_config():
    # JAX's identity quantizer inits a one-quantizer RVQ state, which needs kmeans_init without a key
    cfg = config(kmeans_init=True)
    cfg["quantizer"] = "identity_quantizer"
    return cfg


def test_identity_quantizer_passes_through_and_cannot_decode():
    q = IdentityQuantizer(input_size=16, device="cpu")
    x = torch.from_numpy(_x((2, 5, 16)))
    y, idx, commit, subq, state = q.train_forward(x, torch.Generator())
    assert y is x and idx.shape == (1, 2, 5) and idx.dtype == torch.int32 and not idx.any()
    assert float(commit) == 0.0 and subq.shape == (1, 2, 5, 16)
    assert state.embed.shape == (0, 1024, 16) and q.state.embed.numel() == 0
    assert q.inference(x)[0] is x and not q.encode(x).any() and q.n_q_for_bandwidth(6000) == 1
    with pytest.raises(NotImplementedError, match="no codebooks"):
        q.decode(idx)
    assert not hasattr(q, "rvq_cfg")  # no codebook health to report


def test_identity_quantizer_generator_turn_matches_jax():
    """The generator turn (no draws) against JAX's, whose one-quantizer
    codebook state the identity quantizer never reads."""
    p = build_pair(_identity_config())
    x = speech()
    loss, out = p.tm.forward_generator(p.tdisc, torch.from_numpy(x), torch.Generator())
    j_loss, j_out = jax.jit(lambda prm: p.jm.forward_generator(prm, p.disc_params, p.jdisc, p.state,
                                                               jnp.asarray(x), jax.random.PRNGKey(0)))(p.params)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4)
    assert_stats_close(out["stats"], j_out["stats"])
    assert float(out["stats"]["generator_commit_loss"]) == 0.0


def test_identity_quantizer_gan_step_and_resume(tmp_path):
    """Two shared steps with the empty codebook state: every generator
    parameter moves (but the norm-removed bias), no codebook health stats;
    checkpoint.pth saves and restores into a fresh state."""
    from funcodec_tpu_torch.train.checkpoint import load_train_state, save_train_state, train_state_dict

    p, state, stats, moved = _port_step_run(_identity_config())
    assert {n for n, _ in p.tm.named_parameters()} - moved <= {"decoder.model.9.conv.conv.bias"}
    assert not any(k.startswith("rvq_") for k in stats[-1])
    assert state.rvq_state.embed.numel() == 0 and state.step == 2
    save_train_state(str(tmp_path / "checkpoint.pth"), state)
    fresh = build_pair(_identity_config())
    opt = tstep.make_optimizer(lr=LR)
    template = tstep.create_gan_train_state(fresh.tm, fresh.tdisc, opt, opt)
    restored = load_train_state(str(tmp_path / "checkpoint.pth"), template)
    a, b = train_state_dict(restored), train_state_dict(state)
    assert restored.step == 2 and set(a["model"]) == set(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k


# ---------------------------------------------------------------------------
# the context loss
# ---------------------------------------------------------------------------

CONTEXTS = {
    "masked-pred": {"model": "transformer",
                    "model_conf": {"attention_heads": 2, "linear_units": 32, "num_blocks": 1},
                    "mask_conf": {"mask_ratio_range": [0.0, 0.2], "num_mask": 2}, "ce_loss_weight": 1.0},
    "lstm-weighted": {"model": "lstm", "model_conf": {"num_layers": 1},
                      "mask_conf": {"mask_ratio_range": [0.0, 0.2], "num_mask": 2},
                      "ce_loss_weight": 1.0, "mask_pred_weight": 0.7},
    "context-lm": {"model": "transformer",
                   "model_conf": {"attention_heads": 2, "linear_units": 32, "num_blocks": 1},
                   "mask_conf": {"mask_ratio_range": [0.0, 0.2], "num_mask": 2}, "lm_loss_weight": 1.0},
}


def _context_config(name):
    cfg = config()
    cfg["model_conf"] = dict(cfg["model_conf"], context_loss_weight=1.0, context_loss_conf=CONTEXTS[name])
    return cfg


def jax_spans(key, B, L, ratio_range, num_mask):
    """The spans funcodec_tpu's mask_along_axis_variable_max_width draws from `key`."""
    lo = int(ratio_range[0] * L)
    hi = max(int(ratio_range[1] * L), lo + 1)
    k_w, k_s = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.randint(k_w, (B, num_mask), lo, hi))),
            torch.from_numpy(np.array(jax.random.randint(k_s, (B, num_mask), 0, max(L - 1, 1)))))


@pytest.mark.parametrize("name", list(CONTEXTS))
def test_context_loss_matches_jax(name):
    p = build_pair(_context_config(name))
    assert p.tm.context is not None and sum(t.numel() for t in p.tm.context.parameters()) > 0
    B, T, D, bins = 2, 40, 16, 32
    rs = np.random.RandomState(3)
    enc, quant0, codebook = (rs.randn(B, T, D).astype(np.float32), rs.randn(B, T, D).astype(np.float32),
                             rs.randn(bins, D).astype(np.float32))
    idx0 = rs.randint(0, bins, (B, T)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    j_loss, j_acc = jax.jit(lambda prm: p.jm.context.loss(prm, jnp.asarray(enc), jnp.asarray(idx0),
                                                          jnp.asarray(quant0), jnp.asarray(codebook), key))(
        p.params["context"])
    cfg = p.tm.context.cfg
    spans = jax_spans(key, B, T, cfg.mask_ratio_range, cfg.num_mask)
    loss, acc = p.tm.context.loss(torch.from_numpy(enc), torch.from_numpy(idx0), torch.from_numpy(quant0),
                                  torch.from_numpy(codebook), None, spans=spans)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(acc.item(), float(j_acc), rtol=1e-5)
    assert loss.item() > 0
    loss.backward()
    assert max(float(t.grad.abs().max()) for t in p.tm.context.parameters()) > 0


def test_context_loss_gan_step_matches_jax():
    """One shared step with the masked-prediction context loss, SGD, JAX's
    spans fed in (the step's generator key folded as JAX's step folds it)."""
    cfg = _context_config("masked-pred")
    p = build_pair(cfg)
    x = speech()
    rng = jax.random.PRNGKey(7)
    opt_g, opt_d = jstep.make_optimizer(lr=LR, name="sgd"), jstep.make_optimizer(lr=LR, name="sgd")
    j_state = jstep.create_gan_train_state(p.params, p.disc_params, p.state, opt_g, opt_d)
    j_step = jax.jit(jstep.make_gan_train_step(p.jm, p.jdisc, opt_g, opt_d, shared_forward=True))
    j_state, j_stats = j_step(j_state, {"speech": jnp.asarray(x)}, rng)
    g_key = jax.random.split(jax.random.fold_in(rng, 0))[1]
    frames = x.shape[1] // 8
    ctx = p.tm.context
    j_spans = jax_spans(jax.random.fold_in(g_key, 101), x.shape[0], frames, ctx.cfg.mask_ratio_range,
                        ctx.cfg.num_mask)
    inner = ctx.mask
    ctx.mask = lambda xx, generator, spans=None, group=None: inner(xx, generator, spans=j_spans, group=group)
    t_opt_g, t_opt_d = tstep.make_optimizer(lr=LR, name="sgd"), tstep.make_optimizer(lr=LR, name="sgd")
    state = tstep.create_gan_train_state(p.tm, p.tdisc, t_opt_g, t_opt_d)
    step = tstep.make_gan_train_step(p.tm, p.tdisc, t_opt_g, t_opt_d, shared_forward=True)
    before = {n: t.detach().clone() for n, t in p.tm.named_parameters()}
    state, stats = step(state, {"speech": torch.from_numpy(x)}, torch.Generator().manual_seed(7))
    assert float(stats["context_loss"]) > 0 and 0 <= float(stats["context_pred_acc"]) <= 1
    assert set(stats) == set(j_stats)
    assert_stats_close(stats, jax.device_get(j_stats), rtol=2e-4, atol=2e-5)
    want = p.port_params(j_state.params)
    for name, t in state.params.items():
        moved = float(np.abs(np.asarray(want[name]) - before[name].numpy()).max())
        d = float(np.abs(t.detach().numpy() - np.asarray(want[name])).max())
        assert d <= 2e-4 * LR + 2e-3 * moved, (name, d / LR, moved / LR)
    assert any(not torch.equal(t, before[n]) for n, t in state.params.items() if n.startswith("context."))


# ---------------------------------------------------------------------------
# CodecSemanticAug
# ---------------------------------------------------------------------------

MODES = ["residual", "addition", "concat", "supervision", "ptts"]


def _semantic_config(mode):
    cfg = config()
    cfg["model"] = "codec_semantic_aug"
    cfg["model_conf"] = dict(cfg["model_conf"], ppg_conf={"ppg_dim": 12, "ppg_ds_rate": 2, "ppg_usage_mod": mode})
    return cfg


@pytest.mark.parametrize("mode", MODES)
def test_semantic_modes_match_jax(mode):
    """forward_generator_ppg (training quantizer, no draws) and
    inference_ppg with posteriors (their argmax) at twice the codec's rate."""
    p = build_pair(_semantic_config(mode))
    x = speech()
    frames = x.shape[1] // 8
    ppg = np.random.RandomState(4).rand(x.shape[0], frames * 2, 12).astype(np.float32)
    key = jax.random.PRNGKey(2)

    def j_turn(prm):
        loss, out = p.jm.forward_generator_ppg(prm, p.disc_params, p.jdisc, p.state, jnp.asarray(x),
                                               jnp.asarray(ppg), key)
        res = p.jm.inference_ppg(prm, p.state, jnp.asarray(x), jnp.asarray(ppg))
        return loss, out["stats"], res["recon_speech"], res["code_indices"][0]

    j_loss, j_stats, j_recon, j_idx = jax.jit(j_turn)(p.params)
    loss, out = p.tm.forward_generator_ppg(p.tdisc, torch.from_numpy(x), torch.from_numpy(ppg), torch.Generator())
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    assert set(out["stats"]) == set(j_stats)
    assert_stats_close(out["stats"], j_stats, rtol=1e-5)
    if mode == "supervision":
        assert float(out["stats"]["ppg_supervision_loss"]) > 0
    loss.backward()
    # the PPG conditions the decoder, or (supervision) trains the classifier only
    used = p.tm.ppg_classifier if mode == "supervision" else p.tm.ppg_embedding
    assert max(float(t.grad.abs().max()) for t in used.parameters()) > 0
    with torch.no_grad():
        res = p.tm.inference_ppg(torch.from_numpy(x), torch.from_numpy(ppg))
    np.testing.assert_array_equal(res["code_indices"][0].numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(res["recon_speech"].numpy(), np.asarray(j_recon), atol=1e-5)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["residual_quantizer", "identity_quantizer", "codec_semantic_aug-ptts",
                                     "context-lstm"])
def test_build_codec_model_new_names(variant):
    """The JAX package's config builds the same model in the port: equal
    parameter counts, and JAX's weights carried by compat/from_jax load
    strictly (tests/test_torch_gan_step.build_pair)."""
    if variant == "codec_semantic_aug-ptts":
        cfg = _semantic_config("ptts")
    elif variant == "context-lstm":
        cfg = _context_config("lstm-weighted")
    else:
        cfg = _identity_config() if variant == "identity_quantizer" else config()
        cfg["quantizer"] = variant
    p = build_pair(cfg)
    j_count = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(np_tree(p.params)))
    assert sum(t.numel() for t in p.tm.parameters()) == j_count
    sd = p.tm.state_dict()
    if variant == "context-lstm":
        assert sd["context.lstm.weight_ih_l0"].shape == (64, 16)
    if variant == "codec_semantic_aug-ptts":
        np.testing.assert_array_equal(sd["ppg_embedding.weight"].numpy(), np.asarray(p.params["ppg_embedding"]))
        assert "utt_level_proj.weight" in sd and not any(k.startswith("ppg_classifier") for k in sd)


def test_identity_quantizer_through_codec_train_dp_and_resume(tmp_path):
    """cli/codec_train with identity_quantizer at world 2 (gloo ranks on the
    CPU), then resumed at world 1: neither the data-parallel step nor the
    checkpoints assume codebooks."""
    import json

    import yaml

    from funcodec_tpu_torch.cli.codec_train import main
    from funcodec_tpu_torch.data.wav_io import write_wav
    from tests.test_trainer import TINY_CONFIG

    config = dict(TINY_CONFIG, quantizer="identity_quantizer", use_tensorboard=False, batch_size=4,
                  num_iters_per_epoch=1, max_epoch=1, num_workers=1, num_valid_dump_wavs=1)
    rs = np.random.RandomState(0)
    lines = []
    for i in range(4):
        write_wav(tmp_path / f"u{i}.wav", (0.2 * rs.randn(4096)).astype(np.float32), 16000)
        lines.append(f"u{i} {tmp_path / f'u{i}.wav'}")
    (tmp_path / "wav.scp").write_text("\n".join(lines) + "\n")
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config))
    args = ["--config", str(tmp_path / "config.yaml"), "--output_dir", str(tmp_path / "exp"), "--train_wav_scp",
            str(tmp_path / "wav.scp"), "--valid_wav_scp", str(tmp_path / "wav.scp"), "--device", "cpu"]
    assert main(args + ["--data_parallel", "2"]) is None  # spawned the two ranks
    saved = torch.load(tmp_path / "exp" / "checkpoint.pth", weights_only=True)
    assert saved["step"] == 1 and saved["model"]["quantizer.rq.model.embed"].shape == (0, 32, 16)
    trainer, state = main(args + ["--max_epoch", "2"])
    assert state.step == 2 and state.rvq_state.embed.numel() == 0
    stats = json.loads((tmp_path / "exp" / "reporter.json").read_text())["stats"]
    assert set(stats) == {"1", "2"} and not any(k.startswith("rvq_") for k in stats["2"]["train"])
    assert all(np.isfinite(v) for phase in stats["2"].values() for v in phase.values())
