"""The port's Laura training loss against funcodec_tpu/models/laura.py, on the
CPU, fp32, for the LM's pe_type uni and split.

Both packages build the tiny model of tests/test_torch_laura.py from one
config dict (with a 10-token list); the JAX parameters are seeded numpy
values carried into the port. Batches are padded as the trainers pad them
(collate with -1, ``bucket_batch`` to multiples of 32 with 0, codec clamped
at 0). Draws differ between jax.random and torch, so parity holds without
draws (sampling ratio 0 or 1, no SpecAug) or with JAX's draws fed in: the
sampler's uniforms (``prob_sampler(uniform=...)``) and the SpecAug spans
(``_aug_segment(spans=...)``), recomputed from the JAX key chain.

Tolerances: values within 1e-5 (fp32, summation order); each trainable
parameter's gradient within 1e-4 relative L2 of jax.grad's, but the
attention key biases', which are 0 in exact arithmetic (the softmax is
invariant to a shift per query): both packages' are held under 1e-8 of the
whole gradient's norm.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from funcodec_tpu_torch.compat.from_jax import laura_state_dict_from_jax
from funcodec_tpu_torch.train.laura_trainer import bucket_batch
from test_torch_augment import jax_spans
from test_torch_laura import BINS, DIM, NQ, laura_pair, tiny_config

torch.set_num_threads(1)

ATOL = 1e-5
GRAD_REL = 1e-4
TOKENS = [f"t{i}" for i in range(10)]
IN_AUG = {"apply_time_warp": True, "time_warp_window": 5, "freq_mask_width_range": [0, 4], "num_freq_mask": 2,
          "time_mask_width_ratio_range": [0.0, 0.2], "num_time_mask": 2}
OUT_AUG = {"freq_mask_width_range": [1, 3], "num_freq_mask": 1, "time_mask_width_range": [1, 4],
           "num_time_mask": 2}
STATS = ("loss", "nll_loss", "reg_loss", "reg_l1_loss", "reg_l2_loss", "out_acc_1", "out_acc_2")


def config(pe, lsm=0.0, ratio=0.0, aug=False):
    cfg = tiny_config(pe)
    cfg["model_conf"].update(lsm_weight=lsm, codec_sampling_ratio=ratio)
    if aug:
        cfg["model_conf"]["codec_lm_conf"].update(input_aug_conf=dict(IN_AUG), output_aug_conf=dict(OUT_AUG),
                                                  input_normalize=True)
    return cfg


def make_batch(seed, B=3):
    """A collated batch as the trainers hand it to the model."""
    rs = np.random.RandomState(seed)
    tl = rs.randint(3, 10, B)
    cl = rs.randint(4, 13, B)
    tl[0], cl[1] = 10, 13
    text = np.full((B, tl.max()), -1, np.int64)
    codec = np.full((B, cl.max(), NQ), -1, np.int64)
    for b in range(B):
        text[b, : tl[b]] = rs.randint(0, len(TOKENS), tl[b])
        codec[b, : cl[b]] = rs.randint(0, BINS, (cl[b], NQ))
    out = bucket_batch(dict(text=text, text_lengths=tl, codec=codec, codec_lengths=cl))
    out["codec"] = np.maximum(out["codec"], 0)
    return out


def port(batch):
    return tuple(torch.from_numpy(batch[k]) for k in ("text", "text_lengths", "codec", "codec_lengths"))


def jnp_batch(batch):
    return tuple(jnp.asarray(batch[k]) for k in ("text", "text_lengths", "codec", "codec_lengths"))


def close(ours, ref, what, atol=ATOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=atol, rtol=0, err_msg=what)


@functools.lru_cache(maxsize=None)
def pair(pe, lsm=0.0, ratio=0.0, aug=False):
    return laura_pair(config(pe, lsm, ratio, aug), token_list=TOKENS, seed=3)


def jax_forward_and_nll(jm):
    """(loss, stats, nll outputs, grads) of the JAX model, jitted once."""

    def fn(params, text, tl, codec, cl, key):
        (loss, stats), grads = jax.value_and_grad(lambda p: jm.forward(p, text, tl, codec, cl, key), has_aux=True)(
            params)
        h, tl2 = jm.encode_text(params, text, tl)
        nll = jm.nll(params, h, tl2, codec[:, :, : jm.cfg.predict_nq], cl)
        return loss, stats, nll, grads

    return jax.jit(fn)


@pytest.fixture(scope="module", params=[("uni", 0.1, 0.0), ("uni", 0.0, 1.0), ("split", 0.1, 0.0),
                                        ("split", 0.0, 1.0)], ids=lambda p: f"{p[0]}-lsm{p[1]}-ratio{p[2]}")
def case(request):
    """The JAX references of one (pe_type, lsm_weight, sampling ratio): no draws."""
    pe, lsm, ratio = request.param
    jm, params, tm = pair(pe, lsm, ratio)
    batch = make_batch(7)
    ref = jax_forward_and_nll(jm)(params, *jnp_batch(batch), jax.random.PRNGKey(0))
    return jm, params, tm, batch, jax.tree_util.tree_map(np.asarray, ref)


def test_nll_matches_jax(case):
    jm, params, tm, batch, (_, _, ref, _) = case
    text, tl, codec, cl = port(batch)
    with torch.no_grad():
        h, tl2 = tm.encode_text(text, tl)
        ours = tm.nll(h, tl2, codec[:, :, :2], cl)
    for name, a, b in zip(("nll", "logits", "target", "y_lengths"), ours, ref):
        close(a, b, name)


def test_forward_loss_and_stats_match_jax(case):
    jm, params, tm, batch, (loss, stats, _, _) = case
    with torch.no_grad():
        ours, ours_stats = tm(*port(batch), torch.Generator())
    assert set(ours_stats) == set(STATS) == set(stats)
    close(ours, loss, "loss")
    for k in STATS:
        close(ours_stats[k], stats[k], k)


def test_gradients_match_jax_grad(case):
    """Every trainable parameter's gradient within 1e-4 relative L2; the
    frozen codebook gets none (JAX's is zero: stop_gradient)."""
    jm, params, tm, batch, (_, _, _, grads) = case
    tm.zero_grad(set_to_none=True)
    loss, _ = tm(*port(batch), torch.Generator())
    loss.backward()
    ref = laura_state_dict_from_jax(tm, grads)
    assert not np.any(np.asarray(grads["quantizer_codebook"]))
    total = np.sqrt(sum(np.sum(np.square(v.numpy())) for v in ref.values()))
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            assert name == "quantizer_codebook.embed" and p.grad is None
            continue
        g, r = p.grad.numpy(), ref[name].numpy()
        if name.endswith("linear_k.bias"):
            # 0 in exact arithmetic (softmax is invariant to a per-query shift): rounding noise in both
            assert max(np.linalg.norm(g), np.linalg.norm(r)) <= 1e-8 * total, name
            continue
        scale = np.linalg.norm(r)
        assert scale > 1e-6 * total, name
        assert np.linalg.norm(g - r) <= GRAD_REL * scale, (name, np.linalg.norm(g - r) / scale)
    tm.zero_grad(set_to_none=True)


@pytest.mark.parametrize("ratio", [0.0, 1.0, 0.5])
def test_prob_sampler_matches_jax(ratio):
    """Values at the three regimes (0.5 with JAX's uniforms fed in), and the
    straight-through gradient: the softmax's, through the kept predictions."""
    jm, params, tm = pair("uni")
    jm.cfg = dataclasses.replace(jm.cfg, codec_sampling_ratio=ratio)
    tm.cfg = dataclasses.replace(tm.cfg, codec_sampling_ratio=ratio)
    try:
        rs = np.random.RandomState(11)
        B, Lc = 3, 7
        logits = (rs.randn(B, Lc, 2, BINS) * 2).astype(np.float32)
        codec = rs.randint(0, BINS, (B, Lc, 2))
        codec[0, :3] = logits[0, :3].argmax(-1)  # some predictions correct
        cl = np.array([7, 4, 1])
        w = rs.randn(B, Lc, 2, BINS).astype(np.float32)
        key = jax.random.PRNGKey(5)

        def jfn(lg):
            return jm.prob_sampler(params, lg, jnp.asarray(codec), jnp.asarray(cl), key)

        ref, vjp = jax.vjp(jfn, jnp.asarray(logits))
        (ref_grad,) = vjp(jnp.asarray(w))
        u = np.array(jax.random.uniform(key, (B, Lc, 2)))
        lg = torch.from_numpy(logits).requires_grad_(True)
        ours = tm.prob_sampler(lg, torch.from_numpy(codec), torch.from_numpy(cl), None,
                               uniform=torch.from_numpy(u))
        close(ours, ref, "prob")
        if ratio == 1.0:  # the ground truth alone: no gradient reaches the logits
            assert not ours.requires_grad and not np.any(np.asarray(ref_grad))
        else:
            (ours * torch.from_numpy(w)).sum().backward()
            close(lg.grad, ref_grad, "grad")
    finally:
        jm.cfg = dataclasses.replace(jm.cfg, codec_sampling_ratio=0.0)
        tm.cfg = dataclasses.replace(tm.cfg, codec_sampling_ratio=0.0)


def test_prob_sampler_draws_from_the_generator():
    """With no uniforms given, ratio 0.5 draws them from the generator: a
    wrong prediction keeps the ground truth at about half the positions."""
    _, _, tm = pair("uni")
    tm.cfg = dataclasses.replace(tm.cfg, codec_sampling_ratio=0.5)
    try:
        rs = np.random.RandomState(12)
        logits = torch.from_numpy(rs.randn(4, 500, 2, BINS).astype(np.float32))
        codec = (logits.argmax(-1) + 1) % BINS  # every prediction wrong
        prob = tm.prob_sampler(logits, codec, torch.tensor([500] * 4), torch.Generator().manual_seed(0))
        kept_gt = (prob.argmax(-1) == codec).float().mean().item()
        assert 0.45 < kept_gt < 0.55, kept_gt
    finally:
        tm.cfg = dataclasses.replace(tm.cfg, codec_sampling_ratio=0.0)


def test_calc_reg_loss_on_a_bucket_padded_batch():
    """The reference quirk (the mask over the feature axis) included: the
    zero-padded rows of the bucket count in the denominator."""
    jm, _, tm = pair("uni")
    batch = make_batch(8)
    rs = np.random.RandomState(9)
    cl = batch["codec_lengths"].copy()
    cl[2] = 5  # a codec length under codebook_dim: the feature mask bites
    L = batch["codec"].shape[1]
    valid = (np.arange(L)[None, :] < cl[:, None])[..., None]
    pred = (rs.randn(3, L, DIM) * valid).astype(np.float32)
    target = (rs.randn(3, L, DIM) * valid).astype(np.float32)
    ref = jax.jit(jm.calc_reg_loss)(pred, target, cl)
    ours = tm.calc_reg_loss(torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(cl))
    for name, a, b in zip(("loss", "l1", "l2"), ours, ref):
        close(a, b, name, atol=1e-6)


@pytest.mark.parametrize("conf", [IN_AUG, OUT_AUG], ids=["ratio_time_masks", "width_time_masks"])
def test_aug_segment_with_jax_spans(conf):
    """Exactly JAX's masked values given its spans; identity gradients."""
    jm, _, tm = pair("uni")
    rs = np.random.RandomState(13)
    seg = rs.randn(3, 32, DIM).astype(np.float32)
    lengths = np.array([32, 20, 9])
    key = jax.random.PRNGKey(21)
    ref = jax.jit(lambda s: jm._aug_segment(s, jnp.asarray(lengths), conf, key))(seg)
    x = torch.from_numpy(seg).requires_grad_(True)
    spans = tuple(tuple(torch.from_numpy(a) for a in sp) for sp in jax_spans(key, seg.shape, conf))
    ours = tm._aug_segment(x, torch.from_numpy(lengths), conf, None, spans=spans)
    np.testing.assert_array_equal(ours.detach().numpy(), np.asarray(ref))
    assert (ours.detach().numpy() != seg).any(), "the spans masked nothing"
    w = torch.from_numpy(rs.randn(*seg.shape).astype(np.float32))
    (ours * w).sum().backward()
    assert torch.equal(x.grad, w)


def test_forward_with_augmentation_and_sampling_matches_jax(monkeypatch):
    """Input and output SpecAug, the input MVN and ratio 0.5, with JAX's
    draws replayed from its key chain: the loss and every stat."""
    jm, params, tm = pair("uni", 0.1, 0.5, aug=True)
    batch = make_batch(10)
    key = jax.random.PRNGKey(31)
    loss, stats = jax.jit(jm.forward)(params, *jnp_batch(batch), key)
    aug_key, k = jax.random.split(key)
    s_key, _ = jax.random.split(k)
    k_in, k_out = jax.random.split(aug_key)
    B, Lt, Lc = batch["text"].shape[0], batch["text"].shape[1], batch["codec"].shape[1]
    spans = [jax_spans(k_in, (B, Lt, DIM), IN_AUG), jax_spans(k_out, (B, Lc, DIM), OUT_AUG)]
    u = torch.from_numpy(np.array(jax.random.uniform(s_key, (B, Lc, 2))))
    calls = []
    orig_aug, orig_sampler = tm._aug_segment, tm.prob_sampler

    def aug(seg, lengths, conf, gen, spans_=None, group=None):
        sp = spans[len(calls)]
        calls.append(conf)
        return orig_aug(seg, lengths, conf, gen, spans=tuple(tuple(torch.from_numpy(a) for a in s) for s in sp),
                        group=group)

    monkeypatch.setattr(tm, "_aug_segment", aug)
    monkeypatch.setattr(tm, "prob_sampler", functools.partial(orig_sampler, uniform=u))
    with torch.no_grad():
        ours, ours_stats = tm(*port(batch), torch.Generator())
    assert calls == [IN_AUG, OUT_AUG]
    close(ours, loss, "loss")
    for k in STATS:
        close(ours_stats[k], stats[k], k)


def test_held_out_token_nll_matches_jax():
    from funcodec_tpu.utils.tts_quality import held_out_token_nll as jax_nll
    from funcodec_tpu_torch.utils.tts_quality import held_out_token_nll

    jm, params, tm = pair("split", 0.1)
    batches = [make_batch(16), make_batch(17, B=2)]
    ref = jax_nll(jm, params, batches)
    ours = held_out_token_nll(tm, batches)
    assert ours["n_tokens"] == ref["n_tokens"]
    np.testing.assert_allclose(ours["token_nll"], ref["token_nll"], rtol=1e-6)
    np.testing.assert_allclose(ours["token_ppl"], ref["token_ppl"], rtol=1e-5)
