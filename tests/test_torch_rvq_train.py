"""The port's RVQ training forward against funcodec_tpu/quant/rvq, on the CPU.

jax.random and torch.Generator draw different numbers, so the port is held
to JAX where both compute the same function:

- ``rvq_train_forward`` with every codebook initialized, no dropout and
  expiry "reference" or "none" draws nothing: outputs, new state and the
  straight-through gradient, on the port's slow (per-layer) and fast
  (all layers at once) paths, with q0_ds_ratio 1 and 2;
- the k-means iterations (``lloyd``) from the rows JAX's
  ``_sample_vectors`` draws with the key its ``kmeans`` uses;
- one quantizer's effective expiry with the same ``fresh_idx``.

Dropout is held to its invariants. Tolerances: codewords, commits and the
state atol 1e-5 (fp32 sums in another order; the JAX fast-vs-slow test's
own); indices exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import funcodec_tpu.quant.rvq as jrvq
import funcodec_tpu_torch.quant.rvq as trvq

torch.set_num_threads(1)

N_Q, BINS, D = 6, 32, 8


def _cfgs(**kw):
    base = dict(num_quantizers=N_Q, codebook_size=BINS, dim=D, kmeans_init=True, kmeans_iters=5, decay=0.9,
                threshold_ema_dead_code=2.0)
    base.update(kw)
    return jrvq.RVQConfig(**base), trvq.RVQConfig(**base)


def _state(seed=0, n_q=N_Q, bins=BINS):
    rs = np.random.RandomState(seed)
    return dict(
        inited=np.ones(n_q, np.float32),
        cluster_size=(np.abs(rs.randn(n_q, bins)) * 5 + 1).astype(np.float32),
        embed=rs.randn(n_q, bins, D).astype(np.float32),
        embed_avg=rs.randn(n_q, bins, D).astype(np.float32),
    )


def _jstate(st):
    return jrvq.RVQState(**{k: jnp.asarray(v) for k, v in st.items()})


def _tstate(st):
    return trvq.RVQTensors(**{k: torch.from_numpy(v.copy()) for k, v in st.items()})


def _x(seed=1, B=3, T=20):
    return np.random.RandomState(seed).randn(B, T, D).astype(np.float32)


def _loss_weights(seed=2, B=3, T=20):
    return np.random.RandomState(seed).randn(B, T, D).astype(np.float32)


def _port(cfg, st, x, c, slow, n_q=None):
    old = trvq.FORCE_SLOW_SCAN
    trvq.FORCE_SLOW_SCAN = slow
    try:
        xt = torch.from_numpy(x).requires_grad_()
        q, idx, commits, subq, ns = trvq.rvq_train_forward(cfg, _tstate(st), xt, torch.Generator(), n_q=n_q)
        (g,) = torch.autograd.grad((q * torch.from_numpy(c)).sum() + commits.sum(), xt)
    finally:
        trvq.FORCE_SLOW_SCAN = old
    return q, idx, commits, subq, ns, g


@pytest.fixture(scope="module", params=[("reference", 1), ("none", 1), ("reference", 2), ("none", 2)],
                ids=["reference-q0x1", "none-q0x1", "reference-q0x2", "none-q0x2"])
def jax_case(request):
    expiry, q0 = request.param
    jcfg, tcfg = _cfgs(expiry_mode=expiry, q0_ds_ratio=q0)
    st, x, c = _state(), _x(), _loss_weights()

    def f(xv):
        q, idx, commits, subq, ns = jrvq.rvq_train_forward(jcfg, _jstate(st), xv, jax.random.PRNGKey(0))
        return jnp.sum(q * c) + jnp.sum(commits), (q, idx, commits, subq, ns)

    (_, out), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(x))
    return tcfg, st, x, c, out, g


@pytest.mark.parametrize("slow", [False, True], ids=["fast", "slow"])
def test_rvq_train_forward_matches_jax(jax_case, slow):
    tcfg, st, x, c, (jq, jidx, jcommits, jsubq, jns), jg = jax_case
    q, idx, commits, subq, ns, g = _port(tcfg, st, x, c, slow)
    assert idx.dtype == torch.int32 and idx.shape == (N_Q, 3, 20)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(commits.detach().numpy(), np.asarray(jcommits), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(subq.numpy(), np.asarray(jsubq), atol=1e-5)
    for name in trvq.RVQTensors._fields:
        np.testing.assert_allclose(getattr(ns, name).numpy(), np.asarray(getattr(jns, name)), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    # the straight-through gradient and layer 0's commit loss
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=1e-5)


def test_slow_and_fast_paths_give_equal_indices():
    """Every mode, effective expiry and dropout included, with the same draws."""
    for kw in (dict(expiry_mode="effective"), dict(expiry_mode="effective", q0_ds_ratio=2),
               dict(quantize_dropout=True, rand_num_quant=(2, 4, 6))):
        _, cfg = _cfgs(**kw)
        outs = []
        for slow in (False, True):
            old = trvq.FORCE_SLOW_SCAN
            trvq.FORCE_SLOW_SCAN = slow
            try:
                outs.append(trvq.rvq_train_forward(cfg, _tstate(_state()), torch.from_numpy(_x()),
                                                   torch.Generator().manual_seed(5)))
            finally:
                trvq.FORCE_SLOW_SCAN = old
        (qf, idxf, cf, sf, nf), (qs, idxs, cs, ss, ns) = outs
        assert torch.equal(idxf, idxs), kw
        np.testing.assert_allclose(qf.numpy(), qs.numpy(), atol=1e-5)
        np.testing.assert_allclose(cf.numpy(), cs.numpy(), atol=1e-5)
        for a, b in zip(nf, ns):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_lloyd_matches_jax_kmeans_with_the_same_draw():
    rs = np.random.RandomState(3)
    samples = rs.randn(200, D).astype(np.float32)
    key = jax.random.PRNGKey(11)
    j_means, j_bins = jax.jit(lambda s: jrvq.kmeans(key, s, 16, 10))(jnp.asarray(samples))
    start = np.array(jrvq._sample_vectors(key, jnp.asarray(samples), 16))
    means, bins = trvq.lloyd(torch.from_numpy(samples), torch.from_numpy(start), 10)
    np.testing.assert_allclose(means.numpy(), np.asarray(j_means), atol=1e-5)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(j_bins))


def test_kmeans_draws_rows_then_iterates():
    samples = torch.from_numpy(np.random.RandomState(4).randn(50, D).astype(np.float32))
    means, bins = trvq.kmeans(torch.Generator().manual_seed(0), samples, 64, 3)  # fewer rows than clusters
    assert means.shape == (64, D) and float(bins.sum()) == 50
    start = trvq._sample_vectors(torch.Generator().manual_seed(0), samples, 64)
    assert torch.equal(trvq.lloyd(samples, start, 3)[0], means)


def test_effective_expiry_matches_jax_with_the_same_rows():
    jcfg, tcfg = _cfgs(kmeans_init=False, expiry_mode="effective", threshold_ema_dead_code=4.0)
    st = _state()
    residual = np.random.RandomState(6).randn(60, D).astype(np.float32)
    fresh = np.random.RandomState(7).permutation(60)[:BINS].astype(np.int32)
    jout = jax.jit(lambda *a: jrvq._train_one_quantizer(jcfg, *a, jnp.bool_(True), jax.random.PRNGKey(0),
                                                        fresh_idx=jnp.asarray(fresh)))(
        jnp.asarray(residual), jnp.float32(1.0), jnp.asarray(st["cluster_size"][0]), jnp.asarray(st["embed"][0]),
        jnp.asarray(st["embed_avg"][0]))
    tout = trvq._train_one_quantizer(tcfg, torch.from_numpy(residual), torch.tensor(1.0),
                                     torch.from_numpy(st["cluster_size"][0]), torch.from_numpy(st["embed"][0]),
                                     torch.from_numpy(st["embed_avg"][0]), True, torch.Generator(),
                                     fresh_idx=torch.from_numpy(fresh).long())
    expired = np.asarray(jout[3]) == 4.0
    assert expired.any() and not expired.all()  # the case exercises both branches
    for a, b, name in zip(tout, jout, ("quantized", "indices", "inited", "cluster_size", "embed", "embed_avg")):
        np.testing.assert_allclose(np.asarray(a.numpy(), np.float64), np.asarray(b, np.float64), atol=1e-5,
                                   err_msg=name)


def test_dropout_invariants():
    """A dropped layer gives index -1, commit 0, sub_quants -1.0 and keeps its
    buffers; the kept layers equal a run of that depth without dropout; the
    depths drawn are the configured ones."""
    options = (1, 2, 4, 6)
    _, cfg = _cfgs(quantize_dropout=True, rand_num_quant=options)
    _, plain = _cfgs()
    st, x = _state(), torch.from_numpy(_x())
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(12):
        q, idx, commits, subq, ns = trvq.rvq_train_forward(cfg, _tstate(st), x, gen)
        kept = int((idx[:, 0, 0] >= 0).sum())
        seen.add(kept)
        assert kept in options
        assert (idx[kept:] == -1).all() and (commits[kept:] == 0).all() and (subq[kept:] == -1.0).all()
        for name in trvq.RVQTensors._fields:
            assert torch.equal(getattr(ns, name)[kept:], torch.from_numpy(st[name][kept:])), name
        rq, ridx, rcommits, rsubq, rns = trvq.rvq_train_forward(plain, _tstate(st), x, gen, n_q=kept)
        assert torch.equal(idx[:kept], ridx)
        np.testing.assert_allclose(q.numpy(), rq.numpy(), atol=1e-6)
        np.testing.assert_allclose(commits[:kept].numpy(), rcommits.numpy(), atol=1e-7)
        for name in trvq.RVQTensors._fields:
            np.testing.assert_allclose(getattr(ns, name)[:kept].numpy(), getattr(rns, name)[:kept].numpy(), atol=1e-6)
    assert len(seen) >= 3


def test_kmeans_init_slow_path_inits_active_layers():
    _, cfg = _cfgs(quantize_dropout=True, rand_num_quant=(2,), expiry_mode="effective")
    st = _state()
    st["inited"][:] = 0.0
    q, idx, commits, subq, ns = trvq.rvq_train_forward(cfg, _tstate(st), torch.from_numpy(_x()),
                                                       torch.Generator().manual_seed(0))
    assert ns.inited.tolist() == [1.0, 1.0, 0.0, 0.0, 0.0, 0.0]
    assert torch.isfinite(q).all() and (idx[:2] >= 0).all()
    assert torch.equal(ns.embed[2:], torch.from_numpy(st["embed"][2:]))


def test_nq1_with_q0_downsample():
    _, cfg = _cfgs(q0_ds_ratio=2)
    x = torch.from_numpy(_x(T=12)).requires_grad_()
    q, idx, commits, subq, ns = trvq.rvq_train_forward(cfg, _tstate(_state()), x, torch.Generator(), n_q=1)
    assert idx.shape == (1, 3, 12) and commits.shape == (1,) and torch.isfinite(q).all()
    (g,) = torch.autograd.grad(q.square().sum(), x)
    assert float(g.abs().sum()) > 0  # through quantizer 0's straight-through estimator


def test_codebook_health_matches_jax():
    jcfg, tcfg = _cfgs()
    st = _state()
    st["cluster_size"][0, :5] = 0.0
    st["cluster_size"][1] = 0.5
    j_dead, j_perp = jax.jit(lambda s: jrvq.codebook_health(jcfg, s))(_jstate(st))
    dead, perp = trvq.codebook_health(tcfg, _tstate(st))
    assert float(dead) == float(j_dead)
    np.testing.assert_allclose(float(perp), float(j_perp), rtol=1e-6)


def test_quantizer_train_forward_returns_the_mean_commit():
    from funcodec_tpu_torch.models.quantizer import Quantizer, QuantizerConfig

    qz = Quantizer(QuantizerConfig(input_size=D, codebook_size=BINS, num_quantizers=N_Q, kmeans_init=False,
                                   quantize_dropout=True, rand_num_quant=(2,)),
                   device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x())
    q, idx, commit, subq, ns = qz.train_forward(x, torch.Generator().manual_seed(1))
    _, _, commits, _, _ = trvq.rvq_train_forward(qz.rvq_cfg, qz.state.tensors(), x,
                                                 torch.Generator().manual_seed(1))
    np.testing.assert_allclose(float(commit), float(commits.mean()), rtol=1e-6)
    assert float(commits[2:].abs().sum()) == 0.0
    # the buffers are not written
    assert torch.equal(qz.state.cluster_size, torch.zeros(N_Q, BINS))
