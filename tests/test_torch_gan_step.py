"""The port's GAN training step against funcodec_tpu, on the CPU.

Both packages build the tiny model of tests/test_gan_training.py
``_tiny_setup`` (SEANet n_filters 4, 16-d latents, 4 quantizers of 32
codes, a 4-filter MS-STFT discriminator, here with one of its two STFT
scales as in tests/test_shared_forward.py) from one config dict; the JAX parameters are numpy values from a seed, carried into the
port by compat/from_jax. Parity runs without random draws: codebooks
initialized (no k-means), no quantizer dropout, expiry "reference".

Tolerances: losses and stats rtol 1e-4 (fp32, summation order and FFT vs
DFT matmuls); gradients atol 1e-4 + rtol 2e-3 of the largest gradient of
the tensor; make_optimizer against optax 1e-4 lr.

The helpers here (``build_pair``, ``speech``) are shared by
tests/test_torch_gan_two_steps.py, which holds two steps of each mode.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from funcodec_tpu.tasks.codec import build_codec_model as jbuild
from funcodec_tpu.train import step as jstep
from funcodec_tpu_torch.compat.from_jax import discriminator_state_dict_from_jax, state_dict_from_jax
from funcodec_tpu_torch.tasks.codec import build_codec_model as tbuild
from funcodec_tpu_torch.train import step as tstep

torch.set_num_threads(1)

LR = 1e-3


def config(kmeans_init=False, scales=1, **quantizer):
    """_tiny_setup's model as a config dict; its discriminator has the first
    `scales` of _tiny_setup's two STFT scales (one keeps the JAX step's
    compile at half)."""
    seanet = {"norm": "time_group_norm", "n_filters": 4, "ratios": [4, 2]}
    q = {"codebook_size": 32, "num_quantizers": 4, "ema_decay": 0.9, "kmeans_init": kmeans_init,
         "sampling_rate": 16000, "encoder_hop_length": 8, **quantizer}
    return {
        "encoder_conf": dict(seanet), "decoder_conf": dict(seanet),
        "quantizer_conf": q,
        "model_conf": {"odim": 16, "multi_spectral_window_powers_of_two": [5, 6], "use_power_spec_loss": True},
        "discriminator_conf": {"disc_conf_list": [{
            "name": "encodec_multi_scale_stft_discriminator", "filters": 4,
            "n_ffts": [256, 512][:scales], "hop_lengths": [64, 128][:scales],
            "win_lengths": [256, 512][:scales]}]},
    }


def _leaf(path, shape, rs):
    """A seeded value for one JAX parameter or RVQ buffer, at torch-init scale."""
    name = getattr(path[-1], "key", getattr(path[-1], "name", ""))
    if name in ("kernel", "v"):
        return rs.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
    if name == "g":
        return rs.uniform(0.5, 1.5, shape)
    if name in ("w_ih", "w_hh", "b_ih", "b_hh"):
        return rs.uniform(-1, 1, shape) / np.sqrt(shape[-1] // 4)
    if name == "norm_scale":
        return 1.0 + 0.1 * rs.randn(*shape)
    if name in ("embed", "embed_avg"):
        return rs.uniform(-1, 1, shape) * np.sqrt(1.0 / shape[-1])
    if name == "inited":
        return np.ones(shape)
    if name == "cluster_size":
        return rs.uniform(1.0, 4.0, shape)
    return 0.1 * rs.randn(*shape)


def _values(shapes, rs):
    return jax.tree_util.tree_map_with_path(lambda p, a: jnp.asarray(_leaf(p, a.shape, rs), a.dtype), shapes)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@dataclasses.dataclass
class Pair:
    """One model in both packages with the same weights and codebooks."""

    jm: object
    jdisc: object
    params: object
    state: object
    disc_params: object
    tm: torch.nn.Module
    tdisc: torch.nn.Module

    def port_params(self, jax_tree):
        """A JAX generator-parameter tree (values or grads) under the port's names."""
        sd = state_dict_from_jax(self.tm, np_tree(jax_tree), np_tree(self.state))
        return {n: sd[n] for n, _ in self.tm.named_parameters()}

    def port_disc_params(self, jax_tree):
        return discriminator_state_dict_from_jax(np_tree(jax_tree), self.tdisc)


def build_pair(cfg, seed=0) -> Pair:
    jm, jdisc = jbuild(cfg)
    rs = np.random.RandomState(seed)
    params, state = _values(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), rs)
    disc_params = _values(jax.eval_shape(jdisc.init, jax.random.PRNGKey(1)), rs)
    tm, tdisc = tbuild(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(state_dict_from_jax(tm, np_tree(params), np_tree(state)))
    tdisc.load_state_dict(discriminator_state_dict_from_jax(np_tree(disc_params), tdisc))
    return Pair(jm, jdisc, params, state, disc_params, tm, tdisc)


def speech(batch=2, length=1024, seed=0, scale=0.3):
    return (scale * np.random.RandomState(seed).randn(batch, length)).astype(np.float32)


def assert_grads_close(got, want, what, rtol=2e-3, atol=1e-4):
    assert set(got) == set(want), what
    for name, g in got.items():
        w = np.asarray(want[name])
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.detach().numpy(), w, atol=atol + rtol * scale, rtol=0, err_msg=f"{what} {name}")


def assert_stats_close(got, want, rtol=1e-4, atol=1e-6, keys=None):
    for k in keys or want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# the JAX side, jitted once per module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    return build_pair(config())


@pytest.fixture(scope="module")
def jax_turns(pair):
    """JAX forward_generator / forward_discriminator losses, outs and grads."""
    x = jnp.asarray(speech())
    key = jax.random.PRNGKey(0)

    def gen(params):
        return pair.jm.forward_generator(params, pair.disc_params, pair.jdisc, pair.state, x, key)

    def disc(disc_params):
        return pair.jm.forward_discriminator(pair.params, disc_params, pair.jdisc, pair.state, x, key,
                                             jnp.float32(0.0))

    g = jax.jit(jax.value_and_grad(gen, has_aux=True))(pair.params)
    d = jax.jit(jax.value_and_grad(disc, has_aux=True))(pair.disc_params)
    return g, d


def _port_generator_grads(pair, x):
    tm, tdisc = pair.tm, pair.tdisc
    loss, out = tm.forward_generator(tdisc, torch.from_numpy(x), torch.Generator().manual_seed(0))
    names, params = zip(*tm.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert all(p.grad is None for p in tdisc.parameters())  # no gradient reaches the discriminator
    return loss, out, dict(zip(names, grads))


def test_forward_generator_matches_jax(pair, jax_turns):
    (j_loss, j_out), j_grads = jax_turns[0]
    loss, out, grads = _port_generator_grads(pair, speech())
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4)
    assert_stats_close(out["stats"], j_out["stats"])
    np.testing.assert_allclose(float(out["gen_loss"]), float(j_out["gen_loss"]), rtol=1e-4)
    assert_grads_close(grads, pair.port_params(j_grads), "generator grad")
    # the new RVQ state (an EMA step) and the reconstruction
    for name in ("cluster_size", "embed", "embed_avg", "inited"):
        np.testing.assert_allclose(getattr(out["rvq_state"], name).numpy(),
                                   np.asarray(getattr(j_out["rvq_state"], name)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["fake"].detach().numpy(), np.asarray(j_out["fake"]), atol=1e-5)


def test_forward_discriminator_matches_jax(pair, jax_turns):
    (j_loss, j_out), j_grads = jax_turns[1]
    tdisc = pair.tdisc
    loss, out = pair.tm.forward_discriminator(tdisc, torch.from_numpy(speech()), torch.Generator(),
                                              torch.zeros(()))
    names, params = zip(*tdisc.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4)
    assert_stats_close(out["stats"], j_out["stats"])
    assert_grads_close(grads, pair.port_disc_params(j_grads), "discriminator grad")
    assert all(p.grad is None for p in pair.tm.parameters())


def test_disc_gating_blocks_update(pair):
    """A huge carry gates the discriminator loss to 0; the raw loss is still reported."""
    loss, out = pair.tm.forward_discriminator(pair.tdisc, torch.from_numpy(speech(length=2048)),
                                              torch.Generator(), torch.tensor(1e9))
    assert loss.item() == 0.0 and float(out["stats"]["discriminator_loss"]) > 0


# ---------------------------------------------------------------------------
# the port's own step semantics (mirroring tests/test_shared_forward.py,
# test_nonfinite_gate.py and test_mixed_precision.py)
# ---------------------------------------------------------------------------


def _port_state(cfg=None, shared=True, compute_dtype=None, lr=LR, **kw):
    p = build_pair(cfg or config())
    opt_g, opt_d = tstep.make_optimizer(lr=lr), tstep.make_optimizer(lr=lr)
    state = tstep.create_gan_train_state(p.tm, p.tdisc, opt_g, opt_d)
    step = tstep.make_gan_train_step(p.tm, p.tdisc, opt_g, opt_d, shared_forward=shared,
                                     compute_dtype=compute_dtype, **kw)
    return state, step


def _snapshot(state):
    opt = [t.clone() for t in _opt_tensors(state.opt_state_g) + _opt_tensors(state.opt_state_d)]
    return ({n: p.detach().clone() for n, p in state.params.items()},
            {n: p.detach().clone() for n, p in state.disc_params.items()},
            {n: b.clone() for n, b in state.rvq_state.named_buffers()}, opt)


def _opt_tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _opt_tensors(v)]
    return []


@pytest.mark.parametrize("shared", [False, True], ids=["train_step", "shared_train_step"])
def test_nonfinite_batch_changes_nothing(shared):
    state, step = _port_state(shared=shared)
    x = {"speech": torch.from_numpy(speech())}
    state, _ = step(state, x, torch.Generator())
    before = _snapshot(state)
    bad = x["speech"].clone()
    bad[0, 10] = float("nan")
    state, stats = step(state, {"speech": bad}, torch.Generator())
    after = _snapshot(state)
    assert float(stats["generator_nonfinite_skip"]) == 1.0
    assert float(stats["discriminator_nonfinite_skip"]) == 1.0
    for a, b in zip(before, after):
        items = a.items() if isinstance(a, dict) else enumerate(a)
        for k, v in items:
            assert torch.equal(v, b[k]), k
    assert state.step == 2
    state, stats = step(state, x, torch.Generator())  # and training goes on
    assert float(stats["generator_nonfinite_skip"]) == 0.0


def test_shared_mode_disc_interval_gates_carry_and_update():
    """disc_train_interval=2: the carry resets and the disc moves only on the
    steps whose disc turn runs."""
    state, step = _port_state(shared=True, disc_train_interval=2)
    x = {"speech": torch.from_numpy(speech())}
    d0 = _snapshot(state)[1]
    state, _ = step(state, x, torch.Generator())
    d1, carry0 = _snapshot(state)[1], float(state.gen_loss_carry)
    state, stats1 = step(state, x, torch.Generator())
    d2, carry1 = _snapshot(state)[1], float(state.gen_loss_carry)
    assert any(not torch.equal(d0[k], d1[k]) for k in d0), "the disc updates on step 0"
    assert all(torch.equal(d1[k], d2[k]) for k in d1)
    assert carry1 > carry0 > 0  # a second generator loss accumulated
    assert float(stats1["discriminator_loss"]) == 0.0


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
def test_masters_stay_fp32(compute_dtype):
    state, step = _port_state(shared=True, compute_dtype=compute_dtype)
    x = {"speech": torch.from_numpy(speech(scale=0.1))}
    for _ in range(2):
        state, stats = step(state, x, torch.Generator())
    for t in list(state.params.values()) + list(state.disc_params.values()):
        assert t.dtype == torch.float32
    for t in _opt_tensors(state.opt_state_g) + _opt_tensors(state.opt_state_d):
        assert t.dtype == torch.float32
    assert all(b.dtype == torch.float32 for b in state.rvq_state.buffers())
    assert all(np.isfinite(float(v)) for v in stats.values())


def test_bf16_loss_close_to_fp32():
    losses = {}
    for dtype in (None, torch.bfloat16):
        state, step = _port_state(shared=False, compute_dtype=dtype)
        _, stats = step(state, {"speech": torch.from_numpy(speech(scale=0.1))}, torch.Generator())
        losses[dtype] = float(stats["generator_loss"])
    assert losses[torch.bfloat16] == pytest.approx(losses[None], rel=0.05)


def test_kmeans_init_and_dropout_train():
    """The recipe's quantizer (k-means init, dropout, effective expiry) trains:
    every stat finite, all codebooks initialized after the first steps."""
    cfg = config(kmeans_init=True, quantize_dropout=True, rand_num_quant=[1, 2, 4], expiry_mode="effective")
    state, step = _port_state(cfg, shared=True)
    x = {"speech": torch.from_numpy(speech())}
    gen = torch.Generator().manual_seed(0)
    for _ in range(4):
        state, stats = step(state, x, gen)
        assert all(np.isfinite(float(v)) for v in stats.values())
    assert float(state.rvq_state.inited.sum()) >= 1
    assert float(state.gen_loss_carry) > 0


# ---------------------------------------------------------------------------
# make_optimizer against optax on identical gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(), dict(name="adamw", weight_decay=0.01), dict(name="fairseq_adam", weight_decay=0.1),
    dict(name="sgd", momentum=0.9), dict(grad_clip=0.5), dict(accum_grad=2),
    dict(schedule="warmup"),
], ids=["adam", "adamw", "fairseq_adam_wd", "sgd_momentum", "clip", "accum2", "schedule"])
def test_make_optimizer_matches_optax(kw):
    kw = dict(kw)
    if kw.get("schedule") == "warmup":
        kw["schedule"] = lambda count: 1e-3 * min(1.0, (count + 1) / 3)
    rs = np.random.RandomState(0)
    shapes = [(3, 4), (5,), (2, 3, 2)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) for s in shapes] for _ in range(4)]
    jopt = jstep.make_optimizer(lr=1e-3, **kw)
    jp = [jnp.asarray(p) for p in params]
    js = jopt.init(jp)
    topt = tstep.make_optimizer(lr=1e-3, **kw)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = topt.init(tp)
    for g in grads:
        updates, js = jopt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, updates)
        ts, _, finite = tstep.apply_updates_if_finite(topt, [torch.from_numpy(x) for x in g], ts, tp)
        assert finite
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-3 * 1e-4)  # 1e-4 lr


def test_grad_noise_is_annealed_gaussian():
    """optax.add_noise's law (its draws are jax.random's): on zero gradients
    the t-th update of sgd(lr=1) is N(0, 0.01 / t^0.55)."""
    opt = tstep.make_optimizer(lr=1.0, name="sgd", grad_noise=True)
    params = [torch.zeros(20_000)]
    state = opt.init(params)
    for t in (1, 2, 3):
        updates, state = opt.update([torch.zeros(20_000)], state, params)
        std = (0.01 / t**0.55) ** 0.5
        assert abs(float(updates[0].std()) / std - 1.0) < 0.03  # 20,000 draws: about 0.5% sampling error
        assert abs(float(updates[0].mean())) < 4 * std / 20_000**0.5


def test_apply_updates_skips_nonfinite():
    opt = tstep.make_optimizer(lr=1e-2)
    params = [torch.ones(3), torch.tensor(2.0)]
    state = opt.init(params)
    state1, norm, finite = tstep.apply_updates_if_finite(opt, [torch.tensor([1.0, float("nan"), 0.0]),
                                                               torch.tensor(0.5)], state, params)
    assert not finite and not np.isfinite(float(norm)) and state1 is state
    assert torch.equal(params[0], torch.ones(3))
    state2, _, finite = tstep.apply_updates_if_finite(opt, [torch.tensor([1.0, -1.0, 0.0]), torch.tensor(0.5)],
                                                      state, params)
    assert finite and state2 is not state and not torch.equal(params[0], torch.ones(3))


def test_cast_floating_only_touches_f32():
    tree = {"a": torch.ones(2), "b": [torch.ones(2, dtype=torch.int32), torch.ones(2, dtype=torch.float64)]}
    out = tstep.cast_floating(tree, torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16
    assert out["b"][0].dtype == torch.int32 and out["b"][1].dtype == torch.float64
    assert tstep.cast_floating(tree, None) is tree


def test_state_dict_with_the_discriminator_round_trips(pair, tmp_path):
    """The model's and the discriminator's weights (the latter under
    ``discriminator.``) saved as one .pth load back through
    load_torch_state_dict into fresh modules, equal."""
    from funcodec_tpu_torch.compat.from_jax import load_torch_state_dict

    sd = {**pair.tm.state_dict(), **{f"discriminator.{k}": v for k, v in pair.tdisc.state_dict().items()}}
    torch.save({"model": sd}, tmp_path / "model.pth")
    loaded = load_torch_state_dict(str(tmp_path / "model.pth"))
    tm, tdisc = tbuild(config(), device="cpu", generator=torch.Generator().manual_seed(9))
    tm.load_state_dict({k: v for k, v in loaded.items() if not k.startswith("discriminator.")})
    tdisc.load_state_dict({k[len("discriminator."):]: v for k, v in loaded.items() if k.startswith("discriminator.")})
    for a, b in ((tm, pair.tm), (tdisc, pair.tdisc)):
        for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), n
