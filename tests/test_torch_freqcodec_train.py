"""FreqCodec training in the port against funcodec_tpu, on the CPU.

The tiny mag_phase FreqCodec of tests/test_torch_freqcodec.py with a
4-filter, one-scale MS-STFT discriminator, phase-invariant training (PIT)
on and feature matching from layer 1 (``feat_match_layer_start``), built
in both packages from one config dict with the same numpy-seeded weights
(tests/test_torch_gan_step.build_pair). No draws: codebooks initialized,
no quantizer dropout, expiry "reference"; the PhaseAug rotation is one
explicit ``phi``, which both packages take by monkeypatching their
phase_aug inside this test process (the port draws from a torch.Generator,
the JAX package from jax.random).

Tolerances, as tests/test_torch_gan_step.py: losses and stats rtol 1e-4
(the discriminator turn and the generator's losses; the step's stats rtol
2e-3, the PIT term weighs 1000); gradients atol 1e-4 + rtol 2e-3 of the
tensor's largest (the step's gradients read from both optimizers' first
moments); one Adam step's parameters within 0.05 lr wherever the gradient
stands above 1e-4 of the module's largest (below it, Adam's sign-like
first step follows rounding noise in either package).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import funcodec_tpu.ops.stft as jstft
import funcodec_tpu_torch.models.encodec as tencodec
import funcodec_tpu_torch.ops.stft as tstft
from funcodec_tpu.train import step as jstep
from funcodec_tpu_torch.compat.from_jax import _jax_adam_states
from funcodec_tpu_torch.train import step as tstep
from test_torch_freqcodec import tiny_config
from test_torch_gan_step import LR, assert_grads_close, assert_stats_close, build_pair

torch.set_num_threads(1)

B, T = 2, 3200


def train_config(pit=True):
    cfg = tiny_config(phase_invariant_training=pit, feat_match_layer_start=1,
                      multi_spectral_window_powers_of_two=[5, 6], use_power_spec_loss=True)
    cfg["quantizer_conf"].update(codebook_size=32, ema_decay=0.9)
    cfg["discriminator_conf"] = {"disc_conf_list": [{
        "name": "encodec_multi_scale_stft_discriminator", "filters": 4,
        "n_ffts": [256], "hop_lengths": [64], "win_lengths": [256]}]}
    return cfg


def speech(seed=0):
    return (0.3 * np.random.RandomState(seed).randn(B, T)).astype(np.float32)


PHI = np.random.RandomState(9).uniform(-np.pi, np.pi, (B, 257)).astype(np.float32)


@pytest.fixture
def fixed_phi(monkeypatch):
    """Both packages' PhaseAug rotate by PHI, whatever they would draw."""
    j_orig, t_orig = jstft.phase_aug, tstft.phase_aug
    monkeypatch.setattr(jstft, "phase_aug", lambda x, key=None, **kw: j_orig(x, phi=jnp.asarray(PHI), **kw))
    monkeypatch.setattr(tencodec, "phase_aug",
                        lambda x, generator=None, **kw: t_orig(x, phi=torch.from_numpy(PHI), **kw))


@pytest.fixture(scope="module")
def pair():
    return build_pair(train_config())


def test_pit_discriminator_turn_matches_jax(pair, fixed_phi):
    """forward_discriminator with PIT: the hinge loss, the PIT loss (logits
    and the fmaps from layer 1 on) times 1000, and the gradient."""
    x = jnp.asarray(speech())

    def disc(disc_params):
        return pair.jm.forward_discriminator(pair.params, disc_params, pair.jdisc, pair.state, x,
                                             jax.random.PRNGKey(0), jnp.float32(0.0))

    (j_loss, j_out), j_grads = jax.jit(jax.value_and_grad(disc, has_aux=True))(pair.disc_params)
    tdisc = pair.tdisc
    loss, out = pair.tm.forward_discriminator(tdisc, torch.from_numpy(speech()), torch.Generator(), torch.zeros(()))
    assert set(out["stats"]) == set(j_out["stats"]) == {"discriminator_total_loss", "discriminator_loss",
                                                         "pit_disc_loss"}
    assert float(out["stats"]["pit_disc_loss"]) > 0
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4)
    assert_stats_close(out["stats"], j_out["stats"])
    names, params = zip(*tdisc.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    assert_grads_close(grads, pair.port_disc_params(j_grads), "discriminator grad")


def test_pit_is_gated_with_the_hinge_loss(pair, fixed_phi):
    loss, out = pair.tm.forward_discriminator(pair.tdisc, torch.from_numpy(speech(1)), torch.Generator(),
                                              torch.tensor(1e9))
    assert loss.item() == 0.0 and float(out["stats"]["pit_disc_loss"]) == 0.0
    assert float(out["stats"]["discriminator_loss"]) > 0


def test_generator_turn_with_feat_match_layer_start_matches_jax(pair):
    """forward_generator: feature matching over the fmaps from layer 1 on."""
    x = jnp.asarray(speech())

    def gen(params):
        return pair.jm.forward_generator(params, pair.disc_params, pair.jdisc, pair.state, x,
                                         jax.random.PRNGKey(0))

    (j_loss, j_out), j_grads = jax.jit(jax.value_and_grad(gen, has_aux=True))(pair.params)
    tm = pair.tm
    loss, out = tm.forward_generator(pair.tdisc, torch.from_numpy(speech()), torch.Generator())
    names, params = zip(*tm.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4)
    assert_stats_close(out["stats"], j_out["stats"])
    np.testing.assert_allclose(out["fake"].detach().numpy(), np.asarray(j_out["fake"]), atol=1e-5)
    assert_grads_close(grads, pair.port_params(j_grads), "generator grad")


def _adam_mu(opt_state):
    """The first moments of a one-Adam chain's state, either package's."""
    if isinstance(opt_state[0], dict):
        return opt_state[0]["mu"]
    (adam,) = _jax_adam_states(opt_state)
    return adam.mu


def test_one_shared_pit_step_matches_jax(fixed_phi):
    """One shared_train_step (Adam, lr 1e-3) of both packages from the same
    state: every stat, every parameter, the RVQ buffers and the carry."""
    p = build_pair(train_config())
    opt_g, opt_d = jstep.make_optimizer(lr=LR), jstep.make_optimizer(lr=LR)
    jstate = jstep.create_gan_train_state(p.params, p.disc_params, p.state, opt_g, opt_d)
    jfn = jax.jit(jstep.make_gan_train_step(p.jm, p.jdisc, opt_g, opt_d, shared_forward=True))
    jstate, j_stats = jfn(jstate, {"speech": jnp.asarray(speech())}, jax.random.PRNGKey(7))
    topt_g, topt_d = tstep.make_optimizer(lr=LR), tstep.make_optimizer(lr=LR)
    state = tstep.create_gan_train_state(p.tm, p.tdisc, topt_g, topt_d)
    step = tstep.make_gan_train_step(p.tm, p.tdisc, topt_g, topt_d, shared_forward=True)
    state, stats = step(state, {"speech": torch.from_numpy(speech())}, torch.Generator().manual_seed(7))
    j_stats = jax.device_get(j_stats)
    assert set(stats) == set(j_stats) and "pit_disc_loss" in stats
    for k in j_stats:
        np.testing.assert_allclose(float(stats[k]), float(j_stats[k]), rtol=2e-3, atol=1e-5, err_msg=k)
    for what, got, want, port, mu, j_mu in (
            ("generator", state.params, p.port_params(jstate.params), p.port_params, state.opt_state_g,
             jstate.opt_state_g),
            ("discriminator", state.disc_params, p.port_disc_params(jstate.disc_params), p.port_disc_params,
             state.opt_state_d, jstate.opt_state_d)):
        # after one step mu = (1 - b1) * gradient: the gradients, held as test_torch_gan_step holds them
        grads = dict(zip(got, _adam_mu(mu)))
        j_grads = {n: np.asarray(g) for n, g in port(_adam_mu(j_mu)).items()}
        assert_grads_close(grads, j_grads, f"{what} step gradient")
        # Adam's first step is about lr * sign(gradient): held where the
        # gradient stands above 1e-4 of the module's largest (below, e.g. the
        # logit bias the hinge and PIT terms cancel exactly, its sign is
        # rounding noise in both packages)
        floor = 1e-4 * max(float(np.abs(g).max()) for g in j_grads.values())
        for name, t in got.items():
            assert torch.isfinite(t).all(), name
            d = np.abs(t.detach().numpy() - np.asarray(want[name])) / LR
            d = d[np.abs(j_grads[name]) > floor]
            assert d.size == 0 or float(d.max()) <= 0.05, f"{what} {name}: max {float(d.max())} lr"
    for name in ("cluster_size", "embed", "embed_avg", "inited"):
        np.testing.assert_allclose(getattr(state.rvq_state, name).numpy(),
                                   np.asarray(getattr(jstate.rvq_state, name)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(state.gen_loss_carry), float(jstate.gen_loss_carry), rtol=2e-3)


@pytest.mark.parametrize("shared", [False, True], ids=["train_step", "shared_train_step"])
def test_pit_steps_train_with_draws(shared):
    """The port alone, PhaseAug drawing from the step's generator: two bf16
    steps of each mode with disc_train_interval 2, every stat finite,
    pit_disc_loss reported (0 on the step whose disc turn is skipped), the
    masters fp32 and moved; the same seed gives the same first step."""
    results = []
    for _ in range(2):
        p = build_pair(train_config())
        opt_g, opt_d = tstep.make_optimizer(lr=LR), tstep.make_optimizer(lr=LR)
        state = tstep.create_gan_train_state(p.tm, p.tdisc, opt_g, opt_d)
        step = tstep.make_gan_train_step(p.tm, p.tdisc, opt_g, opt_d, shared_forward=shared,
                                         compute_dtype=torch.bfloat16, disc_train_interval=2)
        before = {n: t.detach().clone() for n, t in state.disc_params.items()}
        gen = torch.Generator().manual_seed(3)
        x = {"speech": torch.from_numpy(speech(2))}
        state, s0 = step(state, x, gen)
        state, s1 = step(state, x, gen)
        for s in (s0, s1):
            assert "pit_disc_loss" in s and all(np.isfinite(float(v)) for v in s.values())
        assert float(s1["pit_disc_loss"]) == 0.0 and float(s1["discriminator_loss"]) == 0.0
        assert all(t.dtype == torch.float32 for t in list(state.params.values()) + list(state.disc_params.values()))
        assert any(not torch.equal(before[n], t) for n, t in state.disc_params.items())
        results.append(float(s0["discriminator_total_loss"]))
    assert results[0] == results[1]
