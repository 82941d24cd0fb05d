"""Two GAN steps of each mode, the port against funcodec_tpu, on the CPU.

The model and weights are those of tests/test_torch_gan_step.py (the tiny
model of tests/test_gan_training.py ``_tiny_setup``, no random draws); both
packages take two Adam steps (lr 1e-3) of ``train_step`` (the reference's
two-forward step) and of ``shared_train_step`` on one batch.

Tolerances: per-step stats rtol 2e-3 (the second step's stats see
parameters that moved by Adam's sign-like first step); every parameter
element within 0.05 lr, except the bias of a conv whose time_group_norm
has one channel (the norm removes it exactly, so its gradient is rounding
noise in both packages, which Adam turns into steps of about +-lr either
way; it is held finite); the RVQ buffers atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from funcodec_tpu.train import step as jstep
from funcodec_tpu_torch.train import step as tstep
from tests.test_torch_gan_step import LR, build_pair, config, speech

torch.set_num_threads(1)


def _jax_steps(cfg, shared, n=2, disc_train_interval=1, compute_dtype=None, batch=None):
    p = build_pair(cfg)
    opt_g, opt_d = jstep.make_optimizer(lr=LR), jstep.make_optimizer(lr=LR)
    state = jstep.create_gan_train_state(p.params, p.disc_params, p.state, opt_g, opt_d)
    step = jax.jit(jstep.make_gan_train_step(p.jm, p.jdisc, opt_g, opt_d, shared_forward=shared,
                                             disc_train_interval=disc_train_interval,
                                             compute_dtype=compute_dtype))
    x = {"speech": jnp.asarray(speech() if batch is None else batch)}
    stats = []
    for _ in range(n):
        state, s = step(state, x, jax.random.PRNGKey(7))
        stats.append(jax.device_get(s))
    return p, state, stats


def _port_steps(p, shared, n=2, disc_train_interval=1, compute_dtype=None, batch=None):
    opt_g, opt_d = tstep.make_optimizer(lr=LR), tstep.make_optimizer(lr=LR)
    state = tstep.create_gan_train_state(p.tm, p.tdisc, opt_g, opt_d)
    step = tstep.make_gan_train_step(p.tm, p.tdisc, opt_g, opt_d, shared_forward=shared,
                                     disc_train_interval=disc_train_interval, compute_dtype=compute_dtype)
    x = {"speech": torch.from_numpy(speech() if batch is None else batch)}
    gen = torch.Generator().manual_seed(7)
    stats = []
    for _ in range(n):
        state, s = step(state, x, gen)
        stats.append({k: float(v) for k, v in s.items()})
    return state, stats


def _norm_removed_biases(model):
    """Names of the conv biases that a one-channel time_group_norm removes
    exactly (SEANet's last decoder conv): 0 gradient in exact arithmetic."""
    return {f"{name}.conv.conv.bias" for name, m in model.named_modules()
            if getattr(m, "spec", None) is not None and m.spec.norm == "time_group_norm"
            and m.spec.out_channels == 1 and m.spec.bias}


def _assert_params_within_lr(got, want, what, exempt=frozenset()):
    """Every element within 0.05 lr of JAX's, but the `exempt` tensors, held finite."""
    for name, t in got.items():
        if name in exempt:
            assert torch.isfinite(t).all(), f"{what} {name}"
            continue
        d = np.abs(t.detach().numpy() - np.asarray(want[name])) / LR
        assert float(d.max()) <= 0.05, f"{what} {name}: max {float(d.max())} lr"


@pytest.fixture(scope="module", params=[False, True], ids=["train_step", "shared_train_step"])
def two_steps(request):
    cfg = config()
    p, j_state, j_stats = _jax_steps(cfg, request.param)
    t_state, t_stats = _port_steps(p, request.param)
    return p, j_state, j_stats, t_state, t_stats


def test_two_steps_stats_match_jax(two_steps):
    _, _, j_stats, _, t_stats = two_steps
    for i, (t, j) in enumerate(zip(t_stats, j_stats)):
        assert set(t) == set(j), i
        for k in j:
            np.testing.assert_allclose(t[k], float(j[k]), rtol=2e-3, atol=1e-5, err_msg=f"step {i} {k}")


def test_two_steps_params_match_jax(two_steps):
    p, j_state, _, t_state, _ = two_steps
    assert t_state.step == int(j_state.step) == 2
    exempt = _norm_removed_biases(p.tm)
    assert exempt == {"decoder.model.9.conv.conv.bias"}
    _assert_params_within_lr(t_state.params, p.port_params(j_state.params), "generator", exempt)
    _assert_params_within_lr(t_state.disc_params, p.port_disc_params(j_state.disc_params), "discriminator")
    for name in ("cluster_size", "embed", "embed_avg", "inited"):
        np.testing.assert_allclose(getattr(t_state.rvq_state, name).numpy(),
                                   np.asarray(getattr(j_state.rvq_state, name)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(t_state.gen_loss_carry), float(j_state.gen_loss_carry), rtol=2e-3)
