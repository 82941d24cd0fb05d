"""The port's HiFiGAN and SoundStream discriminators against funcodec_tpu, on the CPU.

Each registry kind is built through both packages' ``build_discriminator``
from one conf list at small widths; the JAX parameters are seeded numpy
(``jax.eval_shape`` + values) carried into the port by
``compat/from_jax.discriminator_state_dict_from_jax``. The port lays
features out channels-first ((B, C, T), (B, C, H, W)), JAX channels-last.

Tolerances: logits and fmaps atol 1e-5 + rtol 2e-4 (the MS-STFT test's),
the complex-STFT discriminator's 1e-4 of each tensor's largest value (fp32
FFT against JAX's DFT matmuls, through seven complex convs); the GAN step's
stats rtol 2e-3, its gradients atol 1e-4 + rtol 2e-3 of each tensor's
largest and its parameters within 0.05 lr, as
tests/test_torch_freqcodec_train.py holds its one step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import funcodec_tpu.models.discriminators as jdisc_mod
from funcodec_tpu.tasks.codec import build_discriminator as jbuild_disc
from funcodec_tpu_torch.compat.from_jax import _jax_adam_states, discriminator_state_dict_from_jax
from funcodec_tpu_torch.models.discriminators import MultipleDiscriminator
from funcodec_tpu_torch.tasks.codec import build_discriminator as tbuild_disc
from tests.test_torch_gan_step import LR, assert_grads_close, config, np_tree
from tests.test_torch_gan_two_steps import _jax_steps, _port_steps

torch.set_num_threads(1)

SMALL_PERIOD = {"channels": 4, "downsample_scales": [3, 1], "max_downsample_channels": 16}
SMALL_SCALE = {"kernel_sizes": [15, 41, 5, 3], "channels": 16, "downsample_scales": [2, 2, 1], "max_groups": 16}
SMALL_SOUNDSTREAM = {"channels": 8, "layers": 2, "groups": 4, "chan_max": 64}
KINDS = {
    "hifigan_period_discriminator": dict(period=3, channels=8, downsample_scales=[3, 3, 1],
                                         max_downsample_channels=32),
    "hifigan_multi_period_discriminator": dict(periods=[2, 3], discriminator_params=SMALL_PERIOD),
    "hifigan_scale_discriminator": dict(SMALL_SCALE),
    "hifigan_multi_scale_discriminator": dict(scales=2, discriminator_params=SMALL_SCALE),
    "hifigan_multi_scale_multi_period_discriminator": dict(
        scales=2, periods=[2, 3], scale_discriminator_params=SMALL_SCALE,
        period_discriminator_params=SMALL_PERIOD),
    "soundstream_multi_scale_discriminator": dict(discriminator_params=SMALL_SOUNDSTREAM),
    "soundstream_complex_stft_discriminator": dict(channels=4, n_fft=256, hop_length=64, win_length=256),
}


def _conf(*names):
    return {"disc_conf_list": [{"name": n, **KINDS[n]} for n in names]}


def _seeded(tree, rs):
    def leaf(path, a):
        name = getattr(path[-1], "key", "")
        if name in ("kernel", "v"):
            return jnp.asarray(rs.uniform(-1, 1, a.shape) / np.sqrt(np.prod(a.shape[:-1])), a.dtype)
        if name == "g":
            return jnp.asarray(rs.uniform(0.5, 1.5, a.shape), a.dtype)
        return jnp.asarray(0.1 * rs.randn(*a.shape), a.dtype)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _pair(conf, seed=0):
    jd = jbuild_disc(conf)
    params = _seeded(jax.eval_shape(jd.init, jax.random.PRNGKey(0)), np.random.RandomState(seed))
    td = tbuild_disc(conf, device="cpu", generator=torch.Generator().manual_seed(0))
    td.load_state_dict(discriminator_state_dict_from_jax(np_tree(params), td))
    return jd, params, td


def _jax_layout(t: torch.Tensor) -> np.ndarray:
    """A port tensor in JAX's channels-last layout."""
    a = t.detach()
    if a.dim() == 3:
        a = a.transpose(1, 2)
    elif a.dim() == 4:
        a = a.permute(0, 2, 3, 1)
    return a.numpy()


def _assert_outs_close(outs, j_outs, complex_tol=False):
    assert len(outs) == len(j_outs)
    for (logits, fmap), (j_logits, j_fmap) in zip(outs, j_outs):
        assert len(fmap) == len(j_fmap)
        for got, want in [(logits, j_logits)] + list(zip(fmap, j_fmap)):
            want = np.asarray(want)
            got = _jax_layout(got)
            assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
            if complex_tol:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))
            else:
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=2e-4)


@pytest.mark.parametrize("name", list(KINDS))
def test_each_kind_matches_jax(name):
    jd, params, td = _pair(_conf(name))
    T = 2048 if "complex" in name else 1201  # odd: the period discriminators reflect-pad
    x = (0.3 * np.random.RandomState(1).randn(2, T)).astype(np.float32)
    j_outs = jax.jit(jd)(params, jnp.asarray(x))
    with torch.no_grad():
        outs = td(torch.from_numpy(x))
    _assert_outs_close(outs, j_outs, complex_tol="complex" in name)
    if "complex" in name:
        assert all(torch.is_complex(f) for _, fm in outs for f in fm)
        assert all(bool((lo >= 0).all()) for lo, _ in outs)  # |z| logits


def test_mixed_registry(monkeypatch):
    """1 STFT scale + 2 periods + 3 SoundStream scales = 6 flattened outputs
    (tests/test_extra_discriminators.py's mixed registry), equal to JAX's
    plain (not frequency-blocked) tower's."""
    monkeypatch.setattr(jdisc_mod, "BLOCKED_F", False)
    conf = {"disc_conf_list": [
        {"name": "encodec_multi_scale_stft_discriminator", "filters": 4, "n_ffts": [256], "hop_lengths": [64],
         "win_lengths": [256]},
        {"name": "hifigan_multi_period_discriminator", "periods": [2, 3],
         "discriminator_params": {"channels": 4, "downsample_scales": [3, 1]}},
        {"name": "soundstream_multi_scale_discriminator",
         "discriminator_params": {"channels": 4, "layers": 2, "groups": 4, "chan_max": 16}},
    ]}
    jd, params, td = _pair(conf)
    x = (0.3 * np.random.RandomState(0).randn(1, 2048)).astype(np.float32)
    with torch.no_grad():
        outs = td(torch.from_numpy(x))
    assert len(outs) == 6
    for logits, fmap in outs:
        assert torch.isfinite(logits).all() and len(fmap) >= 1
    _assert_outs_close(outs, jax.jit(jd)(params, jnp.asarray(x)))


def test_registry_builds_every_name():
    assert set(KINDS) | {"encodec_multi_scale_stft_discriminator"} == set(MultipleDiscriminator.registry())


def _names(module):
    return set(module.state_dict())


def test_state_dict_names_are_the_reference_names():
    """The names tests/test_extra_discriminators.py imports reference
    checkpoints from: convs.{i}.0 / output_conv, layers.{i}.0 / layers.{n},
    discriminators.{d}.init_conv / conv_layers.{i}.0 / final_conv.{0,2}."""
    g = torch.Generator()
    period = tbuild_disc(_conf("hifigan_period_discriminator"), device="cpu", generator=g).discriminators[0]
    assert _names(period) == {f"{b}.{n}" for b in ("convs.0.0", "convs.1.0", "convs.2.0", "output_conv")
                              for n in ("weight_g", "weight_v", "bias")}
    assert period.convs[0][0].weight_g.shape == (8, 1, 1, 1)
    scale = tbuild_disc(_conf("hifigan_scale_discriminator"), device="cpu", generator=g).discriminators[0]
    assert _names(scale) == {f"layers.{i}{s}.{n}" for i, s in ((0, ".0"), (1, ".0"), (2, ".0"), (3, ".0"),
                                                                 (4, ".0"), (5, "")) for n in ("weight", "bias")}
    ss = tbuild_disc(_conf("soundstream_multi_scale_discriminator"), device="cpu", generator=g).discriminators[0]
    assert _names(ss) == {f"discriminators.{d}.{b}.{n}" for d in range(3)
                          for b in ("init_conv", "conv_layers.0.0", "conv_layers.1.0", "final_conv.0", "final_conv.2")
                          for n in ("weight", "bias")}
    msmpd = tbuild_disc(_conf("hifigan_multi_scale_multi_period_discriminator"), device="cpu", generator=g)
    names = _names(msmpd)
    assert "discriminators.0.msd.discriminators.1.layers.5.weight" in names
    assert "discriminators.0.mpd.discriminators.1.output_conv.weight_g" in names
    cstft = tbuild_disc(_conf("soundstream_complex_stft_discriminator"), device="cpu", generator=g)
    names = _names(cstft)
    assert {"discriminators.0.init_conv.re.weight", "discriminators.0.units.0.b",
            "discriminators.0.units.5.c2.im.bias", "discriminators.0.final_conv.re.weight"} <= names


def test_init_is_uniform_fan_in():
    """Weights and biases U(+-1/sqrt(fan_in)), from the generator given."""
    a = tbuild_disc(_conf("soundstream_multi_scale_discriminator"), device="cpu",
                    generator=torch.Generator().manual_seed(3))
    b = tbuild_disc(_conf("soundstream_multi_scale_discriminator"), device="cpu",
                    generator=torch.Generator().manual_seed(3))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    conv = a.discriminators[0].discriminators[0].conv_layers[0][0]  # 8 -> 32, k 8, groups 4
    bound = 1 / np.sqrt(8 // 4 * 8)
    top = float(conv.weight.detach().abs().max())
    assert 0.9 * bound < top <= bound


def _adam_mu(opt_state):
    """The first moments of a one-Adam chain's state, either package's."""
    if isinstance(opt_state[0], dict):
        return opt_state[0]["mu"]
    (adam,) = _jax_adam_states(opt_state)
    return adam.mu


def test_gan_step_with_extra_discriminators_matches_jax():
    """One fp32 two-forward GAN step of the tiny codec against HiFiGAN-MPD +
    SoundStream: the stats (the gradient norms among them), both modules'
    gradients (Adam's first moments after one step) and every parameter,
    held as tests/test_torch_freqcodec_train.py holds its one step."""
    cfg = config()
    cfg["discriminator_conf"] = _conf("hifigan_multi_period_discriminator", "soundstream_multi_scale_discriminator")
    p, j_state, j_stats = _jax_steps(cfg, shared=False, n=1)
    t_state, t_stats = _port_steps(p, shared=False, n=1)
    assert set(t_stats[0]) == set(j_stats[0])
    assert "generator_grad_norm" in t_stats[0] and "discriminator_grad_norm" in t_stats[0]
    for k, v in j_stats[0].items():
        np.testing.assert_allclose(t_stats[0][k], float(v), rtol=2e-3, atol=1e-5, err_msg=k)
    for what, got, want, port, mu, j_mu in (
            ("generator", t_state.params, p.port_params(j_state.params), p.port_params, t_state.opt_state_g,
             j_state.opt_state_g),
            ("discriminator", t_state.disc_params, p.port_disc_params(j_state.disc_params), p.port_disc_params,
             t_state.opt_state_d, j_state.opt_state_d)):
        grads = dict(zip(got, _adam_mu(mu)))  # after one step mu = (1 - b1) * gradient
        j_grads = {n: np.asarray(g) for n, g in port(_adam_mu(j_mu)).items()}
        assert_grads_close(grads, j_grads, f"{what} step gradient")
        # Adam's first step is about lr * sign(gradient): held where the gradient
        # stands above 1e-4 of the module's largest (below, its sign is rounding noise)
        floor = 1e-4 * max(float(np.abs(g).max()) for g in j_grads.values())
        for name, t in got.items():
            assert torch.isfinite(t).all(), name
            d = np.abs(t.detach().numpy() - np.asarray(want[name])) / LR
            d = d[np.abs(j_grads[name]) > floor]
            assert d.size == 0 or float(d.max()) <= 0.05, f"{what} {name}: max {float(d.max())} lr"
