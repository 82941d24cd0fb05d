"""The port's HiFiGAN generator (models/hifigan_gen.py) against funcodec_tpu's, on the CPU.

Both packages build the generator of tests/test_hifigan_gen.py's parity
case (12 mels, 32 channels, upsampling 4·5) from one config; the JAX
values are seeded numpy (``jax.eval_shape`` + values), carried into the
port by ``compat/from_jax.hifigan_generator_state_dict_from_jax``.
Tolerance: the JAX test's, atol 2e-5 + rtol 2e-5 (fp32, summation order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from funcodec_tpu.models import hifigan_gen as jgen
from funcodec_tpu_torch.compat.from_jax import hifigan_generator_state_dict_from_jax
from funcodec_tpu_torch.models import hifigan_gen as tgen
from tests.test_torch_gan_step import np_tree

torch.set_num_threads(1)

PARITY = dict(in_channels=12, out_channels=1, channels=32, kernel_size=7, upsample_scales=(4, 5),
              upsample_kernel_sizes=(8, 10), resblock_kernel_sizes=(3, 5), resblock_dilations=((1, 3), (1, 3)))


def _seeded(tree, rs):
    def leaf(path, a):
        name = getattr(path[-1], "key", "")
        if name in ("kernel", "v"):
            return jnp.asarray(rs.uniform(-1, 1, a.shape) / np.sqrt(np.prod(a.shape[:-1])), a.dtype)
        if name == "g":
            return jnp.asarray(rs.uniform(0.5, 1.5, a.shape), a.dtype)
        return jnp.asarray(0.1 * rs.randn(*a.shape), a.dtype)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _pair(**kw):
    cfg = dict(PARITY, **kw)
    jm = jgen.HiFiGANGenerator(jgen.HiFiGANConfig(**cfg))
    params = _seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), np.random.RandomState(0))
    tm = tgen.HiFiGANGenerator(tgen.HiFiGANConfig(**cfg), device="cpu", generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(hifigan_generator_state_dict_from_jax(tm, np_tree(params)))
    return jm, params, tm


@pytest.mark.parametrize("kw", [{}, {"global_channels": 6}, {"use_weight_norm": False, "use_additional_convs": False}],
                         ids=["plain", "global", "no_weight_norm_no_additional"])
def test_generator_matches_jax(kw):
    jm, params, tm = _pair(**kw)
    rs = np.random.RandomState(1)
    c = rs.randn(2, 50, 12).astype(np.float32)  # JAX's (B, T, mels)
    g = rs.randn(2, 1, 6).astype(np.float32) if "global_channels" in kw else None
    y_j = np.asarray(jax.jit(jm)(params, jnp.asarray(c), None if g is None else jnp.asarray(g)))
    with torch.no_grad():
        y = tm(torch.from_numpy(c).transpose(1, 2),
               None if g is None else torch.from_numpy(g).transpose(1, 2)).numpy()
    assert y.shape == (2, 1, 50 * 20) and y_j.shape == (2, 50 * 20, 1)
    np.testing.assert_allclose(y, y_j.transpose(0, 2, 1), atol=2e-5, rtol=2e-5)


def test_default_config_upsamples_256():
    """The default vocoder (80 mels, 512 channels, 8·8·2·2): T frames -> T · 256 samples in [-1, 1]."""
    cfg = tgen.HiFiGANConfig()
    assert cfg.upsample_factor == 256 == jgen.HiFiGANConfig().upsample_factor
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jgen.HiFiGANConfig())
    tm = tgen.HiFiGANGenerator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = tm(torch.randn(1, 80, 6, generator=torch.Generator().manual_seed(1)))
    assert y.shape == (1, 1, 6 * 256)
    assert torch.isfinite(y).all() and float(y.abs().max()) <= 1.0


def test_state_dict_names_are_the_reference_names():
    """The names funcodec_tpu/compat/torch_import.import_hifigan_generator reads."""
    tm = tgen.HiFiGANGenerator(tgen.HiFiGANConfig(**PARITY, global_channels=6), device="cpu",
                               generator=torch.Generator())
    bases = ["input_conv", "output_conv.1", "global_conv"] + [f"upsamples.{i}.1" for i in range(2)]
    bases += [f"blocks.{k}.convs{s}.{j}.1" for k in range(4) for s in (1, 2) for j in range(2)]
    assert set(tm.state_dict()) == {f"{b}.{n}" for b in bases for n in ("weight_g", "weight_v", "bias")}
    # torch weight norm (dim 0): per input channel of a transposed conv
    assert tm.upsamples[0][1].weight_g.shape == (32, 1, 1)
    assert tm.input_conv.weight_g.shape == (32, 1, 1)


def test_init_normal_001_zero_bias():
    """N(0, 0.01) weights and zero biases (hifigan.py:252-262), from the generator given."""
    cfg = tgen.HiFiGANConfig(**PARITY)
    a = tgen.HiFiGANGenerator(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    b = tgen.HiFiGANGenerator(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    v = torch.cat([p.detach().reshape(-1) for n, p in a.named_parameters() if n.endswith("weight_v")])
    assert abs(float(v.std()) / 0.01 - 1) < 0.02
    assert all(float(p.detach().abs().max()) == 0 for n, p in a.named_parameters() if n.endswith("bias"))
