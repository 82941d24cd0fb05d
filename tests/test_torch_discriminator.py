"""The port's MS-STFT discriminator and weight norm against funcodec_tpu, on the CPU.

The tiny discriminator of tests/test_shared_forward.py (4 filters, one
STFT scale of 256) gets the same numpy parameters in both packages
(compat/from_jax); the flagship's three scales are checked for structure. The JAX package runs its blocked-F tower by
default (``BLOCKED_F``: frequency bins folded into channels), whose fmaps
come back blocked; so the port's logits, losses and parameter gradients are
held against both settings, its fmaps against ``BLOCKED_F=False``. The
port lays features out NCHW, (B, C, T', F); JAX NHWC, (B, T', F, C).

Tolerances: logits and fmaps atol 1e-5 + rtol 2e-4 (the JAX test's own
blocked-vs-plain tolerance; fp32 FFT against DFT matmuls), losses rtol
1e-4, gradients 1e-4 + 2e-3 of the largest of a tensor; the weight-norm
fusion rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import funcodec_tpu.models.discriminators as jdisc_mod
from funcodec_tpu.ops import conv as jconv
from funcodec_tpu.tasks.codec import build_discriminator as jbuild_disc
from funcodec_tpu_torch.compat.from_jax import discriminator_state_dict_from_jax, torch_conv_weight
from funcodec_tpu_torch.models import discriminators as tdisc_mod
from funcodec_tpu_torch.ops import conv as tconv
from funcodec_tpu_torch.tasks.codec import build_discriminator as tbuild_disc

torch.set_num_threads(1)

TINY = {"disc_conf_list": [{"name": "encodec_multi_scale_stft_discriminator", "filters": 4,
                            "n_ffts": [256], "hop_lengths": [64], "win_lengths": [256]}]}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _pair(conf=TINY, seed=0):
    jd = jbuild_disc(conf)
    rs = np.random.RandomState(seed)

    def leaf(path, a):
        name = getattr(path[-1], "key", "")
        if name in ("kernel", "v"):
            return jnp.asarray(rs.uniform(-1, 1, a.shape) / np.sqrt(np.prod(a.shape[:-1])), a.dtype)
        if name == "g":
            return jnp.asarray(rs.uniform(0.5, 1.5, a.shape), a.dtype)
        return jnp.asarray(0.1 * rs.randn(*a.shape), a.dtype)

    params = jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(jd.init, jax.random.PRNGKey(0)))
    td = tbuild_disc(conf, device="cpu", generator=torch.Generator().manual_seed(0))
    td.load_state_dict(discriminator_state_dict_from_jax(_np(params)))
    return jd, params, td


def _signals(seed=0, T=4000):
    rs = np.random.RandomState(seed)
    return (0.3 * rs.randn(2, T)).astype(np.float32), (0.3 * rs.randn(2, T)).astype(np.float32)


def _losses(outs_r, outs_f, xp):
    """The hinge loss of the disc turn and the generator's adversarial and
    feature-matching losses, as models/encodec.py assembles them."""
    relu = (lambda v: jnp.maximum(v, 0.0)) if xp is jnp else torch.relu
    mean = (lambda v: jnp.mean(v)) if xp is jnp else (lambda v: v.mean())
    absf = jnp.abs if xp is jnp else torch.abs
    disc = sum(mean(relu(1.0 - r)) + mean(relu(1.0 + f)) for (r, _), (f, _) in zip(outs_r, outs_f)) / len(outs_r)
    adv = sum(mean(relu(1.0 - f)) for (f, _) in outs_f) / len(outs_f)
    feats = [mean(absf(a - b)) for (_, fr), (_, ff) in zip(outs_r, outs_f) for a, b in zip(fr, ff)]
    return disc, adv, sum(feats) / len(feats)


@pytest.fixture(scope="module")
def disc_pair():
    return _pair()


@pytest.fixture(scope="module")
def jax_runs(disc_pair):
    """{BLOCKED_F: (logits and fmaps of the real signal, losses), grads}."""
    jd, params, _ = disc_pair
    real, fake = _signals()
    runs = {}
    old = jdisc_mod.BLOCKED_F
    for blocked in (False, True):
        jdisc_mod.BLOCKED_F = blocked
        try:
            def f(p):
                outs_r, outs_f = jd(p, jnp.asarray(real)), jd(p, jnp.asarray(fake))
                disc, adv, feat = _losses(outs_r, outs_f, jnp)
                return disc + adv + feat, (outs_r, (disc, adv, feat))

            (_, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
        finally:
            jdisc_mod.BLOCKED_F = old
        runs[blocked] = aux, grads
    return runs


def _port_run(td):
    real, fake = _signals()
    outs_r, outs_f = td(torch.from_numpy(real)), td(torch.from_numpy(fake))
    disc, adv, feat = _losses(outs_r, outs_f, torch)
    names, params = zip(*td.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(disc + adv + feat, params)))
    return outs_r, (disc, adv, feat), grads


@pytest.mark.parametrize("blocked", [False, True], ids=["plain", "blocked_f"])
def test_logits_losses_and_grads_match_jax(disc_pair, jax_runs, blocked):
    _, _, td = disc_pair
    (j_outs, j_losses), j_grads = jax_runs[blocked]
    outs, losses, grads = _port_run(td)
    assert len(outs) == len(j_outs) == 1
    for (logits, _), (j_logits, _) in zip(outs, j_outs):
        np.testing.assert_allclose(logits.detach().numpy().transpose(0, 2, 3, 1), np.asarray(j_logits),
                                   atol=1e-5, rtol=2e-4)
    for got, want in zip(losses, j_losses):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    want = discriminator_state_dict_from_jax(_np(j_grads))
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 + 2e-3 * np.abs(w).max(), rtol=0,
                                   err_msg=f"{name} (BLOCKED_F={blocked})")


def test_fmaps_match_plain_jax(disc_pair, jax_runs):
    """Against BLOCKED_F=False: the blocked tower's fmaps are a TPU layout."""
    (j_outs, _), _ = jax_runs[False]
    outs, _, _ = _port_run(disc_pair[2])
    for (_, fmap), (_, j_fmap) in zip(outs, j_outs):
        assert len(fmap) == len(j_fmap) == 5
        for f, jf in zip(fmap, j_fmap):
            np.testing.assert_allclose(f.detach().numpy().transpose(0, 2, 3, 1), np.asarray(jf), atol=1e-5, rtol=2e-4)


def test_msstft_discriminator_structure():
    """3 scales, 5 fmaps each of 32 channels, 4D logits (the reference's
    inline test of encodec_disc.py, as tests/test_gan_training.py holds it)."""
    td = tbuild_disc(None, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 8000).astype(np.float32))
    with torch.no_grad():
        outs = td(x)
    assert len(outs) == 3
    for logits, fmap in outs:
        assert len(fmap) == 5
        assert all(f.shape[0] == 1 and f.shape[1] == 32 for f in fmap)
        assert logits.dim() == 4 and logits.shape[1] == 1 and torch.isfinite(logits).all()


def test_state_dict_names():
    td = tbuild_disc(None, device="cpu", generator=torch.Generator().manual_seed(0))
    want = set()
    for j in range(3):
        base = f"discriminators.0.discriminators.{j}"
        want |= {f"{base}.convs.0.conv.weight", f"{base}.convs.0.conv.bias"}
        for k in range(1, 5):
            want |= {f"{base}.convs.{k}.conv.{n}" for n in ("weight_g", "weight_v", "bias")}
        want |= {f"{base}.conv_post.conv.{n}" for n in ("weight_g", "weight_v", "bias")}
    assert set(td.state_dict()) == want
    assert td.state_dict()["discriminators.0.discriminators.0.convs.1.conv.weight_g"].shape == (32, 1, 1, 1)
    # a weight-normed SEANet conv names its halves the same way
    m = tconv.SConv1d(tconv.ConvSpec(4, 6, 3, norm="weight_norm"), device="cpu", generator=torch.Generator())
    assert set(m.state_dict()) == {"conv.conv.weight_g", "conv.conv.weight_v", "conv.conv.bias"}


def test_extra_discriminators_raise():
    conf = {"disc_conf_list": [{"name": "hifigan_multi_period_discriminator"}]}
    with pytest.raises(NotImplementedError, match="slice C"):
        tbuild_disc(conf, device="cpu", generator=torch.Generator())


@pytest.mark.parametrize("transposed", [False, True], ids=["conv1d", "conv_transpose1d"])
def test_weight_norm_fusion_1d_matches_jax(transposed):
    spec = dict(in_channels=6, out_channels=4, kernel_size=5, stride=2 if transposed else 1,
                norm="weight_norm", transposed=transposed)
    p = _np(jconv.init_conv(jax.random.PRNGKey(3), jconv.ConvSpec(**spec)))
    p["v"] = p["v"] * np.random.RandomState(0).uniform(0.5, 2.0, p["v"].shape).astype(np.float32)
    tspec = tconv.ConvSpec(**spec)
    m = tconv.make_conv(tspec, device="cpu", generator=torch.Generator())
    inner = "convtr" if transposed else "conv"
    layer = getattr(m, inner).layer
    with torch.no_grad():
        layer.weight_v.copy_(torch.from_numpy(torch_conv_weight(p["v"], tspec).copy()))
        layer.weight_g.copy_(torch.from_numpy(p["g"].reshape(-1, 1, 1)))
    want = torch_conv_weight(np.asarray(jconv.fused_kernel({k: jnp.asarray(v) for k, v in p.items()})), tspec)
    np.testing.assert_allclose(getattr(m, inner).weight().detach().numpy(), want, rtol=1e-6, atol=1e-7)
    # torch dim=0: per output channel of a forward conv, per input channel of a transposed one
    assert layer.weight_g.shape == (6 if transposed else 4, 1, 1)


def test_weight_norm_fusion_2d_matches_jax():
    spec = jdisc_mod.PlainConv2dSpec(4, 8, (3, 9), norm="weight_norm")
    p = _np(jdisc_mod.init_plain_conv2d(jax.random.PRNGKey(4), spec))
    p["g"] = p["g"] * np.random.RandomState(1).uniform(0.5, 2.0, p["g"].shape).astype(np.float32)
    want = np.asarray(jconv.fused_kernel({k: jnp.asarray(v) for k, v in p.items()})).transpose(3, 2, 0, 1)
    layer = tdisc_mod.init_plain_conv2d(tdisc_mod.PlainConv2dSpec(4, 8, (3, 9), norm="weight_norm"),
                                        device="cpu", generator=torch.Generator())
    with torch.no_grad():
        layer.weight_v.copy_(torch.from_numpy(p["v"].transpose(3, 2, 0, 1).copy()))
        layer.weight_g.copy_(torch.from_numpy(p["g"].reshape(-1, 1, 1, 1)))
    np.testing.assert_allclose(tconv.layer_weight(layer).detach().numpy(), want, rtol=1e-6, atol=1e-7)


def test_weight_norm_fusion_keeps_bf16_and_carries_grads():
    v = torch.randn(5, 3, 7, generator=torch.Generator().manual_seed(0)).requires_grad_()
    g = (torch.rand(5, 1, 1, generator=torch.Generator().manual_seed(1)) + 0.5).requires_grad_()
    w = tconv.weight_norm_fuse(v.to(torch.bfloat16), g.to(torch.bfloat16))
    assert w.dtype == torch.bfloat16
    dv, dg = torch.autograd.grad(w.float().sum(), (v, g))
    assert dv.dtype == dg.dtype == torch.float32 and torch.isfinite(dv).all()
    ref = v * g / v.detach().square().sum(dim=(1, 2), keepdim=True).sqrt()
    np.testing.assert_allclose(tconv.weight_norm_fuse(v, g).detach().numpy(), ref.detach().numpy(), rtol=1e-6)
