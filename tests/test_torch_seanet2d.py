"""The port's 2D streamable convs and 2D SEANet against funcodec_tpu, on the CPU.

Both packages take the same numpy-seeded weights (laid out by the JAX
init, traced for shapes only, carried into the port by compat/from_jax)
and the same inputs, in their own layouts: the JAX package's (B, F, T, C),
the port's (B, C, F, T). fp32; every comparison is summation order only:
pads exactly, convs within 1e-5, the 2D stacks within 1e-4.

The helpers (``seeded``, ``port_layers``, ``to_port``, ``to_jax``) are
shared by tests/test_torch_freqcodec*.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import funcodec_tpu.ops.conv as jconv
import funcodec_tpu.ops.pad as jpad
import funcodec_tpu_torch.models.seanet as tseanet
import funcodec_tpu_torch.ops.conv as tconv
import funcodec_tpu_torch.ops.pad as tpad
from funcodec_tpu.models import seanet2d as jseanet2d
from funcodec_tpu_torch.compat.from_jax import _layers
from funcodec_tpu_torch.models import seanet2d as tseanet2d
from funcodec_tpu_torch.models.seanet import LayerStack, _build_stack
from test_torch_gan_step import _values, np_tree

torch.set_num_threads(1)


def seeded(init, seed=0):
    """Numpy-seeded values (test_torch_gan_step's) in the tree
    jax.eval_shape(init, key) lays out."""
    return _values(jax.eval_shape(init, jax.random.PRNGKey(0)), np.random.RandomState(seed))


def port_layers(layers, params) -> LayerStack:
    """The port's stack of `layers` (the port's (kind, spec) list) with the
    JAX `params` carried in under the stack's names."""
    holder = torch.nn.Module()
    holder.model = _build_stack(layers, "cpu", torch.Generator().manual_seed(0))
    sd = {}
    _layers(sd, "model", layers, np_tree(params))
    holder.load_state_dict(sd)
    return holder.model.eval()


def to_port(x_bftc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x_bftc, (0, 3, 1, 2))))


def to_jax(y_bcft: torch.Tensor) -> np.ndarray:
    return np.transpose(y_bcft.detach().numpy(), (0, 2, 3, 1))


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# pad2d_freq_time / unpad2d_freq_time
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["reflect", "zero"])
@pytest.mark.parametrize("shape,pt,pf", [
    ((2, 9, 11, 3), (3, 2), (2, 1)),  # no fixup
    ((2, 2, 11, 3), (3, 2), (2, 3)),  # freq no longer than its pad: the fixup on freq only
    ((2, 9, 3, 3), (4, 1), (1, 1)),  # the fixup on time only
    ((1, 1, 2, 2), (3, 3), (2, 0)),  # both axes
], ids=["plain", "fixup_freq", "fixup_time", "fixup_both"])
def test_pad2d_freq_time_matches_jax(shape, pt, pf, mode):
    x = _x(shape)
    ref = np.asarray(jpad.pad2d_freq_time(jnp.asarray(x), pt, pf, mode=mode))
    out = tpad.pad2d_freq_time(to_port(x), pt, pf, mode=mode)
    np.testing.assert_array_equal(to_jax(out), ref)
    back = tpad.unpad2d_freq_time(out, pt, pf)
    np.testing.assert_array_equal(to_jax(back), x)
    np.testing.assert_array_equal(to_jax(back), np.asarray(jpad.unpad2d_freq_time(jnp.asarray(ref), pt, pf)))


# ---------------------------------------------------------------------------
# SConv2d / SConvTranspose2d
# ---------------------------------------------------------------------------


def _conv_pair(kw, x_shape, seed):
    """(JAX output, port output) of one conv spec on the same seeded input."""
    jspec, tspec = jconv.ConvSpec(**kw), tconv.ConvSpec(**kw)
    params = seeded(lambda k: jconv.init_conv(k, jspec), seed)
    x = _x(x_shape, seed + 1)
    ref = np.asarray(jax.jit(lambda p, v: jconv.apply_conv(jspec, p, v))(params, jnp.asarray(x)))
    stack = port_layers([("conv", tspec)], [params])
    conv = stack[0]
    assert isinstance(conv, tconv.SConvTranspose2d if tspec.transposed else tconv.SConv2d)
    with torch.no_grad():
        out = conv(to_port(x))
    return ref, to_jax(out)


NORMS = ["none", "weight_norm", "time_group_norm", "layer_norm"]
RATIOS = [-1, 1, 2]  # conv_group_ratio: 1, 4 and 2 groups at 8 channels


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("norm", NORMS)
def test_sconv2d_matches_jax(norm, ratio):
    """A SEANet 2D downsample conv: (8, 4) kernel, stride (4, 2), 8 -> 16
    channels, grouped as seanet2d._groups does, reflect-padded, ragged T."""
    groups = tseanet2d._groups(8, ratio)
    kw = dict(in_channels=8, out_channels=16, kernel_size=(8, 4), stride=(4, 2), groups=groups, norm=norm)
    ref, out = _conv_pair(kw, (2, 17, 13, 8), seed=3)
    assert out.shape == ref.shape == (2, 4, 7, 16)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kw,x_shape", [
    (dict(in_channels=6, out_channels=3, kernel_size=(3, 3), dilation=(1, 2), groups=3), (2, 9, 12, 6)),
    (dict(in_channels=4, out_channels=4, kernel_size=(3, 3), dilation=(1, 2), causal=True,
          norm="time_group_norm"), (1, 7, 10, 4)),
    (dict(in_channels=3, out_channels=4, kernel_size=(7, 7), pad_mode="zero"), (2, 8, 9, 3)),
    (dict(in_channels=4, out_channels=8, kernel_size=(4, 2), stride=(2, 1), causal=True, norm="layer_norm",
          groups=2), (2, 6, 5, 4)),
    (dict(in_channels=2, out_channels=2, kernel_size=(7, 7)), (1, 3, 4, 2)),  # reflect fixup on both axes
    (dict(in_channels=8, out_channels=8, kernel_size=(1, 1), groups=4, norm="time_group_norm"), (2, 5, 6, 8)),
], ids=["dilated_grouped", "causal_tgn", "zero_pad", "causal_strided_ln", "small_input", "pointwise_grouped"])
def test_sconv2d_cases_match_jax(kw, x_shape):
    ref, out = _conv_pair(kw, x_shape, seed=5)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("norm", NORMS)
def test_sconv_transpose2d_matches_jax(norm, ratio):
    """A SEANet 2D upsample conv: (8, 4) kernel, stride (4, 2), 16 -> 8
    channels, grouped by tr_conv_group_ratio, with the decoder's last
    out_padding ((0, 1), (0, 0)). The grouped weight_norm cases carry the
    JAX norm's fused weight (compat/from_jax)."""
    groups = tseanet2d._groups(16, ratio)
    kw = dict(in_channels=16, out_channels=8, kernel_size=(8, 4), stride=(4, 2), groups=groups, norm=norm,
              transposed=True, out_padding=((0, 1), (0, 0)))
    ref, out = _conv_pair(kw, (2, 3, 5, 16), seed=7)
    assert out.shape == ref.shape == (2, 13, 10, 8)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kw,x_shape", [
    (dict(in_channels=4, out_channels=4, kernel_size=(8, 4), stride=(4, 2), causal=True, trim_right_ratio=0.5,
          norm="time_group_norm"), (2, 2, 6, 4)),
    (dict(in_channels=6, out_channels=4, kernel_size=(4, 2), stride=(2, 1), groups=2,
          out_padding=((1, 0), (0, 1))), (1, 4, 7, 6)),
    (dict(in_channels=8, out_channels=4, kernel_size=(8, 2), stride=(4, 1), norm="layer_norm", causal=True),
     (2, 1, 5, 8)),
], ids=["causal_trim_half", "out_padding_both_axes", "causal_ln"])
def test_sconv_transpose2d_cases_match_jax(kw, x_shape):
    ref, out = _conv_pair(dict(kw, transposed=True), x_shape, seed=9)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_layer_norm_1d_matches_jax():
    """layer_norm on a 1D conv: a LayerNorm over the channels at each step."""
    kw = dict(in_channels=5, out_channels=6, kernel_size=3, norm="layer_norm")
    jspec, tspec = jconv.ConvSpec(**kw), tconv.ConvSpec(**kw)
    params = seeded(lambda k: jconv.init_conv(k, jspec), 11)
    x = _x((2, 13, 5), 12)
    ref = np.asarray(jax.jit(lambda p, v: jconv.apply_conv(jspec, p, v))(params, jnp.asarray(x)))
    conv = port_layers([("conv", tspec)], [params])[0]
    assert isinstance(conv.conv.norm, torch.nn.LayerNorm)
    with torch.no_grad():
        out = conv(torch.from_numpy(x.transpose(0, 2, 1).copy())).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_layer_norm_keeps_bf16():
    """Statistics in fp32, the result in y's type."""
    conv = tconv.make_conv(tconv.ConvSpec(4, 4, (3, 3), norm="layer_norm"), device="cpu",
                           generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    y = conv(torch.randn(2, 4, 5, 6).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


# ---------------------------------------------------------------------------
# the 2D SEANet encoder / decoder
# ---------------------------------------------------------------------------


def _cfg(cls, **kw):
    base = dict(input_size=3, dimension=16, n_filters=8, ratios=((4, 1), (4, 2)), norm="time_group_norm",
                dilation_base=1)
    base.update(kw)
    return cls(**base)


STACKS = [dict(seq_model="lstm"), dict(seq_model="transformer", seq_layer_num=1),
          dict(seq_model="lstm", conv_group_ratio=2, tr_conv_group_ratio=2),
          dict(seq_model="lstm", conv_group_ratio=1, tr_conv_group_ratio=1, norm="weight_norm"),
          dict(seq_model="transformer", seq_layer_num=1, causal=True, norm="layer_norm", activation="Snake")]
STACK_IDS = ["lstm", "transformer", "grouped_r2", "grouped_r1_wn", "causal_ln_snake_tfm"]


@pytest.mark.parametrize("kw", STACKS, ids=STACK_IDS)
def test_seanet_encoder2d_matches_jax(kw):
    jcfg, tcfg = _cfg(jseanet2d.SEANetConfig2d, **kw), _cfg(tseanet2d.SEANetConfig2d, **kw)
    jenc = jseanet2d.SEANetEncoder2d(jcfg)
    tenc = tseanet2d.SEANetEncoder2d(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert [k for k, _ in tenc.layers] == [k for k, _ in jenc.layers]
    params = seeded(jenc.init, 1)
    tenc.model = port_layers(tenc.layers, params)
    x = _x((2, 16, 21, 3), 2)  # (B, F, T, C): ragged T
    ref = np.asarray(jax.jit(jenc.__call__)(params, jnp.asarray(x)))
    with torch.no_grad():
        out = tenc(to_port(x)).numpy()
    assert out.shape == ref.shape == (2, 11, 16)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kw", STACKS, ids=STACK_IDS)
def test_seanet_decoder2d_matches_jax(kw):
    jcfg, tcfg = _cfg(jseanet2d.SEANetConfig2d, **kw), _cfg(tseanet2d.SEANetConfig2d, **kw)
    jdec = jseanet2d.SEANetDecoder2d(jcfg)
    tdec = tseanet2d.SEANetDecoder2d(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    params = seeded(jdec.init, 3)
    tdec.model = port_layers(tdec.layers, params)
    z = _x((2, 6, 16), 4)
    ref = np.asarray(jax.jit(jdec.__call__)(params, jnp.asarray(z)))
    with torch.no_grad():
        out = to_jax(tdec(torch.from_numpy(z)))
    assert out.shape == ref.shape == (2, 17, 12, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_config_from_conf_matches_jax():
    conf = {"ratios": [[4, 1], [4, 2]], "channels": 3, "norm_params": {"num_groups": 1},
            "last_out_padding": [[0, 1], [0, 0]], "activation_params": {"alpha": 1.0}, "unknown": 1,
            "conv_group_ratio": 8}
    j = jseanet2d.SEANetConfig2d.from_conf(conf, dimension=64)
    t = tseanet2d.SEANetConfig2d.from_conf(conf, dimension=64)
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == {f: getattr(j, f) for f in j.__dataclass_fields__}
    assert t.hop_length == j.hop_length == 2
    for n, r in ((32, 8), (16, 8), (64, 1), (8, -1)):
        assert tseanet2d._groups(n, r) == jseanet2d._groups(n, r)


def test_fused_kernels_leave_2d_layers_alone(monkeypatch):
    """With FUSED_STRIDE1 and FUSED_RESBLOCK on, the 2D stacks route no 2D
    layer to a fused kernel (JAX's _try_fused_resblock refuses x.ndim != 3):
    the resblock wrapper is never called and the fused conv only on the 1D
    tail (the encoder's ELU + last conv, the decoder's first conv), whose
    plain version on the CPU gives the unfused result."""
    cfg = _cfg(tseanet2d.SEANetConfig2d)
    gen = torch.Generator().manual_seed(0)
    enc = tseanet2d.SEANetEncoder2d(cfg, device="cpu", generator=gen)
    dec = tseanet2d.SEANetDecoder2d(cfg, device="cpu", generator=gen)
    x, z = torch.from_numpy(_x((2, 3, 16, 21), 5)), torch.from_numpy(_x((2, 6, 16), 6))
    with torch.no_grad():
        ref_e, ref_d = enc(x), dec(z)
    calls = {"conv": [], "resblock": []}

    def rec(kind, fn):
        def wrapper(x, *a, **k):
            calls[kind].append(tuple(x.shape))
            return fn(x, *a, **k)
        return wrapper

    monkeypatch.setattr(tconv, "fused_conv1d_s1", rec("conv", tconv.fused_conv1d_s1))
    monkeypatch.setattr(tseanet, "fused_resblock_tgn", rec("resblock", tseanet.fused_resblock_tgn))
    monkeypatch.setattr(tconv, "FUSED_STRIDE1", True)
    monkeypatch.setattr(tconv, "FUSED_RESBLOCK", True)
    with torch.no_grad():
        out_e, out_d = enc(x), dec(z)
    assert calls["resblock"] == []
    assert calls["conv"] == [(2, 32, 11), (2, 16, 6)]  # ELU + 32 -> 16 k7; 16 -> 32 k7
    np.testing.assert_allclose(out_e.numpy(), ref_e.numpy(), atol=1e-5)
    np.testing.assert_allclose(out_d.numpy(), ref_d.numpy(), atol=1e-5)


def test_snake_and_squeeze_layers():
    snake = tseanet.make_layer("snake", 3, device="cpu", generator=torch.Generator())
    with torch.no_grad():
        snake.alpha.copy_(torch.tensor([0.5, 1.0, 2.0]).reshape(1, 3, 1))
    x = torch.randn(2, 3, 4, 5)
    a = torch.tensor([0.5, 1.0, 2.0]).reshape(1, 3, 1, 1)
    torch.testing.assert_close(snake(x), x + torch.sin(a * x) ** 2 / (a + 1e-9))
    sq = tseanet.make_layer("squeeze", None, device="cpu", generator=torch.Generator())
    unsq = tseanet.make_layer("unsqueeze", None, device="cpu", generator=torch.Generator())
    y = torch.randn(2, 3, 1, 5)
    assert sq(y).shape == (2, 3, 5) and torch.equal(unsq(sq(y)), y)
    with pytest.raises(AssertionError):
        sq(torch.randn(2, 3, 2, 5))
