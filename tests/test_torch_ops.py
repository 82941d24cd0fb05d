"""funcodec_tpu_torch.ops against funcodec_tpu.ops, fp32 on the CPU.

The same numpy inputs go through the JAX function on (B, T, C) and the port
on torch's (B, C, T); JAX-initialized weights cross over through
compat/from_jax. Tolerance: atol 1e-5 in fp32 (summation order only).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from funcodec_tpu.ops import activations as jact
from funcodec_tpu.ops import conv as jconv
from funcodec_tpu.ops import pad as jpad
from funcodec_tpu.ops import rnn as jrnn
from funcodec_tpu_torch.compat.from_jax import torch_conv_weight
from funcodec_tpu_torch.ops import activations as tact
from funcodec_tpu_torch.ops import conv as tconv
from funcodec_tpu_torch.ops import pad as tpad
from funcodec_tpu_torch.ops.rnn import SLSTM

# one torch thread per test process: the suite runs in several processes at once,
# and the small CPU ops here gain nothing from more
torch.set_num_threads(1)

ATOL = 1e-5


def _btc(x: np.ndarray) -> torch.Tensor:
    """numpy (B, T, C) -> torch (B, C, T)."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def _to_btc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("length", [1, 3, 7, 40])
@pytest.mark.parametrize("kernel,stride,dilation", [(7, 1, 1), (4, 2, 1), (16, 8, 1), (3, 1, 4)])
@pytest.mark.parametrize("causal", [False, True])
def test_padding_arithmetic(length, kernel, stride, dilation, causal):
    total = tpad.conv_padding_total(kernel, stride, dilation)
    assert total == jpad.conv_padding_total(kernel, stride, dilation)
    assert tpad.extra_padding_for_conv1d(length, kernel, stride, total) == (
        jpad.extra_padding_for_conv1d(length, kernel, stride, total)
    )
    assert tpad.split_padding(total, causal) == jpad.split_padding(total, causal)


@pytest.mark.parametrize("mode", ["zero", "constant", "reflect", "replicate"])
@pytest.mark.parametrize(
    "length,paddings",
    [(12, (3, 2)), (12, (0, 5)), (3, (5, 2)), (2, (1, 6)), (4, (4, 4))],
    ids=["plain", "right", "small_left", "small_right", "edge"],
)
def test_pad1d_time(mode, length, paddings):
    """Includes the reflect small-input fixup (T <= max pad)."""
    x = np.random.RandomState(0).randn(2, length, 3).astype(np.float32)
    kw = {"value": 0.5} if mode == "constant" else {}
    ref = np.asarray(jpad.pad1d_time(jnp.asarray(x), paddings, mode=mode, **kw))
    out = _to_btc(tpad.pad1d_time(_btc(x), paddings, mode=mode, **kw))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        _to_btc(tpad.unpad1d_time(_btc(ref), paddings)), x
    )


def _conv_pair(spec_kw, seed):
    jspec = jconv.ConvSpec(**spec_kw)
    tspec = tconv.ConvSpec(**spec_kw)
    p = jconv.init_conv(jax.random.PRNGKey(seed), jspec)
    rs = np.random.RandomState(seed)
    if "norm_scale" in p:  # non-trivial affine so the norm's params are exercised
        p["norm_scale"] = jnp.asarray(1.0 + 0.1 * rs.randn(spec_kw["out_channels"]), jnp.float32)
        p["norm_bias"] = jnp.asarray(0.1 * rs.randn(spec_kw["out_channels"]), jnp.float32)
    tw = {
        "weight": torch.from_numpy(np.ascontiguousarray(torch_conv_weight(np.asarray(p["kernel"]), tspec))),
        "bias": torch.from_numpy(np.array(p["bias"])),
    }
    if "norm_scale" in p:
        tw["norm_scale"] = torch.from_numpy(np.array(p["norm_scale"]))
        tw["norm_bias"] = torch.from_numpy(np.array(p["norm_bias"]))
    return jspec, tspec, p, tw


SCONV_CASES = [
    dict(kernel_size=7),
    dict(kernel_size=4, stride=2),
    dict(kernel_size=8, stride=4),
    dict(kernel_size=10, stride=5),
    dict(kernel_size=16, stride=8),
    dict(kernel_size=3, dilation=2),
    dict(kernel_size=3, dilation=4),
    dict(kernel_size=1),
]


@pytest.mark.parametrize("case", SCONV_CASES, ids=lambda c: "-".join(f"{k[0]}{v}" for k, v in c.items()))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("norm", ["none", "time_group_norm"])
def test_apply_sconv1d(case, causal, norm):
    spec_kw = dict(in_channels=3, out_channels=5, causal=causal, norm=norm, **case)
    jspec, tspec, p, tw = _conv_pair(spec_kw, seed=len(SCONV_CASES))
    x = np.random.RandomState(1).randn(2, 37, 3).astype(np.float32)
    ref = np.asarray(jconv.apply_sconv1d(jspec, p, jnp.asarray(x)))
    out = _to_btc(tconv.apply_sconv1d(tspec, _btc(x), **tw))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("stride", [2, 4, 5, 8])
@pytest.mark.parametrize("causal,trim", [(False, 1.0), (True, 1.0), (True, 0.5)])
def test_apply_sconv_transpose1d(stride, causal, trim):
    spec_kw = dict(
        in_channels=6, out_channels=3, kernel_size=2 * stride, stride=stride,
        causal=causal, norm="time_group_norm", transposed=True, trim_right_ratio=trim,
    )
    jspec, tspec, p, tw = _conv_pair(spec_kw, seed=stride)
    x = np.random.RandomState(2).randn(2, 9, 6).astype(np.float32)
    ref = np.asarray(jconv.apply_sconv_transpose1d(jspec, p, jnp.asarray(x)))
    out = _to_btc(tconv.apply_sconv_transpose1d(tspec, _btc(x), **tw))
    assert out.shape == ref.shape == (2, 9 * stride, 3)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_group_norm(dtype):
    """Statistics in fp32 and the result cast back, in both dtypes."""
    rs = np.random.RandomState(3)
    y = (3.0 + 2.0 * rs.randn(2, 50, 4)).astype(np.float32)
    scale = (1.0 + 0.1 * rs.randn(4)).astype(np.float32)
    bias = (0.1 * rs.randn(4)).astype(np.float32)
    spec = dict(in_channels=4, out_channels=4, kernel_size=1, norm="time_group_norm")
    jdt = getattr(jnp, dtype)
    ref = jconv._apply_post_norm(
        jconv.ConvSpec(**spec),
        {"norm_scale": jnp.asarray(scale), "norm_bias": jnp.asarray(bias)},
        jnp.asarray(y).astype(jdt),
    )
    out = tconv.apply_post_norm(
        tconv.ConvSpec(**spec), _btc(y).to(getattr(torch, dtype)),
        torch.from_numpy(scale), torch.from_numpy(bias),
    )
    assert out.dtype == getattr(torch, dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    atol = ATOL if dtype == "float32" else 1e-2  # bf16 rounds the output
    np.testing.assert_allclose(_to_btc(out.float()), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("num_layers,skip", [(1, True), (2, True), (2, False)])
def test_slstm(num_layers, skip):
    dim = 6
    jp = jrnn.init_lstm(jax.random.PRNGKey(num_layers), dim, dim, num_layers)
    m = SLSTM(dim, num_layers, skip, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = {}
    for l, lp in enumerate(jp):
        sd[f"lstm.weight_ih_l{l}"] = torch.from_numpy(np.asarray(lp["w_ih"]).T.copy())
        sd[f"lstm.weight_hh_l{l}"] = torch.from_numpy(np.asarray(lp["w_hh"]).T.copy())
        sd[f"lstm.bias_ih_l{l}"] = torch.from_numpy(np.array(lp["b_ih"]))
        sd[f"lstm.bias_hh_l{l}"] = torch.from_numpy(np.array(lp["b_hh"]))
    m.load_state_dict(sd)
    x = np.random.RandomState(4).randn(2, 11, dim).astype(np.float32)
    ref = np.asarray(jrnn.apply_slstm(jp, jnp.asarray(x), skip=skip))
    with torch.no_grad():
        out = _to_btc(m(_btc(x)))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "name,kwargs",
    [("ELU", {"alpha": 1.0}), ("elu", {"alpha": 0.5}), ("LeakyReLU", {"negative_slope": 0.2}),
     ("relu", {}), ("tanh", {}), ("sigmoid", {}), ("silu", {}), ("gelu", {})],
)
def test_activations(name, kwargs):
    x = np.random.RandomState(5).randn(3, 17).astype(np.float32) * 2
    ref = np.asarray(jact.get_activation_fn(name, **kwargs)(jnp.asarray(x)))
    out = tact.get_activation_fn(name, **kwargs)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_snake_and_unknown_activation():
    rs = np.random.RandomState(6)
    x = rs.randn(2, 9, 4).astype(np.float32)
    alpha = (1.0 + 0.2 * rs.randn(4)).astype(np.float32)
    ref = np.asarray(jact.snake(jnp.asarray(x), jnp.asarray(alpha)))
    out = tact.snake(_btc(x), torch.from_numpy(alpha).view(1, 4, 1))
    np.testing.assert_allclose(_to_btc(out), ref, atol=ATOL, rtol=0)
    with pytest.raises(ValueError):
        tact.get_activation_fn("snake")
    with pytest.raises(ValueError):
        tact.get_activation_fn("nope")


@pytest.mark.parametrize("norm", ["weight_norm", "layer_norm"])
def test_unported_norms_raise(norm):
    """layer_norm (ROADMAP.md slice C) raises; weight_norm, which raised until
    the training slice ported it, builds with the reference weight_g/weight_v."""
    spec = tconv.ConvSpec(2, 2, 3, norm=norm)
    if norm == "weight_norm":
        m = tconv.SConv1d(spec, device="cpu", generator=torch.Generator())
        assert set(m.state_dict()) == {"conv.conv.weight_g", "conv.conv.weight_v", "conv.conv.bias"}
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tconv.SConv1d(spec, device="cpu", generator=torch.Generator())
