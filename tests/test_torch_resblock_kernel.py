"""ops/resblock_kernel (the whole-resblock kernel's wrapper and plain version)
against funcodec_tpu/ops/resblock_pallas.fused_resblock_tgn in interpret mode,
on the CPU.

The same numpy weights and inputs go through JAX on (B, T, C) and the port
on (B, C, T). Tolerances: fp32 atol 2e-4, rtol 1e-3 (the JAX test's own);
bf16 atol 1e-2, rtol 1.6e-2 (about two bf16 ulps: the same rounding points,
a different summation order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from funcodec_tpu.ops import conv as jconv
from funcodec_tpu.ops.resblock_pallas import fused_resblock_tgn as j_fused
from funcodec_tpu_torch.models.seanet import SEANetResnetBlock
from funcodec_tpu_torch.ops import conv as tconv
from funcodec_tpu_torch.ops import resblock_kernel

# one torch thread per test process: the suite runs in several processes at once,
# and the small CPU ops here gain nothing from more
torch.set_num_threads(1)


def _specs(C, K=3, dil=1, causal=False, pad_mode="reflect", norm="time_group_norm", H=None):
    H = H or C // 2
    return [
        dict(in_channels=C, out_channels=H, kernel_size=K, dilation=dil, causal=causal, norm=norm, pad_mode=pad_mode),
        dict(in_channels=H, out_channels=C, kernel_size=1, causal=causal, norm=norm, pad_mode=pad_mode),
        dict(in_channels=C, out_channels=C, kernel_size=1, causal=causal, norm=norm, pad_mode=pad_mode),
    ]


def _params(spec_kws, seed, bias1=0.0):
    """numpy {kernel (K, C, O), bias, norm_scale, norm_bias} per conv."""
    rs = np.random.RandomState(seed)
    out = []
    for i, kw in enumerate(spec_kws):
        K, C, O = kw["kernel_size"], kw["in_channels"], kw["out_channels"]
        bound = 1.0 / np.sqrt(C * K)
        out.append({
            "kernel": rs.uniform(-bound, bound, (K, C, O)).astype(np.float32),
            "bias": (rs.uniform(-bound, bound, (O,)) + (bias1 if i == 0 else 0.0)).astype(np.float32),
            "norm_scale": (1.0 + 0.3 * rs.randn(O)).astype(np.float32),
            "norm_bias": (0.05 * rs.randn(O)).astype(np.float32),
        })
    return out


def _port_convs(spec_kws, params):
    convs = []
    for kw, p in zip(spec_kws, params):
        m = tconv.SConv1d(tconv.ConvSpec(**kw), device="cpu", generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            m.conv.conv.weight.copy_(torch.from_numpy(p["kernel"].transpose(2, 1, 0).copy()))
            m.conv.conv.bias.copy_(torch.from_numpy(p["bias"]))
            m.conv.norm.weight.copy_(torch.from_numpy(p["norm_scale"]))
            m.conv.norm.bias.copy_(torch.from_numpy(p["norm_bias"]))
        convs.append(m)
    return convs


def _jax(x, spec_kws, params, tile, dtype=jnp.float32):
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    specs = [jconv.ConvSpec(**kw) for kw in spec_kws]
    y = j_fused(jnp.asarray(x, dtype), *jp, *specs, tile=tile, interpret=True)
    assert y is not None
    return np.asarray(y, np.float32)


def _port(x, convs, dtype=torch.float32):
    # the modules stay fp32, as the JAX side's params: both cast the conv
    # weights to x's type and keep biases and norm affines in fp32
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).to(dtype)
    before = resblock_kernel.LAUNCHES
    with torch.no_grad():
        y = resblock_kernel.fused_resblock_tgn(xt, *convs)
    assert resblock_kernel.LAUNCHES == before  # a CPU tensor takes the plain version
    return y


CASES = [
    # (C, T, K, dil, causal, tile): the cases of tests/test_resblock_pallas.py
    (128, 192, 3, 1, False, 64),
    (32, 512, 3, 1, False, 32),
    (64, 400, 3, 1, False, 40),
    (128, 160, 3, 1, True, None),
    (128, 160, 3, 1, False, None),
    (128, 320, 3, 2, False, 64),
    (128, 200, 3, 1, False, None),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"C{c[0]}-T{c[1]}-d{c[3]}" + ("-causal" if c[4] else ""))
def test_plain_version_matches_jax_kernel(case):
    C, T, K, dil, causal, tile = case
    kws = _specs(C, K, dil, causal)
    params = _params(kws, seed=C + T)
    x = np.random.RandomState(7).randn(2, T, C).astype(np.float32)
    ref = _jax(x, kws, params, tile)
    out = _port(x, _port_convs(kws, params))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 1), ref, atol=2e-4, rtol=1e-3)


def test_bf16_matches_jax_kernel():
    kws = _specs(128)
    params = _params(kws, seed=1)
    x = np.random.RandomState(8).randn(2, 192, 128).astype(np.float32)
    ref = _jax(x, kws, params, 64, jnp.bfloat16)
    out = _port(x, _port_convs(kws, params), torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy().transpose(0, 2, 1), ref, atol=1e-2, rtol=1.6e-2)


def test_large_mean_statistics():
    """conv1's output has a mean far above its spread (bias 30), where the
    single-pass variance E[y^2] - mu^2 cancels; fp64 sums keep the plain
    version on the unfused path's mean-then-variance result."""
    kws = _specs(64)
    params = _params(kws, seed=2, bias1=30.0)
    x = np.random.RandomState(9).randn(2, 256, 64).astype(np.float32)
    convs = _port_convs(kws, params)
    out = _port(x, convs)
    block = _block(convs)
    with torch.no_grad():
        ref = block(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-4, rtol=1e-3)


def _block(convs):
    """A SEANetResnetBlock [ELU, conv1, ELU, conv2] + shortcut holding `convs`."""
    act = ("act", ("ELU", (("alpha", 1.0),)))
    spec = ((act, ("conv", convs[0].spec), act, ("conv", convs[1].spec)), convs[2].spec)
    block = SEANetResnetBlock(spec, device="cpu", generator=torch.Generator().manual_seed(0))
    for mod, conv in ((block.block[1], convs[0]), (block.block[3], convs[1]), (block.shortcut, convs[2])):
        mod.load_state_dict(conv.state_dict())
    return block.to(convs[0].conv.conv.weight.dtype)


@pytest.mark.parametrize(
    "kw,T",
    [(dict(norm="none"), 64), (dict(K=1), 64), (dict(pad_mode="circular"), 64), (dict(), 1)],
    ids=["norm_none", "k1", "pad_mode", "small_input"],
)
def test_semantic_gates_return_none_in_both(kw, T):
    kws = _specs(128, **kw)
    params = _params(kws, seed=3)
    if kws[0]["norm"] == "none":
        for p in params:
            p.pop("norm_scale"), p.pop("norm_bias")
    x = np.zeros((1, T, 128), np.float32)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    specs = [jconv.ConvSpec(**k) for k in kws]
    assert j_fused(jnp.asarray(x), *jp, *specs, interpret=True) is None
    convs = [tconv.SConv1d(tconv.ConvSpec(**k), device="cpu", generator=torch.Generator()) for k in kws]
    assert resblock_kernel.fused_resblock_tgn(torch.zeros(1, 128, T), *convs) is None


def test_width_above_the_kernels_tile_returns_none():
    kws = _specs(320)
    convs = [tconv.SConv1d(tconv.ConvSpec(**k), device="cpu", generator=torch.Generator()) for k in kws]
    assert resblock_kernel.fused_resblock_tgn(torch.zeros(1, 320, 64), *convs) is None


@pytest.mark.parametrize("C,T,causal", [(128, 250, False), (32, 201, True)], ids=["T250", "T201_causal"])
def test_ragged_lengths_match_the_unfused_block(C, T, causal, monkeypatch):
    """Lengths JAX declines for its tiling (not a multiple of 8, or of the
    packing factor) are accepted, and the fused block (plain version on the
    CPU) matches the port's unfused block."""
    kws = _specs(C, causal=causal)
    params = _params(kws, seed=4)
    x = np.random.RandomState(10).randn(1, T, C).astype(np.float32)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    assert j_fused(jnp.asarray(x), *jp, *[jconv.ConvSpec(**k) for k in kws], interpret=True) is None
    block = _block(_port_convs(kws, params))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
    with torch.no_grad():
        ref = block(xt)
        monkeypatch.setattr(tconv, "FUSED_RESBLOCK", True)
        out = block(xt)
        assert block._fused(xt) is not None
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-4, rtol=1e-3)


def test_requires_grad_raises():
    """Parameters that require grad used to raise (the kernel was forward
    only); the call is now the differentiable Function, whose backward
    (tests/test_torch_fused_grad.py) reaches every parameter."""
    kws = _specs(32)
    convs = _port_convs(kws, _params(kws, seed=5))
    x = torch.from_numpy(np.random.RandomState(5).randn(1, 32, 64).astype(np.float32))
    y = resblock_kernel.fused_resblock_tgn(x, *convs)  # the modules' parameters require grad
    assert type(y.grad_fn).__name__ == "_FusedResblockTGNBackward"
    params = [p for m in convs for p in m.parameters()]
    grads = torch.autograd.grad(y.square().sum(), params)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    with torch.no_grad():
        assert resblock_kernel.fused_resblock_tgn(x, *convs) is not None


def test_other_devices_raise():
    kws = _specs(32)
    convs = [tconv.SConv1d(tconv.ConvSpec(**k), device="meta", generator=None) for k in kws]
    with torch.no_grad(), pytest.raises(ValueError, match="device"):
        resblock_kernel.fused_resblock_tgn(torch.zeros(1, 32, 64, device="meta"), *convs)


def test_finalize_affine_is_the_group_norm_affine():
    rs = np.random.RandomState(6)
    y = torch.from_numpy((5.0 + 0.5 * rs.randn(3, 4, 50)).astype(np.float32))
    g, b = torch.linspace(0.5, 2.0, 4), torch.linspace(-1.0, 1.0, 4)
    yd = y.double()
    a, d = resblock_kernel.finalize_affine(yd.sum((1, 2)), (yd * yd).sum((1, 2)), 200, g, b)
    ref = torch.nn.functional.group_norm(y, 1, g, b, eps=1e-5)
    np.testing.assert_allclose((y * a[:, :, None] + d[:, :, None]).numpy(), ref.numpy(), atol=1e-5)
