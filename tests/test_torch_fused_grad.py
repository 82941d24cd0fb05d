"""The backwards of the port's fused conv and resblock kernels, on the CPU.

On the CPU the wrappers' forwards are the kernels' plain versions and their
backwards are the ones the card runs. They are held against:

- funcodec_tpu's custom_vjp gradients of the Pallas kernels in interpret
  mode, at the cases of tests/test_conv_pallas.py:150 (C, T, dilation) and
  tests/test_resblock_pallas.py:100 (C = 128, T = 96);
- autograd through the port's own plain versions, over pad modes,
  activations, causal and dilated convs, bf16 inputs.

Tolerances: fp32 against JAX 3e-4 (conv, the JAX test's own) and 1e-3
(resblock, the JAX test's own); against autograd through the plain version
fp32 1e-5 relative to the largest gradient (summation order only); bf16
inputs 2e-2 of it (the forward's bf16 rounding points against the
backward's fp32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from funcodec_tpu.ops import conv as jconv
from funcodec_tpu.ops.conv_pallas import fused_conv1d_s1 as j_fused_conv
from funcodec_tpu.ops.pad import conv_padding_total, split_padding
from funcodec_tpu.ops.resblock_pallas import fused_resblock_tgn as j_fused_rb
from funcodec_tpu_torch.ops import conv as tconv
from funcodec_tpu_torch.ops import conv_kernel, resblock_kernel
from funcodec_tpu_torch.ops.pad import pad1d_time

torch.set_num_threads(1)


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# 2b: fused_conv1d_s1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C,T,dil", [(128, 100, 3), (16, 1600, 1)])
def test_conv_gradients_match_jax_custom_vjp(C, T, dil):
    O, K, B = 24, 3, 2
    rs = np.random.RandomState(0)
    x = rs.randn(B, T, C).astype(np.float32)
    bound = 1.0 / np.sqrt(C * K)
    kernel = rs.uniform(-bound, bound, (K, C, O)).astype(np.float32)
    bias = rs.uniform(-bound, bound, (O,)).astype(np.float32)
    cot = rs.randn(B, T, O).astype(np.float32)
    left, right = split_padding(conv_padding_total(K, 1, dil), False)

    def loss(xv, w, b):
        y = j_fused_conv(xv, w, b, left, right, dilation=dil, tile=512, interpret=True)
        return jnp.sum(y * cot)

    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 1, 0))).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = conv_kernel.fused_conv1d_s1(xt, wt, bt, left, right, dil)
    dx, dw, db = torch.autograd.grad((y * torch.from_numpy(cot.transpose(0, 2, 1).copy())).sum(), (xt, wt, bt))
    np.testing.assert_allclose(dx.numpy().transpose(0, 2, 1), np.asarray(jg[0]), atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(dw.numpy().transpose(2, 1, 0), np.asarray(jg[1]), atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(jg[2]), atol=3e-4, rtol=3e-4)


CONV_CASES = [
    # (Cin, Cout, K, dilation, causal, pad_mode, act, T)
    (8, 6, 3, 1, False, "reflect", "elu", 50),
    (8, 6, 3, 3, True, "replicate", "elu", 40),
    (4, 6, 7, 1, False, "reflect", None, 33),
    (6, 1, 7, 1, False, "reflect", "elu", 64),
    (1, 8, 7, 1, False, "constant", None, 64),
    (8, 8, 3, 2, False, "zero", "relu", 31),
    (8, 4, 5, 1, True, "reflect", "gelu", 29),
]


def _conv_case(case, dtype, seed=0):
    Cin, Cout, K, d, causal, mode, act, T = case
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(2, Cin, T).astype(np.float32)).to(dtype).requires_grad_()
    w = torch.from_numpy((rs.uniform(-1, 1, (Cout, Cin, K)) / np.sqrt(Cin * K)).astype(np.float32)).requires_grad_()
    b = torch.from_numpy((0.1 * rs.randn(Cout)).astype(np.float32)).requires_grad_()
    left, right = split_padding(conv_padding_total(K, 1, d), causal)
    cot = torch.from_numpy(rs.randn(2, Cout, T).astype(np.float32))
    return x, w, b, left, right, d, mode, act, cot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[f"{c[0]}-{c[1]}-k{c[2]}-d{c[3]}-{c[5]}-{c[6]}" for c in CONV_CASES])
def test_conv_backward_matches_autograd_of_the_plain_version(case, dtype):
    """conv1d_s1_backward against autograd through the same math in fp32
    (act(x) -> pad -> conv): dx in x's type, dw and db in theirs."""
    x, w, b, left, right, d, mode, act, cot = _conv_case(case, dtype)
    y = conv_kernel.fused_conv1d_s1(x, w, b, left, right, d, mode, act)
    assert type(y.grad_fn).__name__ == "_FusedConv1dS1Backward"
    got = torch.autograd.grad((y.float() * cot).sum(), (x, w, b))
    assert [g.dtype for g in got] == [dtype, torch.float32, torch.float32]

    xr = x.detach().float().requires_grad_()
    wr, br = w.detach().requires_grad_(), b.detach().requires_grad_()
    up = pad1d_time(conv_kernel.act_fp32(xr, act), (left, right), mode=mode)
    ref = torch.nn.functional.conv1d(up, wr, br, dilation=d)
    want = torch.autograd.grad((ref * cot).sum(), (xr, wr, br))
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    for g, r, name in zip(got, want, ("dx", "dw", "db")):
        _close(g.float().numpy(), r.numpy(), rel, name)


def test_conv_pad_transpose_is_the_adjoint():
    """<pad(u), v> == <u, pad^T(v)> for every pad mode, left and right pads."""
    rs = np.random.RandomState(1)
    for mode in ("reflect", "replicate", "constant", "zero"):
        for left, right in ((3, 2), (0, 4), (5, 0), (1, 1)):
            u = torch.from_numpy(rs.randn(2, 3, 9))
            v = torch.from_numpy(rs.randn(2, 3, 9 + left + right))
            lhs = (pad1d_time(u, (left, right), mode=mode) * v).sum()
            rhs = (u * conv_kernel.pad_transpose(v, left, right, mode)).sum()
            np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12, err_msg=f"{mode} {left} {right}")


# ---------------------------------------------------------------------------
# 3b: fused_resblock_tgn
# ---------------------------------------------------------------------------


def _block(C, K=3, dil=1, causal=False, pad_mode="reflect", seed=3):
    rs = np.random.RandomState(seed)
    kws = [dict(in_channels=C, out_channels=C // 2, kernel_size=K, dilation=dil),
           dict(in_channels=C // 2, out_channels=C, kernel_size=1), dict(in_channels=C, out_channels=C, kernel_size=1)]
    params, convs = [], []
    for kw in kws:
        kw.update(causal=causal, pad_mode=pad_mode, norm="time_group_norm")
        K_, Ci, Co = kw["kernel_size"], kw["in_channels"], kw["out_channels"]
        bound = 1.0 / np.sqrt(Ci * K_)
        p = {"kernel": rs.uniform(-bound, bound, (K_, Ci, Co)).astype(np.float32),
             "bias": rs.uniform(-bound, bound, (Co,)).astype(np.float32),
             "norm_scale": (1.0 + 0.3 * rs.randn(Co)).astype(np.float32),
             "norm_bias": (0.05 * rs.randn(Co)).astype(np.float32)}
        m = tconv.SConv1d(tconv.ConvSpec(**kw), device="cpu", generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            m.conv.conv.weight.copy_(torch.from_numpy(p["kernel"].transpose(2, 1, 0).copy()))
            m.conv.conv.bias.copy_(torch.from_numpy(p["bias"]))
            m.conv.norm.weight.copy_(torch.from_numpy(p["norm_scale"]))
            m.conv.norm.bias.copy_(torch.from_numpy(p["norm_bias"]))
        params.append(p)
        convs.append(m)
    return kws, params, convs


def test_resblock_gradients_match_jax_custom_vjp():
    """tests/test_resblock_pallas.py:100: d sum(y^2) / d (x, conv1's params)."""
    kws, params, convs = _block(128, seed=3)
    x = np.random.RandomState(11).randn(1, 96, 128).astype(np.float32)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    specs = [jconv.ConvSpec(**kw) for kw in kws]

    def loss(p1, xv):
        y = j_fused_rb(xv, p1, jp[1], jp[2], *specs, tile=32, interpret=True)
        return jnp.sum(y**2)

    g_p1, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp[0], jnp.asarray(x))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).requires_grad_()
    y = resblock_kernel.fused_resblock_tgn(xt, *convs)
    c1 = convs[0].conv
    got = torch.autograd.grad(y.square().sum(), (xt, c1.conv.weight, c1.conv.bias, c1.norm.weight, c1.norm.bias))
    want = (np.asarray(g_x).transpose(0, 2, 1), np.asarray(g_p1["kernel"]).transpose(2, 1, 0),
            g_p1["bias"], g_p1["norm_scale"], g_p1["norm_bias"])
    for g, w, name in zip(got, want, ("x", "kernel", "bias", "norm_scale", "norm_bias")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,dil,causal,pad_mode,T", [
    (16, 1, False, "reflect", 40), (32, 3, True, "replicate", 37), (8, 9, False, "constant", 50)])
def test_resblock_backward_reaches_every_parameter(C, dil, causal, pad_mode, T, dtype):
    """The Function's gradients equal autograd through resblock_chain, for x
    and all twelve conv and norm parameters."""
    _, _, convs = _block(C, dil=dil, causal=causal, pad_mode=pad_mode, seed=C)
    rs = np.random.RandomState(C + 1)
    x = torch.from_numpy(rs.randn(2, C, T).astype(np.float32)).to(dtype).requires_grad_()
    cot = torch.from_numpy(rs.randn(2, C, T).astype(np.float32))
    params = [p for m in convs for p in m.parameters()]
    assert len(params) == 12
    y = resblock_kernel.fused_resblock_tgn(x, *convs)
    assert type(y.grad_fn).__name__ == "_FusedResblockTGNBackward"
    got = torch.autograd.grad((y.float() * cot).sum(), [x, *params])
    ref = resblock_kernel.fused_resblock_tgn_reference(x, *convs)
    want = torch.autograd.grad((ref.float() * cot).sum(), [x, *params])
    assert got[0].dtype == dtype
    for g, w in zip(got, want):
        assert g is not None and torch.isfinite(g).all()
        _close(g.float().numpy(), w.float().numpy(), 1e-6, "resblock grad")


def test_fused_flags_train_a_seanet_stack():
    """With FUSED_STRIDE1 and FUSED_RESBLOCK on, a SEANet encoder's gradients
    equal those of the unfused stack (the backwards are the plain chain's)."""
    from funcodec_tpu_torch.models.seanet import SEANetConfig, SEANetEncoder

    cfg = SEANetConfig(n_filters=8, dimension=16, ratios=(4, 2), norm="time_group_norm")
    enc = SEANetEncoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 640).astype(np.float32))
    # a random cotangent: sum(y^2) of a group-normed output is nearly
    # constant, so its gradient is rounding noise
    cot = torch.from_numpy(rs.randn(2, 80, 16).astype(np.float32))
    grads = {}
    for fused in (False, True):
        old = tconv.FUSED_STRIDE1, tconv.FUSED_RESBLOCK
        tconv.FUSED_STRIDE1 = tconv.FUSED_RESBLOCK = fused
        try:
            y = enc(x)
            grads[fused] = torch.autograd.grad((y * cot).sum(), list(enc.parameters()))
        finally:
            tconv.FUSED_STRIDE1, tconv.FUSED_RESBLOCK = old
    for a, b in zip(grads[True], grads[False]):
        _close(a.numpy(), b.numpy(), 2e-4, "seanet grad")
