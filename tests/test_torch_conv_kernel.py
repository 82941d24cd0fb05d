"""ops/conv_kernel (the fused stride-1 conv's wrapper and plain version) against
funcodec_tpu/ops/conv_pallas.fused_conv1d_s1 in interpret mode, on the CPU.

The same numpy inputs go through JAX on (B, T, C) and the port on (B, C, T);
weights cross over with the (K, C, O) -> (O, C, K) layout change. Tolerances:
fp32 atol = rtol = 2e-5 (the JAX test's own, summation order only); bf16
atol 1e-2, rtol 1.6e-2 (about two bf16 ulps: the same rounding points, a
different summation order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from funcodec_tpu.ops.conv_pallas import fused_conv1d_s1 as j_fused
from funcodec_tpu.ops.pad import conv_padding_total, split_padding
from funcodec_tpu_torch.ops import conv as tconv
from funcodec_tpu_torch.ops import conv_kernel

# one torch thread per test process: the suite runs in several processes at once,
# and the small CPU ops here gain nothing from more
torch.set_num_threads(1)

CASES = [
    # (T, K, dil, causal, pad_mode, C, tile, act): the cases of tests/test_conv_pallas.py
    *[(200, 3, 1, c, m, 128, 64, None) for c in (True, False) for m in ("reflect", "replicate", "constant")],
    *[(T, 3, 1, False, "reflect", 128, 64, None) for T in (64, 65, 127, 128, 129, 200, 250)],
    *[(300, 3, d, c, "reflect", 128, 64, None) for d in (1, 3, 9) for c in (True, False)],
    (333, 7, 1, False, "reflect", 128, 64, None),
    (333, 7, 1, True, "replicate", 128, 64, None),
    *[(1600, 3, 1, c, "reflect", C, 512, None) for C in (16, 32, 64) for c in (True, False)],
    *[(1600, 3, d, False, "reflect", 32, 512, None) for d in (3, 9)],
    (1504, 3, 1, False, "reflect", 32, 512, None),
    (1504, 7, 1, True, "replicate", 64, 512, None),
    (200, 3, 1, False, "reflect", 128, 64, "elu"),
    (1600, 3, 1, False, "reflect", 32, 512, "elu"),
]


def _case_id(case):
    T, K, d, causal, mode, C, _, act = case
    return f"T{T}-k{K}-d{d}-{'causal' if causal else 'sym'}-{mode}-C{C}" + (f"-{act}" if act else "")


def _inputs(B, T, C, O, K, seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, C).astype(np.float32)
    bound = 1.0 / np.sqrt(C * K)
    kernel = rs.uniform(-bound, bound, (K, C, O)).astype(np.float32)
    bias = rs.uniform(-bound, bound, (O,)).astype(np.float32)
    return x, kernel, bias


def _port(x, kernel, bias, dtype=torch.float32):
    """numpy (B, T, C), (K, C, O), (O,) -> torch (B, C, T), (O, C, K), (O,)."""
    return (
        torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).to(dtype),
        torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 1, 0))),
        torch.from_numpy(bias),
    )


def _btc(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().transpose(0, 2, 1)


def _split(K, dil, causal):
    return split_padding(conv_padding_total(K, 1, dil), causal)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_version_matches_jax_kernel(case):
    T, K, dil, causal, pad_mode, C, tile, act = case
    x, kernel, bias = _inputs(2, T, C, 24, K, seed=T + K + dil)
    left, right = _split(K, dil, causal)
    ref = j_fused(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), left, right,
                  dilation=dil, pad_mode=pad_mode, act=act, tile=tile, interpret=True)
    assert ref is not None
    before = conv_kernel.LAUNCHES
    out = conv_kernel.fused_conv1d_s1(*_port(x, kernel, bias), left, right, dil, pad_mode, act)
    assert conv_kernel.LAUNCHES == before  # a CPU tensor takes the plain version
    np.testing.assert_allclose(_btc(out), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_bf16_matches_jax_kernel():
    T, C, O, K = 1600, 32, 32, 3
    x, kernel, bias = _inputs(2, T, C, O, K, seed=1)
    ref = j_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(kernel), jnp.asarray(bias), 1, 1,
                  act="elu", tile=512, interpret=True)
    out = conv_kernel.fused_conv1d_s1(*_port(x, kernel, bias, torch.bfloat16), 1, 1, act="elu")
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_btc(out), np.asarray(ref, np.float32), atol=1e-2, rtol=1.6e-2)


@pytest.mark.parametrize(
    "K,left,right,pad_mode,T",
    [(1, 0, 0, "reflect", 16), (3, 1, 2, "reflect", 64), (3, 1, 1, "circular", 64), (7, 3, 3, "reflect", 3)],
    ids=["k1", "pad_sum", "pad_mode", "small_input"],
)
def test_semantic_gates_return_none_in_both(K, left, right, pad_mode, T):
    x, kernel, bias = _inputs(1, T, 128, 8, K, seed=2)
    assert j_fused(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), left, right,
                   pad_mode=pad_mode, interpret=True) is None
    assert conv_kernel.fused_conv1d_s1(*_port(x, kernel, bias), left, right, 1, pad_mode) is None


@pytest.mark.parametrize(
    "T,C,act",
    [(101, 32, None), (250, 32, "elu"), (97, 1, None), (64, 3, "elu")],
    ids=["ragged_packed", "ragged_elu", "cin1", "cin3_elu"],
)
def test_tiling_gates_are_dropped(T, C, act):
    """Shapes JAX declines for its TPU tiling (T % f, C < MIN_C) are
    accepted and match the port's unfused path."""
    K, O = 7, 5
    x, kernel, bias = _inputs(2, T, C, O, K, seed=3)
    left, right = _split(K, 1, False)
    assert j_fused(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), left, right,
                   act=act, interpret=True) is None
    xt, w, b = _port(x, kernel, bias)
    out = conv_kernel.fused_conv1d_s1(xt, w, b, left, right, act=act)
    spec = tconv.ConvSpec(C, O, K)
    ref = tconv.apply_sconv1d(spec, torch.nn.functional.elu(xt) if act else xt, w, b)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)


def test_apply_sconv1d_routes_through_the_fused_conv(monkeypatch):
    """FUSED_STRIDE1: apply_sconv1d and apply_sconv1d_act give the unfused
    result (time_group_norm after the fused conv)."""
    x, kernel, bias = _inputs(2, 120, 16, 8, 3, seed=4)
    xt, w, b = _port(x, kernel, bias)
    spec = tconv.ConvSpec(16, 8, 3, dilation=2, causal=True, norm="time_group_norm")
    g, be = torch.linspace(0.5, 1.5, 8), torch.linspace(-0.1, 0.1, 8)
    ref = tconv.apply_sconv1d(spec, xt, w, b, g, be)
    ref_act = tconv.apply_sconv1d(spec, torch.nn.functional.elu(xt), w, b, g, be)
    monkeypatch.setattr(tconv, "FUSED_STRIDE1", True)
    calls = []
    real = conv_kernel.fused_conv1d_s1_reference
    monkeypatch.setattr(conv_kernel, "fused_conv1d_s1_reference", lambda *a, **k: calls.append(1) or real(*a, **k))
    np.testing.assert_allclose(tconv.apply_sconv1d(spec, xt, w, b, g, be).numpy(), ref.numpy(), atol=2e-5)
    np.testing.assert_allclose(tconv.apply_sconv1d_act(spec, xt, w, b, g, be).numpy(), ref_act.numpy(), atol=2e-5)
    assert len(calls) == 2


def test_requires_grad_raises():
    x, kernel, bias = _inputs(1, 64, 8, 8, 3, seed=5)
    xt, w, b = _port(x, kernel, bias)
    w.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="slice B"):
        conv_kernel.fused_conv1d_s1(xt, w, b, 1, 1)
    with torch.no_grad():
        assert conv_kernel.fused_conv1d_s1(xt, w, b, 1, 1) is not None


def test_other_devices_raise():
    x = torch.zeros(1, 4, 32, device="meta")
    with pytest.raises(ValueError, match="device"):
        conv_kernel.fused_conv1d_s1(x, torch.zeros(4, 4, 3, device="meta"), None, 1, 1)
