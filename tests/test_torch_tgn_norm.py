"""time_group_norm outside the residual blocks (ops/tgn_kernel.py), on the CPU.

The kernels run only on a card (tests/test_torch_kernels.py and
chip_smoke.py hold them against the plain version there). Here: the plain
version against today's fp32 ``F.group_norm`` chain and a float64 group
norm, in fp32 and bf16, on 1D, 2D and trimmed outputs; the kernels'
statistics algorithm (per-thread fp32 corrected two passes, combined in
fp64) replayed in Python on rows whose mean is large against their spread;
and the routing of ops/conv.py, which keeps the CPU and the grad path on the
chain.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from funcodec_tpu_torch.ops import conv as tconv
from funcodec_tpu_torch.ops import tgn_kernel
from funcodec_tpu_torch.ops.conv import ConvSpec, apply_post_norm, make_conv
from funcodec_tpu_torch.ops.pad import unpad1d_time

torch.set_num_threads(1)

SPEC = ConvSpec(4, 4, 3, norm="time_group_norm")


def _chain(y, gamma, beta):
    """Today's chain: ATen's group norm on an fp32 copy, cast back."""
    return F.group_norm(y.float(), 1, gamma.float(), beta.float(), eps=1e-5).to(y.dtype)


def _float64(y, gamma, beta):
    return F.group_norm(y.double(), 1, gamma.double(), beta.double(), eps=1e-5)


def _ulp(ref: torch.Tensor, dtype) -> float:
    """One ulp of `dtype` at the largest |value| of ref (the output's scale)."""
    scale = float(ref.abs().max())
    return 2.0 ** (np.floor(np.log2(scale)) - (7 if dtype == torch.bfloat16 else 23))


def _case(shape, dtype, seed, mean=0.0, spread=1.0, param_dtype=None):
    rs = np.random.RandomState(seed)
    y = torch.from_numpy((mean + spread * rs.randn(*shape)).astype(np.float32)).to(dtype)
    C = shape[1]
    gamma = torch.from_numpy(1 + rs.uniform(-0.5, 0.5, C).astype(np.float32)).to(param_dtype or dtype)
    beta = torch.from_numpy(rs.uniform(-0.1, 0.1, C).astype(np.float32)).to(param_dtype or dtype)
    return y, gamma, beta


SHAPES = {
    "1d": (2, 5, 37),
    "1d-c1-ragged": (3, 1, 97),  # C = 1, a row not a whole number of 16-byte vectors
    "1d-tiles": (2, 3, 12_000),  # three statistics tiles, the last ragged
    "2d": (2, 4, 6, 9),  # (B, C, F, T)
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_version_matches_the_chain_and_float64(name, dtype):
    y, gamma, beta = _case(SHAPES[name], dtype, seed=1)
    got = tgn_kernel.time_group_norm_reference(y, gamma, beta)
    assert got.dtype == dtype and got.shape == y.shape and got.is_contiguous()
    exact = _float64(y, gamma, beta)
    chain = _chain(y, gamma, beta)
    # fp32: the statistics in fp64 and one rounding; bf16: one rounding of a value within fp32 noise
    tol = _ulp(exact, dtype) * (1.0 if dtype == torch.bfloat16 else 4.0)
    assert float((got.double() - exact).abs().max()) <= tol
    assert float((got.double() - chain.double()).abs().max()) <= 2 * tol


def test_plain_version_reads_bf16_affines_in_their_own_type():
    y, gamma, beta = _case((2, 6, 50), torch.float32, seed=2, param_dtype=torch.bfloat16)
    got = tgn_kernel.time_group_norm_reference(y, gamma, beta)
    want = tgn_kernel.time_group_norm_reference(y, gamma.float(), beta.float())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("trim", [(1, 1), (3, 2), (0, 4)])
def test_trimmed_output_is_the_unpadded_norm_and_contiguous(dtype, trim):
    """A transposed conv's trim: statistics over the whole output, only the
    kept window written."""
    y, gamma, beta = _case((2, 3, 45), dtype, seed=3)
    got = tgn_kernel.time_group_norm_reference(y, gamma, beta, trim)
    want = unpad1d_time(tgn_kernel.time_group_norm_reference(y, gamma, beta), trim)
    assert got.is_contiguous() and got.shape == (2, 3, 45 - sum(trim))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    y, gamma, beta = _case((2, 4, 6, 9), torch.float32, seed=4)
    with pytest.raises(ValueError, match="trim"):
        tgn_kernel.time_group_norm(y, gamma, beta, (1, 1))  # 2D
    with pytest.raises(ValueError, match="trim"):
        tgn_kernel.time_group_norm(y[:, :, 0], gamma, beta, (5, 4))  # keeps nothing
    with pytest.raises(ValueError, match="gamma"):
        tgn_kernel.time_group_norm(y, gamma[:3], beta)
    with pytest.raises(ValueError, match="device"):
        tgn_kernel.time_group_norm(y.to("meta"), gamma.to("meta"), beta.to("meta"))


# -- the kernels' statistics, replayed ----------------------------------------

THREADS, PER_THREAD = 256, 64  # csrc/tgn_norm.cu


def _kernel_statistics(x: torch.Tensor):
    """(mean, var) of each row of x (B, R) as tgn_stats and tgn_apply take
    them on the vector path: thread t of a tile holds elements
    (t + 256 j) * N + i, sums them in fp32 in that order, takes M2 around its
    fp32 mean m with the correction term (q by fma) and its mean as
    m + c / n in fp64, and the tiles and the row combine the threads'
    (n, mean, M2) in fp64 around the tile's and the row's mean."""
    B, R = x.shape
    N = 16 // x.element_size()
    assert R % N == 0
    tile = tgn_kernel.TILE
    n_tiles = -(-R // tile)
    xf = torch.zeros(B, n_tiles * tile)
    xf[:, :R] = x.float()
    valid = torch.zeros(B, n_tiles * tile, dtype=torch.bool)
    valid[:, :R] = True

    def per_thread(t):  # (B, n_tiles * tile) -> (B, n_tiles, THREADS, PER_THREAD), columns in j, i order
        t = t.reshape(B, n_tiles, PER_THREAD // N, THREADS, N)
        return t.permute(0, 1, 3, 2, 4).reshape(B, n_tiles, THREADS, PER_THREAD)

    v, m = per_thread(xf), per_thread(valid)
    s = torch.zeros(B, n_tiles, THREADS)
    for k in range(PER_THREAD):
        s = s + v[..., k]
    cnt = m.sum(-1).float()
    mean_t = torch.where(cnt > 0, s / cnt.clamp_min(1), torch.zeros(()))
    c = torch.zeros_like(s)
    q = torch.zeros_like(s)
    for k in range(PER_THREAD):
        d = torch.where(m[..., k], v[..., k] - mean_t, torch.zeros(()))
        c = c + d
        q = (d.double() * d.double() + q.double()).float()  # fmaf(d, d, q)
    m2_t = torch.where(cnt > 0, torch.clamp(q - c * c / cnt.clamp_min(1), min=0.0), torch.zeros(()))
    mu_t = mean_t.double() + c.double() / cnt.double().clamp_min(1)  # 0 where cnt is 0
    n_tile = cnt.double().sum(-1)
    tile_mean = (cnt.double() * mu_t).sum(-1) / n_tile
    tile_m2 = (m2_t.double() + cnt.double() * (mu_t - tile_mean[..., None]) ** 2).sum(-1)
    mean = (n_tile * tile_mean).sum(-1) / R
    var = (tile_m2 + n_tile * (tile_mean - mean[:, None]) ** 2).sum(-1) / R
    return mean, var


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("mean", [0.0, 8.0, 1000.0])
def test_kernel_statistics_hold_a_large_mean(dtype, mean):
    """Rows of mean 8 (and 1,000) and spread 1: the kernels' variance is as
    close to the exact one as ATen's fp32 moments are, and within a few fp32
    ulps; the one-pass fp32 E[x^2] - E[x]^2 is not."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy((mean + rs.randn(2, 3 * 16_384 + 4_000)).astype(np.float32)).to(dtype)
    k_mean, k_var = _kernel_statistics(x)
    xd = x.double()
    e_mean, e_var = xd.mean(1), xd.var(1, unbiased=False)
    a_var, a_mean = torch.var_mean(x.float(), dim=1, correction=0)
    k_err = float(((k_var - e_var) / e_var).abs().max())
    a_err = float(((a_var.double() - e_var) / e_var).abs().max())
    assert k_err <= max(a_err, 4 * 2.0**-24), (k_err, a_err)
    assert float((k_mean - e_mean).abs().max()) <= 2.0**-20 * max(mean, 1.0)
    if mean >= 8.0:
        xf = x.float()
        naive = (xf * xf).mean(1) - xf.mean(1) ** 2
        assert float(((naive.double() - e_var) / e_var).abs().max()) > 10 * k_err


# -- routing --------------------------------------------------------------


def test_cpu_tensors_keep_the_chain_and_launch_nothing():
    y, gamma, beta = _case((2, 4, 33), torch.float32, seed=6)
    before = tgn_kernel.LAUNCHES
    assert not tconv._tgn_on_card(SPEC, y, gamma, beta)
    with torch.no_grad():
        got = apply_post_norm(SPEC, y, gamma, beta)
        plain = tgn_kernel.time_group_norm(y, gamma, beta)
    torch.testing.assert_close(got, _chain(y, gamma, beta), rtol=0, atol=0)
    torch.testing.assert_close(plain, tgn_kernel.time_group_norm_reference(y, gamma, beta), rtol=0, atol=0)
    assert tgn_kernel.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_grad_path_keeps_the_chain_and_its_graph(dtype):
    y, gamma, beta = _case((2, 4, 40), dtype, seed=7)
    y.requires_grad_(True)
    gamma.requires_grad_(True)
    got = apply_post_norm(SPEC, y, gamma, beta)
    assert got.grad_fn is not None
    torch.testing.assert_close(got, _chain(y, gamma, beta), rtol=0, atol=0)
    got.float().square().sum().backward()
    assert y.grad is not None and gamma.grad is not None


def test_transposed_conv_trims_a_view_on_the_chain():
    spec = ConvSpec(4, 3, 8, stride=4, norm="time_group_norm", transposed=True)
    conv = make_conv(spec, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 4, 11, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = conv(x)
        full = F.conv_transpose1d(x, conv.convtr.convtr.weight, conv.convtr.convtr.bias, stride=4)
    norm = conv.convtr.norm
    want = unpad1d_time(_chain(full, norm.weight, norm.bias), (2, 2))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the plain version's trim gives the same window, contiguous
    plain = tgn_kernel.time_group_norm_reference(full, norm.weight, norm.bias, (2, 2))
    assert plain.is_contiguous()
    torch.testing.assert_close(plain, want, rtol=1e-6, atol=1e-6)


def test_norm_follows_a_load_state_dict():
    """The kernels read gamma and beta in their own type at every call, so
    nothing cached goes stale: after a load_state_dict the norm uses the new
    affine (the plain version on the CPU, as the kernels on a card)."""
    spec = ConvSpec(3, 5, 3, norm="time_group_norm")
    conv = make_conv(spec, device="cpu", generator=torch.Generator().manual_seed(2))
    x = torch.randn(2, 3, 30, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        y = F.conv1d(F.pad(x, (1, 1), mode="reflect"), conv.conv.conv.weight, conv.conv.conv.bias)
        first = tgn_kernel.time_group_norm(y, *conv.conv.norm_params())
        state = conv.state_dict()
        state["conv.norm.weight"] = state["conv.norm.weight"] * 2 + 0.5
        state["conv.norm.bias"] = state["conv.norm.bias"] - 1
        conv.load_state_dict(state)
        second = tgn_kernel.time_group_norm(y, *conv.conv.norm_params())
        forward = conv(x)
    gamma, beta = conv.conv.norm_params()
    assert not torch.equal(first, second)
    torch.testing.assert_close(second, tgn_kernel.time_group_norm_reference(y, gamma, beta), rtol=0, atol=0)
    torch.testing.assert_close(forward, _chain(y, gamma, beta), rtol=0, atol=0)
