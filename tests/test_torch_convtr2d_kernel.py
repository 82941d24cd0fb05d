"""The grouped transposed 2D conv kernel of FreqCodec's decoder
(ops/convtr2d_kernel.py, csrc/convtr2d.cu): its plain version against
``F.conv_transpose2d`` on the CPU, the route ops/conv.py takes by what the
input shows, the launch counter, and on a card the kernel against the plain
version, bit for bit from run to run.

This file imports neither JAX nor the JAX package. On a machine with a card:

    python -m pytest --noconftest -q tests/test_torch_convtr2d_kernel.py
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from funcodec_tpu_torch.ops import conv as tconv
from funcodec_tpu_torch.ops import convtr2d_kernel as ck

# gr8's four transposed convs (models/seanet2d.build_decoder2d_layers): 16 -> 8 channels a
# group, kernel twice the stride; (x at the benchmark cell's batch, groups, stride); gr1's
# are the same with C / 2 groups of 2 -> 1 (tr_conv_group_ratio 1)
CELL = {
    "tc1": ((64, 512, 1, 305), 32, (4, 1)),
    "tc2": ((64, 256, 4, 305), 16, (4, 1)),
    "tc3": ((64, 128, 16, 305), 8, (4, 2)),
    "tc4": ((64, 64, 64, 610), 4, (4, 1)),
}
CELL.update({f"gr1_{name}": (shape, shape[1] // 2, stride) for name, (shape, _, stride) in list(CELL.items())})
# the same per-group shapes with B, F and T narrowed for the CPU
NARROW = {name: ((2, shape[1], min(shape[2], 5), 9 + i % 4), groups, stride)
          for i, (name, (shape, groups, stride)) in enumerate(CELL.items())}


def _one_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 step at each element's magnitude."""
    return torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -100))) - 7)


def _inputs(shape, groups, stride, dtype, seed, device="cpu", bias=True):
    B, cin, f, t = shape
    cog = max(cin // groups // 2, 1)
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device=device, dtype=dtype)
    w = torch.from_numpy(rs.randn(cin, cog, 2 * stride[0], 2 * stride[1]).astype(np.float32) * 0.25)
    b = torch.from_numpy(rs.randn(cog * groups).astype(np.float32)) if bias else None
    return x, w.to(device=device, dtype=dtype), None if b is None else b.to(device=device, dtype=dtype)


@pytest.mark.parametrize("name", list(NARROW))
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 2e-5)], ids=["fp64", "fp32"])
def test_plain_version_is_conv_transpose2d(name, bias, dtype, tol):
    shape, groups, stride = NARROW[name]
    x, w, b = _inputs(shape, groups, stride, dtype, seed=len(name) + bias, bias=bias)
    y = ck.convtr2d_reference(x, w, b, stride, groups)
    want = F.conv_transpose2d(x, w, b, stride=stride, groups=groups)
    B, cin, f, t = shape
    assert y.shape == want.shape == (B, cin // 2, (f + 1) * stride[0], (t + 1) * stride[1])  # untrimmed
    assert y.dtype == dtype
    scale = float(want.abs().max())
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=tol * scale, rtol=0)


@pytest.mark.parametrize("shape,groups,stride", [((1, 16, 3, 7), 2, (1, 1)), ((2, 24, 2, 5), 3, (2, 4)),
                                                 ((1, 128, 1, 4), 2, (8, 1)), ((1, 8, 2, 3), 2, (1, 8))],
                         ids=["s1x1_cig8", "s2x4_cig8", "s8x1_cig64", "s1x8_cig4"])
def test_plain_version_at_other_supported_shapes(shape, groups, stride):
    x, w, b = _inputs(shape, groups, stride, torch.float64, seed=5)
    np.testing.assert_allclose(ck.convtr2d_reference(x, w, b, stride, groups).numpy(),
                               F.conv_transpose2d(x, w, b, stride=stride, groups=groups).numpy(), atol=1e-12, rtol=0)


def test_cpu_wrapper_takes_the_plain_version_and_counts_no_launch():
    shape, groups, stride = NARROW["tc3"]
    x, w, b = _inputs(shape, groups, stride, torch.bfloat16, seed=3)
    before = ck.LAUNCHES
    y = ck.convtr2d(x, w, b, stride, groups)
    assert ck.LAUNCHES == before
    assert torch.equal(y, ck.convtr2d_reference(x, w, b, stride, groups)) and y.dtype == torch.bfloat16
    # fp32 sums rounded once: within one bf16 step of the exact answer (and the fp32 sum's error)
    exact = F.conv_transpose2d(x.double(), w.double(), b.double(), stride=stride, groups=groups)
    assert bool(((y.double() - exact).abs() <= _one_ulp(exact) + 1e-5 * exact.abs().max()).all())


@pytest.mark.parametrize("weight_shape,groups,stride,match", [
    ((64, 8, 8, 3), 4, (4, 1), "twice the stride"),
    ((64, 8, 6, 2), 4, (4, 1), "twice the stride"),
    ((64, 8, 8, 8), 4, (4, 4), "stride_f"),
    ((256, 8, 8, 2), 2, (4, 1), "at most 64"),
    ((64, 80, 8, 2), 4, (4, 1), "at most 64"),
], ids=["kt3", "kf6", "16_phases", "cig128", "cog80"])
def test_unsupported_geometry_raises(weight_shape, groups, stride, match):
    x = torch.zeros(1, weight_shape[0], 2, 3)
    with pytest.raises(ValueError, match=match):
        ck.convtr2d(x, torch.zeros(weight_shape), None, stride, groups)


# --- the route (ops/conv.apply_sconv_transpose2d) ------------------------------


def _spec(groups=4, stride=(4, 1), cin=64, cout=32, kernel=None):
    return tconv.ConvSpec(cin, cout, kernel or (2 * stride[0], 2 * stride[1]), stride=stride, groups=groups,
                          norm="time_group_norm", transposed=True)


def _card_tensor(t: torch.Tensor, requires_grad=False):
    """What the route reads of a CUDA tensor (device, type, grad, shape), on a machine without one."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=t.dtype, requires_grad=requires_grad,
                                 shape=t.shape, dim=t.dim)


@pytest.mark.parametrize("case,takes", [
    ("bf16, no grad, grouped", True),
    ("x needs grad", False),
    ("weight needs grad", False),
    ("groups 1", False),
    ("fp32", False),
    ("cpu", False),
])
def test_route_by_what_the_input_shows(case, takes):
    spec = _spec(groups=1 if case == "groups 1" else 4)
    x = torch.zeros(2, 64, 3, 5, dtype=torch.float32 if case == "fp32" else torch.bfloat16)
    w = torch.zeros(64, 32 // spec.groups, 8, 2, requires_grad=case == "weight needs grad")
    b = torch.zeros(32)
    xin = x if case == "cpu" else _card_tensor(x, requires_grad=case == "x needs grad")
    assert tconv._convtr2d_on_card(spec, xin, w, b) is takes
    with torch.no_grad():  # serving: grad off, whatever the parameters ask
        assert tconv._convtr2d_on_card(spec, xin, w, b) is (case not in ("groups 1", "fp32", "cpu"))


def test_unsupported_geometry_on_a_card_raises_in_the_route():
    """A grouped bf16 conv on a card that the kernel does not take raises; nothing falls back."""
    spec = _spec(kernel=(8, 3))
    x = _card_tensor(torch.zeros(2, 64, 3, 5, dtype=torch.bfloat16))
    with torch.no_grad(), pytest.raises(ValueError, match="twice the stride"):
        tconv.apply_sconv_transpose2d(spec, x, torch.zeros(64, 8, 8, 3), torch.zeros(32), torch.ones(32),
                                      torch.zeros(32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_route_is_conv_transpose2d_unchanged(dtype):
    """On the CPU the transposed conv stays F.conv_transpose2d (then the norm and the trim), bit for bit."""
    spec = _spec()
    x, w, b = _inputs((2, 64, 3, 7), 4, (4, 1), dtype, seed=9)
    gamma, beta = torch.rand(32, dtype=dtype) + 0.5, torch.rand(32, dtype=dtype) * 0.1
    calls, launches = tconv.CONV2D_CALLS["transposed"], ck.LAUNCHES
    with torch.no_grad():
        y = tconv.apply_sconv_transpose2d(spec, x, w, b, gamma, beta)
    assert tconv.CONV2D_CALLS["transposed"] == calls + 1 and ck.LAUNCHES == launches
    full = F.conv_transpose2d(x, w, b, stride=(4, 1), groups=4)
    yn = F.group_norm(full.float(), 1, gamma.float(), beta.float(), eps=1e-5).to(dtype)
    assert torch.equal(y, yn[:, :, 2: yn.shape[2] - 2, 1: yn.shape[3]])


# --- on a card -----------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _hold(y: torch.Tensor, ref: torch.Tensor) -> None:
    """The kernel against the plain version: both round an fp32 sum of the same products once, in
    another order, so an element differs by at most one bf16 step at its magnitude, or by the fp32
    sums' error (~1e-6 of the terms) where the sum cancels to near zero."""
    assert y.shape == ref.shape and y.dtype == ref.dtype == torch.bfloat16 and y.is_contiguous()
    diff = (y.float() - ref.float()).abs()
    assert bool((diff <= _one_ulp(ref) + 1e-5 * ref.float().abs().max()).all()), float(diff.max())
    assert float((y == ref).float().mean()) >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CELL))
def test_kernel_matches_plain_version_at_the_cell_shapes(cuda, name):
    shape, groups, stride = CELL[name]
    x, w, b = _inputs(shape, groups, stride, torch.bfloat16, seed=11, device=cuda)
    before = ck.LAUNCHES
    y = ck.convtr2d(x, w, b, stride, groups)
    again = ck.convtr2d(x, w, b, stride, groups)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before + 2
    assert torch.equal(y, again)  # the same bits from run to run
    _hold(y, ck.convtr2d_reference(x, w, b, stride, groups))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,groups,stride,bias", [
    ((3, 16, 3, 7), 2, (1, 1), True), ((2, 24, 2, 21), 3, (2, 4), False), ((2, 128, 1, 40), 2, (8, 1), True),
    ((2, 8, 2, 5), 2, (1, 8), True), ((1, 96, 5, 333), 2, (2, 2), True), ((1, 32, 1, 1), 2, (4, 1), False),
    ((2, 64, 33, 170), 4, (4, 1), True), ((9, 32, 3, 37), 2, (2, 1), True), ((2, 30, 3, 40), 10, (2, 2), True),
    ((2, 14, 2, 21), 14, (4, 1), False),
], ids=["s1x1_cig8", "s2x4_cig8_no_bias", "s8x1_cig64", "s1x8_cig4", "cig48_cog24", "t1", "tiles_and_row_runs",
        "samples_across_runs", "cig3_five_groups_a_block", "cig1_seven_groups_a_block"])
def test_kernel_matches_plain_version_at_other_shapes(cuda, shape, groups, stride, bias):
    x, w, b = _inputs(shape, groups, stride, torch.bfloat16, seed=12, device=cuda, bias=bias)
    _hold(ck.convtr2d(x, w, b, stride, groups), ck.convtr2d_reference(x, w, b, stride, groups))


@pytest.mark.gpu
def test_kernel_reads_an_unaligned_view(cuda):
    shape, groups, stride = NARROW["tc4"]
    x, w, b = _inputs(shape, groups, stride, torch.bfloat16, seed=13, device=cuda)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xv = buf[1:].view(x.shape)  # contiguous, its first element 2 bytes past an aligned address
    xv.copy_(x)
    assert xv.data_ptr() % 16 == 2
    _hold(ck.convtr2d(xv, w, b, stride, groups), ck.convtr2d_reference(xv, w, b, stride, groups))


@pytest.mark.gpu
def test_route_on_the_card(cuda):
    spec = _spec()
    x, w, b = _inputs((2, 64, 3, 7), 4, (4, 1), torch.bfloat16, seed=14, device=cuda)
    gamma, beta = torch.ones(32, device=cuda), torch.zeros(32, device=cuda)
    before = ck.LAUNCHES
    with torch.no_grad():
        tconv.apply_sconv_transpose2d(spec, x, w, b, gamma, beta)
        tconv.apply_sconv_transpose2d(spec, x.float(), w, b, gamma, beta)  # fp32: cuDNN
        tconv.apply_sconv_transpose2d(_spec(groups=1, cout=32), x, torch.zeros(64, 32, 8, 2, device=cuda), b,
                                      gamma, beta)  # groups 1: cuDNN
    tconv.apply_sconv_transpose2d(spec, x, w.requires_grad_(), b, gamma, beta)  # grad: cuDNN
    assert ck.LAUNCHES == before + 1
    with torch.no_grad(), pytest.raises(ValueError, match="twice the stride"):
        tconv.apply_sconv_transpose2d(_spec(kernel=(8, 3)), x, torch.zeros(64, 8, 8, 3, device=cuda), b, gamma,
                                      beta)
