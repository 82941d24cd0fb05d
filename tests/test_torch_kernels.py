"""The port's CUDA kernels: wrapper checks on the CPU, kernel vs plain version on a card.

This file imports neither JAX nor the JAX package, so it also runs where
only the port is installed. On a machine with a card:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from funcodec_tpu_torch.kernels import build
from funcodec_tpu_torch.ops import conv as tconv
from funcodec_tpu_torch.ops import conv_kernel, resblock_kernel
from funcodec_tpu_torch.ops.pad import conv_padding_total, split_padding
from funcodec_tpu_torch.quant import rvq_kernel


def _codebooks(n_q, bins, dim, seed):
    bound = np.sqrt(2.0 / 6.0) * np.sqrt(3.0 / dim)
    return np.random.RandomState(seed).uniform(-bound, bound, (n_q, bins, dim)).astype(np.float32)


def test_cpu_tensors_take_the_plain_version():
    embed = torch.from_numpy(_codebooks(4, 64, 128, seed=0))
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 9, 128).astype(np.float32)) * 0.2
    before = rvq_kernel.LAUNCHES
    idx, quant = rvq_kernel.rvq_encode_fused(x, embed, 3)
    ref_idx, ref_quant = rvq_kernel.rvq_encode_reference(x, embed, 3)
    assert rvq_kernel.LAUNCHES == before
    assert idx.shape == (3, 2, 9) and quant.shape == (2, 9, 128)
    np.testing.assert_array_equal(idx.numpy(), ref_idx.numpy())
    np.testing.assert_array_equal(quant.numpy(), ref_quant.numpy())


def test_reference_sums_the_chosen_bf16_codewords():
    """quant is exactly the fp32 sum of the chosen bf16 rows, stage by stage."""
    embed = torch.from_numpy(_codebooks(3, 32, 128, seed=2))
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 7, 128).astype(np.float32)) * 0.2
    idx, quant = rvq_kernel.rvq_encode_reference(x, embed, 3)
    e_bf = embed.to(torch.bfloat16).float()
    expect = torch.zeros(7, 128)
    for q in range(3):
        expect = expect + e_bf[q][idx[q, 0].long()]
    np.testing.assert_array_equal(quant[0].numpy(), expect.numpy())


def test_wrapper_rejects_other_devices():
    x = torch.zeros(1, 4, 128, device="meta")
    with pytest.raises(ValueError, match="device"):
        rvq_kernel.rvq_encode_fused(x, torch.zeros(2, 8, 128, device="meta"), 2)


def test_library_name_tracks_the_sources():
    path = build.library_path()
    assert path == build.library_path()
    assert path.parent == build.BUILD_DIR and path.name.startswith("libfuncodec_kernels-")
    names = {s.name for s in build._sources()}
    assert {"rvq_encode.cu", "conv1d_s1.cu", "resblock_tgn.cu", "common.cuh"} <= names


def ulps2(ref: torch.Tensor) -> float:
    """Two bf16 ulps of the largest |value| of ref (the output's scale)."""
    scale = float(ref.float().abs().max())
    return 2.0 * 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 0.0


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,n_q,bins",
    [((4, 500, 128), 32, 1024), ((1, 137, 128), 16, 1024), ((2, 77, 128), 5, 200)],
    ids=["nq32", "ragged_nq16", "bins200"],
)
def test_cuda_kernel_matches_reference(cuda, shape, n_q, bins):
    embed = torch.from_numpy(_codebooks(32, bins, 128, seed=0)).to(cuda)
    x = torch.from_numpy(np.random.RandomState(1).randn(*shape).astype(np.float32)).to(cuda) * 0.1
    before = rvq_kernel.LAUNCHES
    k_idx, k_quant = rvq_kernel.rvq_encode_fused(x, embed, n_q)
    torch.cuda.synchronize()
    assert rvq_kernel.LAUNCHES == before + 1
    r_idx, r_quant = rvq_kernel.rvq_encode_reference(x, embed, n_q)
    k_idx, r_idx = k_idx.cpu().numpy(), r_idx.cpu().numpy()
    assert (k_idx[0] == r_idx[0]).mean() >= 0.999
    assert (k_idx == r_idx).mean() >= 0.99
    rows = (k_idx == r_idx).all(axis=0)
    np.testing.assert_allclose(
        k_quant.cpu().numpy()[rows], r_quant.cpu().numpy()[rows], atol=1e-5, rtol=0
    )


@pytest.mark.gpu
def test_cuda_kernel_rejects_bad_inputs(cuda):
    embed = torch.zeros(2, 16, 64, device=cuda)
    with pytest.raises(ValueError):
        rvq_kernel.rvq_encode_fused(torch.zeros(1, 4, 64, device=cuda), embed, 2)  # D != 128
    with pytest.raises(ValueError):
        rvq_kernel.rvq_encode_fused(torch.zeros(1, 4, 128, device=cuda), torch.zeros(2, 16, 128, device=cuda), 3)


CONV_CASES = [
    # (B, Cin, Cout, T, K, dil, causal, pad_mode, act, dtype)
    (2, 1, 32, 1000, 7, 1, False, "reflect", None, torch.bfloat16),  # encoder first conv
    (2, 512, 128, 100, 7, 1, False, "reflect", "elu", torch.bfloat16),  # encoder last
    (2, 128, 512, 100, 7, 1, False, "reflect", None, torch.bfloat16),  # decoder first
    (2, 32, 1, 1000, 7, 1, False, "reflect", "elu", torch.bfloat16),  # decoder last
    (2, 64, 32, 1003, 3, 1, False, "reflect", "elu", torch.bfloat16),  # resblock conv, ragged T
    (2, 64, 32, 777, 3, 9, True, "replicate", "elu", torch.bfloat16),
    (2, 24, 40, 300, 3, 3, False, "constant", "gelu", torch.float32),
    (3, 48, 24, 129, 7, 2, True, "reflect", "relu", torch.float32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: f"{c[1]}to{c[2]}-T{c[3]}-k{c[4]}d{c[5]}-{c[7]}-{c[8]}-{str(c[9])[6:]}")
def test_cuda_conv_kernel_matches_reference(cuda, case):
    B, Cin, Cout, T, K, dil, causal, pad_mode, act, dtype = case
    rs = np.random.RandomState(Cin + Cout + T)
    x = torch.from_numpy(rs.randn(B, Cin, T).astype(np.float32)).to(cuda, dtype)
    bound = 1.0 / np.sqrt(Cin * K)
    w = torch.from_numpy(rs.uniform(-bound, bound, (Cout, Cin, K)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rs.uniform(-bound, bound, Cout).astype(np.float32)).to(cuda)
    left, right = split_padding(conv_padding_total(K, 1, dil), causal)
    before = conv_kernel.LAUNCHES
    y = conv_kernel.fused_conv1d_s1(x, w, b, left, right, dil, pad_mode, act)
    torch.cuda.synchronize()
    assert conv_kernel.LAUNCHES == before + 1
    ref = conv_kernel.fused_conv1d_s1_reference(x, w, b, left, right, dil, pad_mode, act)
    assert y.dtype == dtype and y.shape == ref.shape == (B, Cout, T)
    err = float((y.float() - ref.float()).abs().max())
    tol = ulps2(ref) if dtype == torch.bfloat16 else 1e-5 * float(ref.abs().max())
    assert err <= tol, (err, tol)


def _resblock_convs(C, K, dil, causal, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    convs = []
    for cin, cout, k, d in ((C, C // 2, K, dil), (C // 2, C, 1, 1), (C, C, 1, 1)):
        spec = tconv.ConvSpec(cin, cout, k, dilation=d, causal=causal, norm="time_group_norm")
        m = tconv.SConv1d(spec, device=device, generator=gen)
        with torch.no_grad():
            m.conv.norm.weight.uniform_(0.5, 1.5, generator=gen)
            m.conv.norm.bias.uniform_(-0.1, 0.1, generator=gen)
        convs.append(m)
    return convs


@pytest.mark.gpu
@pytest.mark.parametrize(
    "C,T,K,dil,causal,dtype",
    [(32, 2000, 3, 1, False, torch.bfloat16), (64, 1000, 3, 1, False, torch.bfloat16),
     (128, 500, 3, 1, False, torch.bfloat16), (256, 250, 3, 1, False, torch.bfloat16),
     (64, 1003, 3, 3, True, torch.bfloat16), (64, 333, 3, 1, False, torch.float32)],
    ids=["C32", "C64", "C128", "C256", "ragged_dilated_causal", "fp32"],
)
def test_cuda_resblock_kernel_matches_reference(cuda, C, T, K, dil, causal, dtype):
    convs = _resblock_convs(C, K, dil, causal, cuda, seed=C + T)
    x = torch.from_numpy(np.random.RandomState(T).randn(2, C, T).astype(np.float32)).to(cuda, dtype)
    before = resblock_kernel.LAUNCHES
    with torch.no_grad():
        y = resblock_kernel.fused_resblock_tgn(x, *convs)
        torch.cuda.synchronize()
        assert resblock_kernel.LAUNCHES == before + 3
        ref = resblock_kernel.fused_resblock_tgn_reference(x, *convs)
    assert y.dtype == dtype and y.shape == ref.shape
    err = float((y.float() - ref.float()).abs().max())
    tol = ulps2(ref) if dtype == torch.bfloat16 else 1e-4 * float(ref.abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.gpu
def test_cuda_seanet_kernels_reject_bad_inputs(cuda):
    x = torch.zeros(1, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv_kernel.fused_conv1d_s1(x, torch.zeros(4, 8, 3, device=cuda), None, 1, 1)
    with pytest.raises(ValueError, match="weight"):
        conv_kernel.fused_conv1d_s1(x.float(), torch.zeros(4, 6, 3, device=cuda), None, 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.empty(1, 4, 64, device=cuda)
        conv_kernel.launch_conv1d_s1(x.float(), torch.zeros(4, 8, 3, device=cuda).transpose(0, 2),
                                     torch.zeros(4, device=cuda), y, 1, 1, "reflect", None)
    convs = _resblock_convs(32, 3, 1, False, cuda, seed=0)
    with torch.no_grad(), pytest.raises(ValueError, match="float32 or bfloat16"):
        resblock_kernel.fused_resblock_tgn(torch.zeros(1, 32, 64, device=cuda, dtype=torch.float16), *convs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(2, 40, 128), (3, 1001, 128), (5, 777, 64)], ids=["small", "ragged", "L64"])
def test_cuda_copy_kernels_bit_exact(cuda, dtype, shape):
    from funcodec_tpu_torch.ops import copy_kernel

    x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32)).to(cuda, dtype)
    x.view(-1)[:4] = torch.tensor([3e38, -3e38, 1e-40, -0.0]).to(cuda, dtype)  # inf after doubling, subnormal
    ref = copy_kernel.scale_reference(x)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    before = dict(copy_kernel.LAUNCHES)
    outs = [copy_kernel.scale_copy(x, t, r) for t, r in ((8, 1), (100, 2), (4000, 1))]
    outs += [copy_kernel.dma_copy(x, c) for c in (None, 16, 100)]
    torch.cuda.synchronize()
    assert copy_kernel.LAUNCHES == {"scale_copy": before["scale_copy"] + 3, "dma_copy": before["dma_copy"] + 3}
    for out in outs:
        assert torch.equal(out.view(bits), ref.view(bits))


@pytest.mark.gpu
def test_cuda_copy_kernels_reject_bad_inputs(cuda):
    from funcodec_tpu_torch.ops import copy_kernel

    x = torch.zeros(2, 8, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        copy_kernel.scale_copy(torch.zeros(2049, device=cuda, dtype=torch.bfloat16)[1:].view(2, 8, 128), 4)
    with pytest.raises(ValueError, match="multiple of 16"):
        copy_kernel.dma_copy(torch.zeros(4, 3, device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        copy_kernel.dma_copy(torch.zeros(4096, 128, device=cuda), chunk_rows=1024)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        copy_kernel.scale_copy(x.half(), 4)
