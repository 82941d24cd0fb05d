"""The port's CUDA kernels: wrapper checks on the CPU, kernel vs plain version on a card.

This file imports neither JAX nor the JAX package, so it also runs where
only the port is installed. On a machine with a card:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from funcodec_tpu_torch.kernels import build
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
    assert any(s.name == "rvq_encode.cu" for s in build._sources())


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
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
