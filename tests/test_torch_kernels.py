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
from funcodec_tpu_torch.ops import conv_kernel, resblock_kernel, tgn_kernel
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
    assert {"rvq_encode.cu", "conv1d_s1.cu", "resblock_tgn.cu", "resblock_tgn_streamed.cu", "resblock_tgn_legacy.cu",
            "resblock_tgn.cuh", "common.cuh", "conv1d_s1_legacy.cu", "conv1d_s1.cuh", "copy_probe.cu",
            "tgn_norm.cu", "convtr2d.cu"} <= names


def test_signatures_match_the_sources():
    """Every ctypes signature has as many arguments as its extern "C" entry in csrc/."""
    import re

    text = "".join(src.read_text() for src in build._sources())
    for name, (_, argtypes) in build.SIGNATURES.items():
        m = re.search(r'extern "C"[^(]*\b' + name + r"\(([^)]*)\)", text)
        assert m is not None, name
        params = [a for a in m.group(1).split(",") if a.strip() and a.strip() != "void"]
        assert len(params) == len(argtypes), (name, len(params), len(argtypes))


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
    [((4, 500, 128), 32, 1024), ((1, 137, 128), 16, 1024), ((2, 77, 128), 5, 200), ((3, 211, 128), 32, 1000),
     ((1, 1, 128), 32, 1024), ((2, 500, 128), 1, 1024), ((1, 129, 128), 3, 128)],
    ids=["nq32", "ragged_nq16", "bins200", "bins1000", "one_token", "nq1", "one_chunk"],
)
@pytest.mark.parametrize("variant", ["wgmma", "legacy"])
def test_cuda_kernel_matches_reference(cuda, shape, n_q, bins, variant):
    embed = torch.from_numpy(_codebooks(32, bins, 128, seed=0)).to(cuda)
    x = torch.from_numpy(np.random.RandomState(1).randn(*shape).astype(np.float32)).to(cuda) * 0.1
    before = rvq_kernel.LAUNCHES
    k_idx, k_quant = rvq_kernel.rvq_encode_fused(x, embed, n_q, variant=variant)
    torch.cuda.synchronize()
    assert rvq_kernel.LAUNCHES == before + 1
    again = rvq_kernel.rvq_encode_fused(x, embed, n_q, variant=variant)
    assert torch.equal(again[0], k_idx) and torch.equal(again[1], k_quant)  # the same from run to run
    assert int(k_idx.min()) >= 0 and int(k_idx.max()) < bins
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
    with pytest.raises(ValueError, match="variant"):
        rvq_kernel.rvq_encode_fused(torch.zeros(1, 4, 128, device=cuda), torch.zeros(2, 16, 128, device=cuda), 2,
                                    variant="fp8")
    with pytest.raises(ValueError, match="embed on"):
        rvq_kernel.rvq_encode_fused(torch.zeros(1, 4, 128, device=cuda), torch.zeros(2, 16, 128), 2)
    cb = rvq_kernel.prepared_codebooks(torch.zeros(2, 16, 128, device=cuda))
    idx = torch.empty(2, 4, dtype=torch.int32, device=cuda)
    quant = torch.empty(4, 128, device=cuda)
    with pytest.raises(ValueError, match="arranged"):  # the image of another chunking
        rvq_kernel.launch_rvq_encode(torch.zeros(4, 128, device=cuda, dtype=torch.bfloat16), cb["embed"],
                                     cb["arranged"].reshape(2, 2, -1), cb["esq"], idx, quant)
    with pytest.raises(ValueError, match="esq"):  # ||E||^2 without the padding to whole chunks
        rvq_kernel.launch_rvq_encode(torch.zeros(4, 128, device=cuda, dtype=torch.bfloat16), cb["embed"],
                                     cb["arranged"], cb["esq"][:, :16].contiguous(), idx, quant)


@pytest.mark.gpu
def test_cuda_rvq_follows_a_codebook_updated_in_place(cuda):
    """The prepared codebooks are rebuilt when the codebook changes."""
    embed = torch.from_numpy(_codebooks(4, 256, 128, seed=5)).to(cuda)
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 100, 128).astype(np.float32)).to(cuda) * 0.1
    rvq_kernel.rvq_encode_fused(x, embed, 4)
    embed.mul_(-1.0)
    k_idx, k_quant = rvq_kernel.rvq_encode_fused(x, embed, 4)
    r_idx, r_quant = rvq_kernel.rvq_encode_reference(x, embed, 4)
    assert (k_idx == r_idx).float().mean() >= 0.99
    rows = (k_idx == r_idx).all(dim=0).reshape(-1)
    assert float((k_quant - r_quant).abs().reshape(-1, 128)[rows].max()) <= 1e-5


CONV_CASES = [
    # (B, Cin, Cout, T, K, dil, causal, pad_mode, act, dtype)
    (2, 1, 32, 1000, 7, 1, False, "reflect", None, torch.bfloat16),  # encoder first
    (2, 512, 128, 100, 7, 1, False, "reflect", "elu", torch.bfloat16),  # encoder last, streamed weights
    (2, 128, 512, 100, 7, 1, False, "reflect", None, torch.bfloat16),  # decoder first, 4 channel tiles
    (2, 32, 1, 1000, 7, 1, False, "reflect", "elu", torch.bfloat16),  # decoder last
    (2, 64, 32, 1003, 3, 1, False, "reflect", "elu", torch.bfloat16),  # resblock conv, T % 8 != 0
    (2, 64, 32, 777, 3, 9, True, "replicate", "elu", torch.bfloat16),  # dilated causal
    (2, 24, 40, 300, 3, 3, False, "constant", "gelu", torch.float32),
    (3, 48, 24, 129, 7, 2, True, "reflect", "relu", torch.float32),
    # tiles: T shorter than one 256-step tile, one step longer; B = 1
    (2, 32, 16, 100, 3, 1, False, "reflect", "elu", torch.bfloat16),
    (2, 32, 16, 257, 3, 1, False, "reflect", "elu", torch.bfloat16),
    (1, 128, 64, 5000, 3, 1, False, "replicate", "relu", torch.bfloat16),
    (1, 256, 128, 4000, 3, 1, False, "reflect", "elu", torch.bfloat16),
    # thin: ragged lengths (scalar branch), the warp's and the block's edges, causal, other K
    (2, 1, 32, 1003, 7, 1, False, "reflect", None, torch.bfloat16),
    (2, 32, 1, 2049, 7, 1, False, "reflect", "elu", torch.bfloat16),
    (3, 1, 32, 2048, 7, 1, True, "constant", "elu", torch.bfloat16),
    (1, 30, 1, 4001, 5, 1, False, "replicate", None, torch.bfloat16),
    (2, 1, 16, 255, 3, 1, True, "replicate", "gelu", torch.bfloat16),
    # every act and pad mode on the tensor cores; 24 -> 40 (the legacy kernel)
    (2, 16, 32, 999, 3, 1, False, "reflect", "relu", torch.bfloat16),
    (2, 32, 64, 600, 5, 2, False, "replicate", "gelu", torch.bfloat16),
    (2, 64, 64, 511, 3, 1, True, "constant", None, torch.bfloat16),
    (2, 48, 96, 513, 5, 2, False, "reflect", "elu", torch.bfloat16),
    (2, 24, 40, 300, 3, 3, False, "constant", "gelu", torch.bfloat16),
    # the streamed-weight heads at B = 2, causal
    (2, 512, 128, 103, 7, 1, True, "replicate", "elu", torch.bfloat16),
    (2, 128, 512, 300, 7, 1, False, "constant", "gelu", torch.bfloat16),
    # FreqCodec's heads at T = 501 (odd: scalar loads, 8 in flight), and T % 4 == 2 (4-byte copies)
    (2, 512, 128, 501, 7, 1, False, "reflect", "elu", torch.bfloat16),
    (2, 128, 512, 501, 7, 1, False, "reflect", None, torch.bfloat16),
    (2, 64, 32, 1002, 3, 1, False, "reflect", "elu", torch.bfloat16),
    (2, 128, 512, 502, 7, 1, True, "replicate", None, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["auto", "legacy"])
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: f"B{c[0]}-{c[1]}to{c[2]}-T{c[3]}-k{c[4]}d{c[5]}-{c[7]}-{c[8]}-{str(c[9])[6:]}")
def test_cuda_conv_kernel_matches_reference(cuda, case, variant):
    B, Cin, Cout, T, K, dil, causal, pad_mode, act, dtype = case
    rs = np.random.RandomState(Cin + Cout + T)
    x = torch.from_numpy(rs.randn(B, Cin, T).astype(np.float32)).to(cuda, dtype)
    bound = 1.0 / np.sqrt(Cin * K)
    w = torch.from_numpy(rs.uniform(-bound, bound, (Cout, Cin, K)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rs.uniform(-bound, bound, Cout).astype(np.float32)).to(cuda)
    left, right = split_padding(conv_padding_total(K, 1, dil), causal)
    before = conv_kernel.LAUNCHES
    y = conv_kernel.fused_conv1d_s1(x, w, b, left, right, dil, pad_mode, act, variant=variant)
    torch.cuda.synchronize()
    assert conv_kernel.LAUNCHES == before + 1
    again = conv_kernel.fused_conv1d_s1(x, w, b, left, right, dil, pad_mode, act, variant=variant)
    assert torch.equal(again, y)  # the same from run to run
    ref = conv_kernel.fused_conv1d_s1_reference(x, w, b, left, right, dil, pad_mode, act)
    assert y.dtype == dtype and y.shape == ref.shape == (B, Cout, T)
    err = float((y.float() - ref.float()).abs().max())
    tol = ulps2(ref) if dtype == torch.bfloat16 else 1e-5 * float(ref.abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.gpu
def test_cuda_conv_plan_mirrors_the_launch(cuda):
    """ops/conv_kernel.plan names the kernel csrc/conv1d_s1.cu runs, with its tiles and shared memory."""
    lib = build.load()
    for cin in (1, 8, 16, 24, 32, 48, 64, 128, 256, 512):
        for cout in (1, 16, 32, 40, 64, 96, 128, 512):
            for K, dil, left in ((3, 1, 1), (3, 1, 2), (7, 1, 3), (7, 1, 6), (5, 2, 4), (3, 9, 18), (7, 2, 6), (3, 1000, 2000)):
                for dtype, variant in ((torch.bfloat16, "auto"), (torch.bfloat16, "legacy"), (torch.float32, "auto")):
                    args = (cin, cout, K, dil, left, conv_kernel.DTYPES[dtype], conv_kernel.VARIANTS[variant])
                    p = conv_kernel.plan(cin, cout, K, dil, left, dtype, variant)
                    got = (conv_kernel.REGIMES[lib.conv1d_s1_regime(*args)], lib.conv1d_s1_out_tile(*args),
                           lib.conv1d_s1_chunk(*args))
                    assert got == tuple(p), (args, got, p)
                    if p.chunk:
                        smem = conv_kernel.tc_layout(p.out_tile, p.chunk, cin, cout, K, dil, left,
                                                     p.regime == "tc_resident")
                        assert lib.conv1d_s1_smem_bytes(*args) == smem
                        assert lib.conv1d_s1_blocks_per_sm(*args) >= 1


@pytest.mark.gpu
def test_cuda_conv_follows_weights_updated_in_place(cuda):
    """The packed weights are rebuilt when the weight or the bias changes."""
    rs = np.random.RandomState(11)
    x = torch.from_numpy(rs.randn(2, 64, 600).astype(np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(rs.randn(32, 64, 3).astype(np.float32) * 0.1).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rs.randn(32).astype(np.float32)).to(cuda)
    with torch.no_grad():
        conv_kernel.fused_conv1d_s1(x, w, b, 1, 1, 1, "reflect", "elu")
        w.mul_(-0.5)
        b.add_(1.0)
        y = conv_kernel.fused_conv1d_s1(x, w, b, 1, 1, 1, "reflect", "elu")
        ref = conv_kernel.fused_conv1d_s1_reference(x, w, b, 1, 1, 1, "reflect", "elu")
    assert float((y.float() - ref.float()).abs().max()) <= ulps2(ref)


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
    _check_resblock(cuda, 2, C, T, K, dil, causal, dtype)


def _check_resblock(cuda, B, C, T, K, dil, causal, dtype, **kwargs):
    convs = _resblock_convs(C, K, dil, causal, cuda, seed=C + T)
    x = torch.from_numpy(np.random.RandomState(T).randn(B, C, T).astype(np.float32)).to(cuda, dtype)
    before = resblock_kernel.LAUNCHES, resblock_kernel.FINALIZE_LAUNCHES
    with torch.no_grad():
        y = resblock_kernel.fused_resblock_tgn(x, *convs, **kwargs)
        torch.cuda.synchronize()
        assert resblock_kernel.LAUNCHES == before[0] + 3
        assert resblock_kernel.FINALIZE_LAUNCHES == before[1] + 2
        assert torch.equal(resblock_kernel.fused_resblock_tgn(x, *convs, **kwargs), y)  # the same from run to run
        ref = resblock_kernel.fused_resblock_tgn_reference(x, *convs)
    assert y.dtype == dtype and y.shape == ref.shape
    err = float((y.float() - ref.float()).abs().max())
    tol = ulps2(ref) if dtype == torch.bfloat16 else 1e-4 * float(ref.abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,C,T,K,dil,causal,kwargs",
    [(16, 32, 16_000, 3, 1, False, {}), (1, 64, 8000, 3, 1, False, {}), (1, 256, 400, 3, 1, False, {}),
     (2, 32, 100, 3, 1, False, {}), (2, 32, 257, 3, 1, False, {}), (2, 64, 129, 3, 1, False, {}),
     (2, 128, 129, 3, 1, False, {}), (2, 256, 65, 3, 1, False, {}), (3, 32, 4096, 3, 1, False, {"max_blocks": 3}),
     (3, 256, 2048, 3, 1, False, {"max_blocks": 5}), (2, 256, 1003, 3, 3, True, {}), (2, 128, 1000, 5, 2, False, {}),
     (2, 32, 2000, 3, 1, False, {"variant": "legacy"}), (2, 256, 250, 3, 1, False, {"variant": "legacy"})],
    ids=["B16", "B1", "B1_C256", "short", "tile_plus_1_C32", "tile_plus_1_C64", "tile_plus_1_C128", "tile_plus_1_C256",
         "3_blocks_C32", "5_blocks_C256", "ragged_dilated_causal_C256", "k5_d2_C128", "legacy_C32", "legacy_C256"],
)
def test_cuda_resblock_persistent_edges(cuda, B, C, T, K, dil, causal, kwargs):
    """Grids smaller than the card, tiles shorter than one and one step longer, a capped
    grid (many work items a block), other conv1 geometries, and the first device code."""
    _check_resblock(cuda, B, C, T, K, dil, causal, torch.bfloat16, **kwargs)


@pytest.mark.gpu
@pytest.mark.parametrize("C,n_t", [(32, 1), (32, 625), (256, 63), (64, 1250)])
def test_cuda_resblock_finalize_matches_finalize_affine(cuda, C, n_t):
    rs = np.random.RandomState(n_t)
    B, T, H = 3, n_t * 64, C // 2
    y = rs.randn(B, n_t, 4, 32) + 0.2
    part = torch.from_numpy(np.stack([y[:, :, 0].sum(-1), (y[:, :, 0] ** 2).sum(-1),
                                      y[:, :, 2].sum(-1), (y[:, :, 2] ** 2).sum(-1)], axis=-1)).to(cuda)
    g = [torch.from_numpy(rs.uniform(0.5, 1.5, n).astype(np.float32)).to(cuda) for n in (H, H, C, C)]
    aff = torch.zeros(B, 6, C, device=cuda)
    before = resblock_kernel.FINALIZE_LAUNCHES
    resblock_kernel.launch_resblock_finalize(part, aff, T, [(g[0], g[1], 0), (g[2], g[3], 4)])
    resblock_kernel.launch_resblock_finalize(part, aff, T, [(g[2], g[3], 2)])
    torch.cuda.synchronize()
    assert resblock_kernel.FINALIZE_LAUNCHES == before + 2
    tot = part.sum(dim=1)
    for slot, (n, s, sq, gamma, beta) in {0: (H, tot[:, 0], tot[:, 1], g[0], g[1]), 4: (C, tot[:, 2], tot[:, 3], g[2], g[3]),
                                          2: (C, tot[:, 0], tot[:, 1], g[2], g[3])}.items():
        a, d = resblock_kernel.finalize_affine(s, sq, T * n, gamma, beta)
        np.testing.assert_allclose(aff[:, slot, :n].cpu().numpy(), a.cpu().numpy(), rtol=2e-7)
        np.testing.assert_allclose(aff[:, slot + 1, :n].cpu().numpy(), d.cpu().numpy(), rtol=2e-7, atol=1e-9)
        ma, md = resblock_kernel.finalize_mirror(part, {0: 0, 4: 1, 2: 0}[slot], T, gamma, beta)
        np.testing.assert_allclose(aff[:, slot, :n].cpu().numpy(), ma.cpu().numpy(), rtol=2e-7)
        np.testing.assert_allclose(aff[:, slot + 1, :n].cpu().numpy(), md.cpu().numpy(), rtol=2e-7, atol=1e-9)
    assert float(aff[:, 0, H:].abs().max()) == 0.0  # conv1's affine fills its H channels only


@pytest.mark.gpu
def test_cuda_resblock_follows_weights_updated_in_place(cuda):
    """The packed weights are rebuilt when a parameter changes."""
    convs = _resblock_convs(64, 3, 1, False, cuda, seed=9)
    convs = [m.to(torch.bfloat16) for m in convs]
    x = torch.from_numpy(np.random.RandomState(9).randn(2, 64, 1000).astype(np.float32)).to(cuda, torch.bfloat16)
    with torch.no_grad():
        resblock_kernel.fused_resblock_tgn(x, *convs)
        convs[1].conv.layer.weight.mul_(-0.5)
        convs[2].load_state_dict(_resblock_convs(64, 3, 1, False, cuda, seed=10)[2].to(torch.bfloat16).state_dict())
        y = resblock_kernel.fused_resblock_tgn(x, *convs)
        ref = resblock_kernel.fused_resblock_tgn_reference(x, *convs)
    assert float((y.float() - ref.float()).abs().max()) <= ulps2(ref)


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
    with pytest.raises(ValueError, match="variant"):
        conv_kernel.fused_conv1d_s1(x.float(), torch.zeros(4, 8, 3, device=cuda), None, 1, 1, variant="wgmma")
    xb = torch.zeros(1, 32, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="w is"):  # (Cout, K, Cin) where the tensor-core kernel reads chunks
        conv_kernel.launch_conv1d_s1(xb, torch.zeros(16, 3, 32, device=cuda, dtype=torch.bfloat16),
                                     torch.zeros(16, device=cuda), torch.empty(1, 16, 64, device=cuda,
                                                                               dtype=torch.bfloat16), 1, 1, "reflect", None)
    convs = _resblock_convs(32, 3, 1, False, cuda, seed=0)
    with torch.no_grad(), pytest.raises(ValueError, match="float32 or bfloat16"):
        resblock_kernel.fused_resblock_tgn(torch.zeros(1, 32, 64, device=cuda, dtype=torch.float16), *convs)
    with torch.no_grad(), pytest.raises(ValueError, match="variant"):
        resblock_kernel.fused_resblock_tgn(torch.zeros(1, 32, 64, device=cuda), *convs, variant="tile64")
    with torch.no_grad(), pytest.raises(ValueError, match="max_blocks"):
        resblock_kernel.fused_resblock_tgn(torch.zeros(1, 32, 64, device=cuda), *convs, max_blocks=-1)
    part, aff = torch.zeros(1, 2, 4, dtype=torch.float64, device=cuda), torch.zeros(1, 6, 32, device=cuda)
    g = torch.ones(32, device=cuda)
    with pytest.raises(ValueError, match="1 or 2"):
        resblock_kernel.launch_resblock_finalize(part, aff, 64, [(g, g, 0)] * 3)
    with pytest.raises(ValueError, match="slot"):
        resblock_kernel.launch_resblock_finalize(part, aff, 64, [(g, g, 1)])
    with pytest.raises(ValueError, match="part"):
        resblock_kernel.launch_resblock_finalize(part.float(), aff, 64, [(g, g, 0)])


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
    outs = [copy_kernel.scale_copy(x, t, r) for t, r in ((8, 1), (100, 2), (4000, 1), (1, 3), (7, 4))]
    rb = shape[-1] * x.element_size()
    dma = [None, 16, 100, 1, 64, 7, 76_800 // rb, 102_400 // rb]  # the last two: rings of 3 and 2 slots
    outs += [copy_kernel.dma_copy(x, c) for c in dma]
    torch.cuda.synchronize()
    assert copy_kernel.LAUNCHES == {"scale_copy": before["scale_copy"] + 5,
                                    "dma_copy": before["dma_copy"] + len(dma)}
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


TGN_CASES = {  # (shape, trim, dtype, gamma's dtype, mean): every path of csrc/tgn_norm.cu
    "scalar_fp32": ((2, 5, 37), (0, 0), torch.float32, torch.float32, 0.0),
    "scalar_c1_bf16": ((3, 1, 97), (0, 0), torch.bfloat16, torch.bfloat16, 0.0),
    "vector_bf16": ((2, 32, 20_000), (0, 0), torch.bfloat16, torch.bfloat16, 0.0),
    "vector_tiles_fp32": ((2, 3, 12_000), (0, 0), torch.float32, torch.float32, 0.0),
    "mean8_fp32": ((2, 16, 8000), (0, 0), torch.float32, torch.float32, 8.0),
    "mean8_bf16": ((2, 16, 8000), (0, 0), torch.bfloat16, torch.bfloat16, 8.0),
    "fp32_bf16_affine": ((2, 6, 4096), (0, 0), torch.float32, torch.bfloat16, 0.0),
    "trim_shifted_bf16": ((2, 128, 12_165), (3, 2), torch.bfloat16, torch.bfloat16, 0.0),
    "trim_shifted_fp32": ((2, 64, 4_100), (2, 2), torch.float32, torch.float32, 0.0),
    "trim_aligned_bf16": ((2, 8, 1_032), (8, 0), torch.bfloat16, torch.bfloat16, 0.0),
    "trim_scalar_bf16": ((2, 4, 45), (1, 1), torch.bfloat16, torch.bfloat16, 0.0),
    "2d_scalar_bf16": ((2, 4, 33, 501), (0, 0), torch.bfloat16, torch.bfloat16, 0.0),
    "2d_vector_bf16": ((2, 8, 16, 64), (0, 0), torch.bfloat16, torch.bfloat16, 0.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(TGN_CASES))
def test_cuda_tgn_norm_matches_reference(cuda, case):
    shape, trim, dtype, pdtype, mean = TGN_CASES[case]
    rs = np.random.RandomState(len(case))
    x = torch.from_numpy((mean + rs.randn(*shape)).astype(np.float32)).to(cuda, dtype)
    gamma = torch.from_numpy(1 + rs.uniform(-0.5, 0.5, shape[1]).astype(np.float32)).to(cuda, pdtype)
    beta = torch.from_numpy(rs.uniform(-0.1, 0.1, shape[1]).astype(np.float32)).to(cuda, pdtype)
    before = tgn_kernel.LAUNCHES
    y = tgn_kernel.time_group_norm(x, gamma, beta, trim)
    torch.cuda.synchronize()
    assert tgn_kernel.LAUNCHES == before + 1
    assert torch.equal(tgn_kernel.time_group_norm(x, gamma, beta, trim), y)  # the same from run to run
    ref = tgn_kernel.time_group_norm_reference(x, gamma, beta, trim)
    assert y.dtype == dtype and y.shape == ref.shape and y.is_contiguous()
    err = float((y.float() - ref.float()).abs().max())
    tol = ulps2(ref) / 2 if dtype == torch.bfloat16 else 2.0 ** -20 * float(ref.abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.gpu
def test_cuda_tgn_norm_routing(cuda):
    """No grad: ops/conv.py's norms run the kernels (a transposed conv's trim
    written contiguous); grad needed: the fp32 F.group_norm chain and its graph."""
    spec = tconv.ConvSpec(16, 8, 8, stride=4, norm="time_group_norm", transposed=True)
    conv = tconv.make_conv(spec, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    x = torch.randn(2, 16, 301, device=cuda)
    before = tgn_kernel.LAUNCHES
    with torch.no_grad():
        y = conv(x)
        full = torch.nn.functional.conv_transpose1d(x, conv.convtr.convtr.weight, conv.convtr.convtr.bias, stride=4)
        ref = tgn_kernel.time_group_norm_reference(full, *conv.convtr.norm_params(), (2, 2))
    assert tgn_kernel.LAUNCHES == before + 1 and y.is_contiguous()
    assert float((y - ref).abs().max()) <= 2.0 ** -20 * float(ref.abs().max())
    y_grad = conv(x.requires_grad_(True))
    assert tgn_kernel.LAUNCHES == before + 1 and y_grad.grad_fn is not None
    norm = conv.convtr.norm
    chain = torch.nn.functional.group_norm(full, 1, norm.weight, norm.bias, eps=1e-5)[..., 2:-2]
    assert torch.equal(y_grad.detach(), chain)


@pytest.mark.gpu
def test_cuda_tgn_norm_rejects_bad_inputs(cuda):
    x = torch.zeros(2, 4, 64, device=cuda)
    g = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tgn_kernel.time_group_norm(x.half(), g, g)
    with pytest.raises(ValueError, match="one type"):
        tgn_kernel.time_group_norm(x, g, g.bfloat16())
    with pytest.raises(ValueError, match="range"):
        tgn_kernel.time_group_norm(torch.zeros(1, 8192, 2, device=cuda), torch.ones(8192, device=cuda),
                                   torch.ones(8192, device=cuda))


# ---------------------------------------------------------------------------
# the backwards: the Functions around the kernels against autograd through the
# plain versions (fp32: summation order; bf16: the plain version's bf16 casts)
# ---------------------------------------------------------------------------

BACKWARD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _max_rel(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", [
    (2, 1, 32, 4003, 7, 1, False, "reflect", None),  # the encoder's first conv
    (2, 32, 1, 4001, 7, 1, False, "reflect", "elu"),  # the decoder's last
    (2, 512, 128, 130, 7, 1, False, "reflect", "elu"),  # the encoder's last
    (2, 128, 512, 130, 7, 1, False, "reflect", None),  # the decoder's first
    (2, 64, 32, 1003, 3, 3, True, "replicate", "elu"),
    (2, 24, 40, 300, 3, 1, False, "constant", "gelu"),
], ids=["1to32", "32to1-elu", "512to128-elu", "128to512", "64to32-d3-causal", "24to40-gelu"])
def test_cuda_conv_backward_matches_autograd_of_the_plain_version(cuda, case, dtype):
    B, Cin, Cout, T, K, dil, causal, pad_mode, act = case
    rs = np.random.RandomState(Cin + Cout)
    x = torch.from_numpy(rs.randn(B, Cin, T).astype(np.float32)).to(cuda, dtype).requires_grad_()
    w = torch.from_numpy((rs.uniform(-1, 1, (Cout, Cin, K)) / np.sqrt(Cin * K)).astype(np.float32)).to(cuda)
    b = torch.from_numpy((0.1 * rs.randn(Cout)).astype(np.float32)).to(cuda)
    w, b = w.to(dtype).requires_grad_(), b.requires_grad_()
    cot = torch.from_numpy(rs.randn(B, Cout, T).astype(np.float32)).to(cuda)
    left, right = split_padding(conv_padding_total(K, 1, dil), causal)
    before = conv_kernel.LAUNCHES
    y = conv_kernel.fused_conv1d_s1(x, w, b, left, right, dil, pad_mode, act)
    got = torch.autograd.grad((y.float() * cot).sum(), (x, w, b))
    torch.cuda.synchronize()
    assert conv_kernel.LAUNCHES == before + 1  # the forward's; the backward launches none
    ref = conv_kernel.fused_conv1d_s1_reference(x, w, b, left, right, dil, pad_mode, act)
    want = torch.autograd.grad((ref.float() * cot).sum(), (x, w, b))
    assert [g.dtype for g in got] == [dtype, dtype, torch.float32]
    assert _max_rel(got, want) <= BACKWARD_REL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("C,T,dil,causal", [(32, 4000, 1, False), (64, 2000, 1, False), (128, 500, 1, False),
                                            (256, 130, 1, False), (64, 1003, 3, True)],
                         ids=["C32", "C64", "C128", "C256", "C64-d3-causal"])
def test_cuda_resblock_backward_matches_autograd_of_the_plain_version(cuda, C, T, dil, causal, dtype):
    convs = _resblock_convs(C, 3, dil, causal, cuda, seed=C)
    params = [p for m in convs for p in m.parameters()]
    rs = np.random.RandomState(C)
    x = torch.from_numpy(rs.randn(2, C, T).astype(np.float32)).to(cuda, dtype).requires_grad_()
    cot = torch.from_numpy(rs.randn(2, C, T).astype(np.float32)).to(cuda)
    before = resblock_kernel.LAUNCHES
    y = resblock_kernel.fused_resblock_tgn(x, *convs)
    got = torch.autograd.grad((y.float() * cot).sum(), [x, *params])
    torch.cuda.synchronize()
    assert resblock_kernel.LAUNCHES == before + 3  # the forward's three passes; the backward launches none
    ref = resblock_kernel.fused_resblock_tgn_reference(x, *convs)
    want = torch.autograd.grad((ref.float() * cot).sum(), [x, *params])
    assert got[0].dtype == dtype and all(torch.isfinite(g).all() for g in got)
    assert _max_rel(got, want) <= BACKWARD_REL[dtype]
