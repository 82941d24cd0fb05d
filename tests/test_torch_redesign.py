"""What the persistent resblock kernel and the wgmma RVQ kernel keep in Python.

The kernels run only on a card (tests/test_torch_kernels.py). Here, on the
CPU: the persistent schedule's work-item order, the pre-arranged codebook
image the kernel's bulk copies deliver to wgmma, a plain-torch mirror of the
device finalize against finalize_affine, and the wrappers' caches of packed
weights and prepared codebooks.
"""

import numpy as np
import pytest
import torch

from funcodec_tpu_torch.ops import conv as tconv
from funcodec_tpu_torch.ops import resblock_kernel as rk
from funcodec_tpu_torch.quant import rvq_kernel

torch.set_num_threads(1)


@pytest.mark.parametrize("B,T", [(1, 4000), (16, 16_000), (64, 160_000), (3, 80_003), (2, 100), (2, 257)])
@pytest.mark.parametrize("tile,n_blocks", [(256, 396), (128, 264), (64, 132), (256, 5), (64, 1)])
def test_work_items_visit_every_tile_once(B, T, tile, n_blocks):
    n_t = -(-T // tile)
    grid = min(n_blocks, B * n_t)  # the launch gives no block without a work item
    seen = np.zeros((B, n_t), dtype=np.int64)
    for block in range(grid):
        items = rk.work_items(block, grid, B, n_t)
        assert items, "a block of the grid has no work item"
        flat = [b * n_t + t for b, t in items]
        assert flat == list(range(block, B * n_t, grid))  # rising, a fixed stride apart
        for b, t in items:
            seen[b, t] += 1
    assert (seen == 1).all()


def test_arranged_offset_is_a_bijection_with_16_byte_pieces_intact():
    n = torch.arange(rvq_kernel.CHUNK)[:, None]
    d = torch.arange(rvq_kernel.KERNEL_DIM)[None, :]
    off = rvq_kernel.arranged_offset(n, d)
    assert sorted(off.reshape(-1).tolist()) == list(range(rvq_kernel.CHUNK * rvq_kernel.KERNEL_DIM))
    # 8 neighbouring columns stay one 16-byte piece; a row of a 64-column block stays within its 128 bytes
    assert (off[:, 1:8] - off[:, :1] == torch.arange(1, 8)).all()
    assert (off[:, :64] // 64 == n).all() and (off[:, 64:] // 64 == rvq_kernel.CHUNK + n).all()
    # the swizzle: piece p of row n sits at p ^ (n % 8)
    assert (off[:, 0:64:8] % 64 // 8 == (torch.arange(8)[None, :] ^ (n % 8))).all()


@pytest.mark.parametrize("bins", [1024, 1000, 200, 128, 1])
def test_arranged_codebooks_read_back(bins):
    embed = torch.from_numpy(np.random.RandomState(bins).randn(3, bins, 128).astype(np.float32)).to(torch.bfloat16)
    arranged = rvq_kernel.arrange_codebooks(embed)
    n_ch = -(-bins // rvq_kernel.CHUNK)
    assert arranged.shape == (3, n_ch, 128 * 128) and arranged.dtype == torch.bfloat16 and arranged.is_contiguous()
    assert torch.equal(rvq_kernel.read_arranged(arranged, bins), embed)
    # the rows past bins are zero
    assert float(arranged.float().abs().sum()) == pytest.approx(float(embed.float().abs().sum()), rel=1e-6)
    q, b, d = 2, bins - 1, 77
    at = int(rvq_kernel.arranged_offset(torch.tensor(b % 128), torch.tensor(d)))
    assert arranged[q, b // 128, at] == embed[q, b, d]


@pytest.mark.parametrize("bins", [1024, 1000])
def test_prepared_codebooks_norms_and_padding(bins):
    embed = torch.from_numpy(np.random.RandomState(1).randn(4, bins, 128).astype(np.float32)) * 0.1
    p = rvq_kernel.prepared_codebooks(embed)
    n_ch = -(-bins // 128)
    assert p["esq"].shape == (4, n_ch * 128) and p["esq"].dtype == torch.float32
    assert torch.equal(p["esq"][:, :bins], rvq_kernel.embed_sq(embed, 4))
    assert torch.isinf(p["esq"][:, bins:]).all() and (p["esq"][:, bins:] > 0).all()
    assert torch.equal(p["embed"], embed.to(torch.bfloat16))
    assert torch.equal(p["arranged"], rvq_kernel.arrange_codebooks(embed.to(torch.bfloat16)))


@pytest.mark.parametrize("change", ["mul_", "copy_", "to_bf16", "new_tensor"])
def test_prepared_codebooks_cache_is_rebuilt(change):
    embed = torch.from_numpy(np.random.RandomState(2).randn(2, 64, 128).astype(np.float32))
    first = rvq_kernel.prepared_codebooks(embed)
    assert rvq_kernel.prepared_codebooks(embed) is first  # a hit: nothing is recomputed
    if change == "mul_":
        embed.mul_(0.5)
    elif change == "copy_":  # what load_state_dict does
        embed.copy_(torch.from_numpy(np.random.RandomState(3).randn(2, 64, 128).astype(np.float32)))
    elif change == "to_bf16":
        embed = embed.to(torch.bfloat16)
    else:
        embed = embed.clone() + 1.0
    second = rvq_kernel.prepared_codebooks(embed)
    assert second is not first
    fresh = dict(embed=embed.to(torch.bfloat16), esq=rvq_kernel.embed_sq(embed, 2))
    assert torch.equal(second["embed"], fresh["embed"])
    assert torch.equal(second["esq"][:, :64], fresh["esq"])
    assert torch.equal(rvq_kernel.read_arranged(second["arranged"], 64), fresh["embed"])


def _convs(C, K=3, dil=1, seed=0):
    gen = torch.Generator().manual_seed(seed)
    convs = []
    for cin, cout, k, d in ((C, C // 2, K, dil), (C // 2, C, 1, 1), (C, C, 1, 1)):
        m = tconv.SConv1d(tconv.ConvSpec(cin, cout, k, dilation=d, norm="time_group_norm"), device="cpu", generator=gen)
        with torch.no_grad():
            m.conv.norm.weight.uniform_(0.5, 1.5, generator=gen)
            m.conv.norm.bias.uniform_(-0.1, 0.1, generator=gen)
        convs.append(m)
    return convs


def _fresh_pack(convs, dtype):
    """What packed_weights must hold, built without the cache."""
    (w1, b1, g1, be1), (w2, b2, g2, be2), (ws, bs, gs, bes) = (m.params() for m in convs)
    return dict(w1=w1.detach().to(dtype).permute(0, 2, 1).contiguous(), b1=b1.detach().float(),
                w2=w2.detach().to(dtype)[:, :, 0].contiguous(), b2=b2.detach().float(),
                ws=ws.detach().to(dtype)[:, :, 0].contiguous(), bs=bs.detach().float(),
                g1=g1.detach().float(), be1=be1.detach().float(), g2=g2.detach().float(), be2=be2.detach().float(),
                gs=gs.detach().float(), bes=bes.detach().float())


def _same(pack, fresh):
    assert set(pack) == set(fresh)
    for k in fresh:
        assert pack[k].dtype == fresh[k].dtype and pack[k].is_contiguous(), k
        assert torch.equal(pack[k], fresh[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_packed_weights_layout(dtype):
    convs = _convs(32)
    pack = rk.packed_weights(*convs, dtype)
    assert pack["w1"].shape == (16, 3, 32) and pack["w2"].shape == (32, 16) and pack["ws"].shape == (32, 32)
    _same(pack, _fresh_pack(convs, dtype))
    assert rk.packed_weights(*convs, dtype) is pack


@pytest.mark.parametrize("change", ["load_state_dict", "to_bf16", "mul_weight", "mul_norm", "dtype_of_x"])
def test_packed_weights_cache_is_rebuilt(change):
    convs = _convs(32, seed=1)
    dtype = torch.float32
    first = rk.packed_weights(*convs, dtype)
    assert rk.packed_weights(*convs, dtype) is first
    if change == "load_state_dict":
        other = _convs(32, seed=2)
        for m, o in zip(convs, other):
            m.load_state_dict(o.state_dict())
    elif change == "to_bf16":
        for m in convs:
            m.to(torch.bfloat16)
        dtype = torch.bfloat16
    elif change == "mul_weight":
        with torch.no_grad():
            convs[2].conv.layer.weight.mul_(2.0)  # not the module the cache hangs on
    elif change == "mul_norm":
        with torch.no_grad():
            convs[1].conv.norm.bias.mul_(3.0)
    else:
        dtype = torch.bfloat16
    second = rk.packed_weights(*convs, dtype)
    assert second is not first
    _same(second, _fresh_pack(convs, dtype))
    # and the block computed through the cached path equals an uncached call
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 64).astype(np.float32)).to(dtype)
    with torch.no_grad():
        assert torch.equal(rk.fused_resblock_tgn(x, *convs), rk.fused_resblock_tgn_reference(x, *convs))


@pytest.mark.parametrize("B,n_t,T,n_ch", [(1, 1, 100, 16), (3, 7, 1000, 32), (16, 625, 160_000, 16), (2, 1250, 160_000, 32)])
@pytest.mark.parametrize("pair", [0, 1])
def test_finalize_mirror_matches_finalize_affine(B, n_t, T, n_ch, pair):
    rs = np.random.RandomState(n_t + pair)
    y = rs.randn(B, n_t, 64) * 2.0 + 0.3  # per-tile values whose (sum, sumsq) the partials hold
    part = np.zeros((B, n_t, 4))
    part[:, :, 2 * pair] = y.sum(-1)
    part[:, :, 2 * pair + 1] = (y * y).sum(-1)
    part = torch.from_numpy(part)
    gamma = torch.from_numpy(rs.uniform(0.5, 1.5, n_ch).astype(np.float32))
    beta = torch.from_numpy(rs.uniform(-0.1, 0.1, n_ch).astype(np.float32))
    a, d = rk.finalize_mirror(part, pair, T, gamma, beta)
    tot = part.sum(dim=1)
    ra, rd = rk.finalize_affine(tot[:, 2 * pair], tot[:, 2 * pair + 1], T * n_ch, gamma, beta)
    assert a.dtype == d.dtype == torch.float32 and a.shape == d.shape == (B, n_ch)
    # fp64 sums in another order (1e-16 relative), then the same formula and one fp32 rounding
    np.testing.assert_allclose(a.numpy(), ra.numpy(), rtol=2e-7, atol=0)
    np.testing.assert_allclose(d.numpy(), rd.numpy(), rtol=2e-7, atol=1e-9)


def test_finalize_mirror_clamps_a_negative_variance():
    part = torch.tensor([[[10.0, 1.0, 0.0, 0.0]]], dtype=torch.float64)  # sumsq / n < mu^2
    a, d = rk.finalize_mirror(part, 0, 5, torch.ones(2), torch.zeros(2))
    ra, rd = rk.finalize_affine(part[:, 0, 0], part[:, 0, 1], 10, torch.ones(2), torch.zeros(2))
    np.testing.assert_allclose(a.numpy(), ra.numpy(), rtol=2e-7)
    np.testing.assert_allclose(d.numpy(), rd.numpy(), rtol=2e-7)
    assert torch.isfinite(a).all() and torch.isfinite(d).all()


def test_new_arguments_are_rejected_on_bad_values():
    convs = _convs(32)
    x = torch.zeros(1, 32, 64, device="meta")
    with torch.no_grad(), pytest.raises(ValueError, match="device"):
        rk.fused_resblock_tgn(x, *convs)
    with pytest.raises(ValueError, match="1 or 2"):
        rk.launch_resblock_finalize(torch.zeros(1, 1, 4, dtype=torch.float64), torch.zeros(1, 6, 32), 8, [])
    with pytest.raises(ValueError, match="variant"):
        rvq_kernel.launch_rvq_encode(*[torch.zeros(1)] * 6, variant="fp8")
    assert set(rk.VARIANTS) == {"auto", "legacy"} and set(rvq_kernel.VARIANTS) == {"wgmma", "legacy"}
