"""What the redesigned fused stride-1 conv keeps in Python, on the CPU.

The kernels run only on a card (tests/test_torch_kernels.py). Here: the
regime choice (``conv_kernel.plan``, the mirror of csrc/conv1d_s1.cu's
plan_of) for every stride-1 conv of the flagship, the tensor-core kernels'
shared-memory layout, the persistent schedule's work-item order, the packed
weight layout read back against the weight, and the packed-weight cache.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from funcodec_tpu_torch.ops import conv_kernel as ck
from funcodec_tpu_torch.ops.conv import SConv1d
from funcodec_tpu_torch.ops.pad import conv_padding_total, split_padding
from funcodec_tpu_torch.tasks.codec import build_codec_model, load_config

torch.set_num_threads(1)

FLAGSHIP_YAML = Path(__file__).resolve().parents[1] / "egs/LibriTTS/codec/conf/encodec_16k_n32_600k_step.yaml"

# (Cin, Cout, K, dilation, left) -> (regime, output channels a work item, input channels a chunk) in bf16
FLAGSHIP_PLANS = {
    (1, 32, 7, 1, 3): ("thin", 0, 0),  # encoder first
    (512, 128, 7, 1, 3): ("tc_streamed", 64, 16),  # encoder last (917 KB of weights), two blocks an SM
    (128, 512, 7, 1, 3): ("tc_streamed", 64, 16),  # decoder first (8 output-channel tiles)
    (32, 1, 7, 1, 3): ("thin", 0, 0),  # decoder last
    (32, 16, 3, 1, 1): ("tc_resident", 16, 32),  # resblock k3 convs
    (64, 32, 3, 1, 1): ("tc_resident", 32, 32),
    (128, 64, 3, 1, 1): ("tc_resident", 64, 32),
    (256, 128, 3, 1, 1): ("tc_streamed", 64, 32),  # two output-channel tiles of 98 KB of weights
}


def _flagship_stride1_convs():
    config = load_config(str(FLAGSHIP_YAML))
    config["quantizer_conf"]["kmeans_init"] = False
    model, _ = build_codec_model(config, device="cpu", generator=torch.Generator().manual_seed(0))
    out = set()
    for m in model.modules():
        if isinstance(m, SConv1d):
            s = m.spec
            if s.stride == 1 and s.groups == 1 and s.kernel_size > 1 and not s.transposed:
                left, _ = split_padding(conv_padding_total(s.kernel_size, 1, s.dilation), s.causal)
                out.add((s.in_channels, s.out_channels, s.kernel_size, s.dilation, left))
    return out


def test_plan_of_every_flagship_conv():
    layers = _flagship_stride1_convs()
    assert layers == set(FLAGSHIP_PLANS)  # every stride-1 conv the fused path can take
    for (cin, cout, K, dil, left), expect in FLAGSHIP_PLANS.items():
        p = ck.plan(cin, cout, K, dil, left, torch.bfloat16)
        assert tuple(p) == expect, (cin, cout, p)
        assert ck.plan(cin, cout, K, dil, left, torch.float32) is None  # no kernel takes fp32
        if p.chunk:
            resident = p.regime == "tc_resident"
            assert ck.tc_layout(p.out_tile, p.chunk, cin, cout, K, dil, left, resident) <= ck.MAX_SMEM
            if not resident and cout == p.out_tile:  # streamed because the whole matrix does not fit
                assert all(ck.tc_layout(p.out_tile, cc, cin, cout, K, dil, left, True) > ck.MAX_SMEM for cc in (32, 16))


def test_plan_keeps_the_most_blocks_on_an_sm():
    """Chunks of 16 where 32 would hold one block an SM (the heads), 32 where both hold two."""
    assert ck.tc_blocks_per_sm(ck.MAX_SMEM + 1) == 0 and ck.tc_blocks_per_sm(ck.MAX_SMEM) == 1
    assert ck.tc_blocks_per_sm(1) == ck.MAX_BLOCKS == 2
    assert ck.tc_blocks_per_sm(ck.SM_SMEM // 2 - 1024) == 2 and ck.tc_blocks_per_sm(ck.SM_SMEM // 2 - 1023) == 1
    for cin, cout, cc, blocks in ((512, 128, 32, 1), (512, 128, 16, 2), (128, 512, 32, 1), (128, 512, 16, 2),
                                  (256, 128, 32, 2), (256, 128, 16, 2)):
        assert ck.tc_blocks_per_sm(ck.tc_layout(64, cc, cin, cout, 7 if cin + cout == 640 else 3, 1,
                                                3 if cin + cout == 640 else 1, False)) == blocks
    assert ck.tc_blocks_per_sm(ck.tc_layout(64, 32, 128, 64, 3, 1, 1, True)) == 2  # resident at 108 KB


@pytest.mark.parametrize(
    "cin,cout,K,dil,left,regime",
    [(24, 40, 3, 3, 3, None), (1, 32, 7, 2, 6, None), (1, 32, 7, 1, 6, "thin"), (32, 1, 3, 1, 2, "thin"),
     (1, 1, 5, 1, 2, "thin"), (1, 32, 9, 1, 4, None), (16, 32, 3, 1, 1, "tc_resident"),
     (48, 96, 5, 2, 4, "tc_streamed"), (8, 32, 3, 1, 1, None), (64, 32, 3, 9, 18, "tc_resident"),
     (512, 512, 7, 1, 3, "tc_streamed"), (64, 32, 3, 1000, 2000, None)],
)
def test_plan_of_other_shapes(cin, cout, K, dil, left, regime):
    """None: no kernel takes the layer (channels no multiple of 16 outside
    "thin", a thin geometry it is not built for, no tensor-core candidate
    that fits an SM), so a CUDA call declines."""
    p = ck.plan(cin, cout, K, dil, left, torch.bfloat16)
    if regime is None:
        assert p is None
        return
    assert p.regime == regime and regime in ck.REGIMES
    if regime.startswith("tc"):
        assert cout % p.out_tile == 0 and cin % p.chunk == 0 and p.chunk in (16, 32)
        assert ck.tc_layout(p.out_tile, p.chunk, cin, cout, K, dil, left, regime == "tc_resident") <= ck.MAX_SMEM
    else:
        assert p.out_tile == p.chunk == 0


def test_tc_layout_of_the_heads():
    """The shared memory the blocks ask for, piece by piece
    (csrc/conv1d_s1.cuh tc_layout)."""
    # 512 -> 128 k7, 64-channel tiles, chunks of 32: 2 weight stages of 64 x (7 * 32 + 8) bf16, 2 windows
    # of 32 x 280 (+ 64 B), the time-major chunk (262 x 40), bias, dummy; the output tile (64 x 264)
    # lies over a window buffer and the chunk
    expect = 2 * 29_696 + 2 * 18_048 + 20_992 + 512 + 128
    assert ck.tc_layout(64, 32, 512, 128, 7, 1, 3, False) == expect == 117_120
    # 128 -> 64 k3: the whole weight matrix resident (4 chunks of 64 x (3 * 32 + 8))
    assert ck.tc_layout(64, 32, 128, 64, 3, 1, 1, True) == 4 * 13_312 + 2 * 18_048 + 20_736 + 256 + 128
    # chunks of 16: the output tile no longer fits over a window buffer and the chunk
    assert ck.tc_layout(64, 16, 512, 128, 7, 1, 3, False) == 2 * 15_360 + 2 * 9_088 + 12_672 + 33_792 + 512 + 128
    assert ck.tc_layout(64, 32, 512, 128, 7, 1, 3, True) > ck.MAX_SMEM  # why the heads stream their weights


@pytest.mark.parametrize("B,T,n_o", [(64, 500, 2), (64, 500, 8), (64, 160_000, 1), (3, 1003, 2), (1, 100, 1)])
@pytest.mark.parametrize("n_blocks", [132, 264, 396, 7, 1])
def test_work_items_visit_every_item_once(B, T, n_o, n_blocks):
    n_t = -(-T // ck.TILE)
    grid = min(n_blocks, B * n_t * n_o)  # the launch gives no block without a work item
    seen = np.zeros((B, n_t, n_o), dtype=np.int64)
    for block in range(grid):
        items = ck.work_items(block, grid, B, n_t, n_o)
        assert items
        flat = [(b * n_t + t) * n_o + o for b, t, o in items]
        assert flat == list(range(block, B * n_t * n_o, grid))  # rising, a fixed stride apart
        for b, t, o in items:
            seen[b, t, o] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("cout,cin,K,chunk", [(128, 512, 7, 32), (512, 128, 7, 32), (16, 32, 3, 32), (32, 1, 7, 0),
                                              (1, 32, 7, 0), (40, 24, 3, 0), (96, 48, 5, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_packed_layout_reads_back(cout, cin, K, chunk, dtype):
    w = torch.from_numpy(np.random.RandomState(cout + cin).randn(cout, cin, K).astype(np.float32))
    p = ck.pack_weight(w, dtype, chunk)
    assert p.dtype == dtype and p.is_contiguous()
    wd = w.to(dtype)
    if chunk == 0:
        assert p.shape == (cout, K, cin)
        assert torch.equal(p, wd.permute(0, 2, 1))
        return
    assert p.shape == (cin // chunk, cout, K, chunk)
    ch, o, k, c = (torch.arange(n).reshape(*[-1 if i == j else 1 for j in range(4)]) for i, n in
                   enumerate(p.shape))
    assert torch.equal(p, wd[o, ch * chunk + c, k])
    # a chunk of an output-channel tile is NO contiguous rows of K * chunk values
    flat = p.reshape(-1)
    n0, c0 = min(16, cout - 1), cin // chunk - 1
    row = flat[(c0 * cout + n0) * K * chunk: (c0 * cout + n0 + 1) * K * chunk].reshape(K, chunk)
    assert torch.equal(row, wd[n0, c0 * chunk: (c0 + 1) * chunk, :].t())


def _conv(cin=32, cout=16, K=3, seed=0, bias=True):
    w = torch.from_numpy(np.random.RandomState(seed).randn(cout, cin, K).astype(np.float32))
    b = torch.from_numpy(np.random.RandomState(seed + 1).randn(cout).astype(np.float32)) if bias else None
    return w, b


@pytest.mark.parametrize("change", ["mul_weight", "load_state_dict", "mul_bias", "other_bias", "dtype", "chunk",
                                    "new_weight"])
def test_packed_conv_weights_cache_is_rebuilt(change):
    w, b = _conv(seed=1)
    dtype, chunk = torch.bfloat16, 32
    first = ck.packed_conv_weights(w, b, dtype, chunk)
    assert ck.packed_conv_weights(w, b, dtype, chunk) is first  # a hit: nothing is repacked
    if change == "mul_weight":
        w.mul_(0.5)
    elif change == "load_state_dict":  # what load_state_dict does to a parameter
        w.copy_(_conv(seed=3)[0])
    elif change == "mul_bias":
        b.mul_(3.0)
    elif change == "other_bias":
        b = b.clone() + 1.0
    elif change == "dtype":
        dtype = torch.float32
    elif change == "chunk":
        chunk = 16
    else:
        w = w.clone() - 1.0
    second = ck.packed_conv_weights(w, b, dtype, chunk)
    assert second is not first
    assert torch.equal(second["w"], ck.pack_weight(w, dtype, chunk))
    assert second["bias"].dtype == torch.float32 and torch.equal(second["bias"], b.float())


def test_packed_conv_weights_zero_bias_and_parameters():
    conv = torch.nn.Conv1d(32, 16, 3)
    pack = ck.packed_conv_weights(conv.weight, None, torch.bfloat16, 32)
    assert torch.equal(pack["bias"], torch.zeros(16)) and pack["bias"].dtype == torch.float32
    assert ck.packed_conv_weights(conv.weight, None, torch.bfloat16, 32) is pack
    with_bias = ck.packed_conv_weights(conv.weight, conv.bias, torch.bfloat16, 32)
    assert with_bias is not pack and torch.equal(with_bias["bias"], conv.bias.detach())
    conv.load_state_dict(torch.nn.Conv1d(32, 16, 3).state_dict())
    again = ck.packed_conv_weights(conv.weight, conv.bias, torch.bfloat16, 32)
    assert again is not with_bias and torch.equal(again["bias"], conv.bias.detach())
    assert not again["w"].requires_grad


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_cpu_tensors_take_the_plain_version(dtype):
    """A CPU tensor runs the plain version in either type (fp32 too, which no
    kernel takes) and launches nothing."""
    w, b = _conv(seed=5)
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 32, 100).astype(np.float32)).to(dtype)
    before = ck.LAUNCHES
    y = ck.fused_conv1d_s1(x, w, b, 1, 1, 1, "reflect", "elu")
    assert ck.LAUNCHES == before
    assert y.dtype == dtype and torch.equal(y, ck.fused_conv1d_s1_reference(x, w, b, 1, 1, 1, "reflect", "elu"))
    assert ck.REGIMES == (None, "thin", "tc_resident", "tc_streamed")

