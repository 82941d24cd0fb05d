"""Whole-resblock fused kernel for time_group_norm SEANet stacks: wrapper and plain version.

Counterpart of funcodec_tpu/ops/resblock_pallas.py. One SEANet residual
block, ``tgn2(conv2_1x1(ELU(tgn1(conv1_kd(ELU(x)))))) + tgn3(shortcut_1x1(x))``
on torch's (B, C, T) layout, runs as three launches of csrc/resblock_tgn.cu
that each recompute the convs from x: A (statistics of conv1 and the
shortcut), B (statistics of conv2), C (the output). Between launches
``finalize_affine`` turns the per-tile (sum, sumsq) partials into per-sample,
per-channel affines, in plain torch on the tiny (B, n_tiles, 4) tensor, so
each normalisation in the kernel is one multiply-add. No intermediate
(B, C, T) tensor is written.

``fused_resblock_tgn_reference`` repeats the kernel's arithmetic in plain
torch, with its rounding points (resblock_pallas.py:116-160): b rounded to
x's type after its bias; tgn1 applied as an fp32 affine and not rounded
before the ELU; v = ELU(.) rounded; c rounded; each normalised branch
rounded; their sum in x's type. Statistics are (sum, sumsq) in fp64 and
var = max(E[y^2] - mu^2, 0), the kernel's formula; the unfused path's
mean-then-variance is not followed.

Gates (``None``) are those of the JAX function: 1D convs of stride 1 and
groups 1 with time_group_norm on all three, conv2 and the shortcut 1x1,
K >= 2, a pad mode in {reflect, replicate, constant, zero}, T above the
pad1d small-input regime; and C, H <= 256, the widest block whose tile the
kernel holds in one block's shared memory. The TPU-only gates (the
channel-packed ``packed_f`` view, the 8-row halo cap, ``_pick_even_tile``)
are dropped: the kernel computes its halo by index arithmetic and masks the
ragged last tile.

The wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises. Forward only: a tensor that
requires grad, with grad enabled, raises (training is slice B).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from funcodec_tpu_torch.kernels import build
from funcodec_tpu_torch.ops.conv_kernel import DTYPES, PAD_MODES, apply_act, check_no_grad
from funcodec_tpu_torch.ops.pad import conv_padding_total, pad1d_time, split_padding

# Kernel launches since the last reset (three per block); a run sets it to 0
# and reads it back to show that its main path went through the kernel.
LAUNCHES = 0

MAX_C = 256
EPS = 1e-5


def finalize_affine(
    s: torch.Tensor, sq: torch.Tensor, n_elems: int, gamma: torch.Tensor, beta: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (sum, sumsq) (B,) -> per-(sample, channel) fp32 affine A, D
    with tgn(y) = y * A + D = (y - mu) * rsqrt(var + eps) * gamma + beta.
    Computed in fp64 (counterpart of resblock_pallas._finalize_affine)."""
    mu = s.double() / n_elems
    var = torch.clamp(sq.double() / n_elems - mu * mu, min=0.0)
    rs = torch.rsqrt(var + EPS)
    g = gamma.double()[None, :]
    a = rs[:, None] * g
    d = beta.double()[None, :] - (mu * rs)[:, None] * g
    return a.float(), d.float()


def _plan(x: torch.Tensor, conv1, conv2, shortcut) -> Optional[Tuple[int, int, int, int]]:
    """(K, dilation, left, right) of conv1, or None when the block does not qualify."""
    if x.dim() != 3:
        return None
    specs = [getattr(m, "spec", None) for m in (conv1, conv2, shortcut)]
    if any(s is None for s in specs):
        return None
    spec1, spec2, spec_s = specs
    for sp in specs:
        if sp.transposed or sp.stride != 1 or sp.groups != 1 or sp.norm != "time_group_norm":
            return None
    if spec2.kernel_size != 1 or spec_s.kernel_size != 1:
        return None
    K, d = spec1.kernel_size, spec1.dilation
    if K < 2 or spec1.pad_mode not in PAD_MODES:
        return None
    C, T = x.shape[1], x.shape[2]
    H = spec1.out_channels
    if spec1.in_channels != C or spec2.in_channels != H or spec2.out_channels != C:
        return None
    if spec_s.in_channels != C or spec_s.out_channels != C:
        return None
    if C > MAX_C or H > MAX_C:
        return None
    left, right = split_padding(conv_padding_total(K, 1, d), spec1.causal)
    if T <= max(left, right):  # pad1d small-input fixup regime
        return None
    return K, d, left, right


def _bias(b: Optional[torch.Tensor], n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(n, device=like.device) if b is None else b.float().contiguous()


def fused_resblock_tgn_reference(x: torch.Tensor, conv1, conv2, shortcut) -> torch.Tensor:
    """Plain torch with the kernel's numerics; conv1/conv2/shortcut are the
    block's SConv1d modules. x (B, C, T) -> (B, C, T) in x's type."""
    plan = _plan(x, conv1, conv2, shortcut)
    if plan is None:
        raise ValueError("fused_resblock_tgn_reference: the block does not qualify")
    _, d, left, right = plan
    dt = x.dtype
    B, C, T = x.shape
    w1, b1, g1, be1 = conv1.params()
    w2, b2, g2, be2 = conv2.params()
    ws, bs, gs, bes = shortcut.params()
    H = w1.shape[0]

    def conv(u, w, b, dilation=1):
        y = F.conv1d(u.float(), w.to(dt).float(), None if b is None else b.float(), dilation=dilation)
        return y.to(dt)

    def sums(y):
        yd = y.double()
        return yd.sum(dim=(1, 2)), (yd * yd).sum(dim=(1, 2))

    u = pad1d_time(apply_act(x, "elu"), (left, right), mode=conv1.spec.pad_mode)
    b = conv(u, w1, b1, d)
    s = conv(x, ws, bs)
    a1, d1 = finalize_affine(*sums(b), T * H, g1, be1)
    a3, d3 = finalize_affine(*sums(s), T * C, gs, bes)
    v = apply_act(b.float() * a1[:, :, None] + d1[:, :, None], "elu").to(dt)
    c = conv(v, w2, b2)
    a2, d2 = finalize_affine(*sums(c), T * C, g2, be2)
    cn = (c.float() * a2[:, :, None] + d2[:, :, None]).to(dt)
    sn = (s.float() * a3[:, :, None] + d3[:, :, None]).to(dt)
    return cn + sn


def fused_resblock_tgn(x: torch.Tensor, conv1, conv2, shortcut) -> Optional[torch.Tensor]:
    """One fused residual block; conv1 (K, d), conv2 (1x1) and shortcut (1x1)
    are the block's SConv1d modules. x (B, C, T) -> (B, C, T), or None when
    the block does not qualify."""
    plan = _plan(x, conv1, conv2, shortcut)
    if plan is None:
        return None
    K, d, left, _ = plan
    w1, b1, g1, be1 = conv1.params()
    w2, b2, g2, be2 = conv2.params()
    ws, bs, gs, bes = shortcut.params()
    check_no_grad("fused_resblock_tgn", x, w1, b1, g1, be1, w2, b2, g2, be2, ws, bs, gs, bes)
    if x.device.type == "cpu":
        return fused_resblock_tgn_reference(x, conv1, conv2, shortcut)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock_tgn: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"fused_resblock_tgn: x is {x.dtype}; the kernel takes float32 or bfloat16")
    dt = x.dtype
    B, C, T = x.shape
    H = w1.shape[0]
    xc = x.contiguous()
    args = dict(
        x=xc,
        w1=w1.to(dt).permute(0, 2, 1).contiguous(),  # (H, K, C)
        b1=_bias(b1, H, x),
        w2=w2.to(dt)[:, :, 0].contiguous(),  # (C, H)
        b2=_bias(b2, C, x),
        ws=ws.to(dt)[:, :, 0].contiguous(),  # (C, C)
        bs=_bias(bs, C, x),
    )
    tile = build.load().resblock_tgn_tile(C, H, DTYPES[dt])
    part = torch.empty((B, -(-T // tile), 4), dtype=torch.float64, device=x.device)
    aff = torch.zeros((B, 6, C), dtype=torch.float32, device=x.device)
    y = torch.empty_like(xc)
    geometry = (K, d, left, PAD_MODES[conv1.spec.pad_mode])

    launch_resblock_tgn(0, aff=aff, part=part, y=y, geometry=geometry, **args)
    tot = part.sum(dim=1)
    aff[:, 0, :H], aff[:, 1, :H] = finalize_affine(tot[:, 0], tot[:, 1], T * H, g1, be1)
    aff[:, 4], aff[:, 5] = finalize_affine(tot[:, 2], tot[:, 3], T * C, gs, bes)
    launch_resblock_tgn(1, aff=aff, part=part, y=y, geometry=geometry, **args)
    tot = part.sum(dim=1)
    aff[:, 2], aff[:, 3] = finalize_affine(tot[:, 0], tot[:, 1], T * C, g2, be2)
    launch_resblock_tgn(2, aff=aff, part=part, y=y, geometry=geometry, **args)
    return y


def launch_resblock_tgn(mode: int, *, x, w1, b1, w2, b2, ws, bs, aff, part, y, geometry) -> None:
    """Launch one pass (mode 0/1/2) of csrc/resblock_tgn.cu on the current
    stream of x's device. x, y (B, C, T) and w1 (H, K, C), w2 (C, H),
    ws (C, C) in x's type; b1, b2, bs, aff (B, 6, C) fp32; part (B, n_t, 4) fp64."""
    global LAUNCHES
    K, dilation, left, pad_mode = geometry
    B, C, T = x.shape
    H = w1.shape[0]
    lib = build.load()
    n_t = -(-T // lib.resblock_tgn_tile(C, H, DTYPES[x.dtype]))
    expect = {
        "x": (x, x.dtype, (B, C, T)),
        "w1": (w1, x.dtype, (H, K, C)),
        "b1": (b1, torch.float32, (H,)),
        "w2": (w2, x.dtype, (C, H)),
        "b2": (b2, torch.float32, (C,)),
        "ws": (ws, x.dtype, (C, C)),
        "bs": (bs, torch.float32, (C,)),
        "aff": (aff, torch.float32, (B, 6, C)),
        "part": (part, torch.float64, (B, n_t, 4)),
        "y": (y, x.dtype, (B, C, T)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"resblock_tgn: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"resblock_tgn: {name} is {t.dtype}{tuple(t.shape)}, needs contiguous, "
                             f"16-byte aligned {dtype}{shape}")
    if not (0 < C <= MAX_C and 0 < H <= MAX_C) or B > 65535:
        raise ValueError(f"resblock_tgn: C={C}, H={H}, B={B} outside the kernel's range")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.resblock_tgn_launch(
            mode, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ws.data_ptr(),
            bs.data_ptr(), aff.data_ptr(), part.data_ptr(), y.data_ptr(), B, C, H, T, K, dilation, left,
            pad_mode, DTYPES[x.dtype], stream)
    build.check(lib, rc, "resblock_tgn_launch")
    LAUNCHES += 1
