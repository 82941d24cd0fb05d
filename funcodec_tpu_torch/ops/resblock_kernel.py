"""Whole-resblock fused kernel for time_group_norm SEANet stacks: wrapper and plain version.

Counterpart of funcodec_tpu/ops/resblock_pallas.py. One SEANet residual
block, ``tgn2(conv2_1x1(ELU(tgn1(conv1_kd(ELU(x)))))) + tgn3(shortcut_1x1(x))``
on torch's (B, C, T) layout, runs as three launches of csrc/resblock_tgn.cu
that each recompute the convs from x: A (statistics of conv1 and the
shortcut), B (statistics of conv2), C (the output). Between them a small
kernel of the same source (``launch_resblock_finalize``) turns the per-tile
fp64 (sum, sumsq) partials into per-sample, per-channel affines, so each
normalisation in the kernel is one multiply-add and the host launches five
kernels a block and computes nothing. No intermediate (B, C, T) tensor is
written. The passes are persistent bf16 kernels (a grid of SMs x resident
blocks walking (sample, tile) work items in the order of ``work_items``) for
the widths (C, H) of (32, 16), (64, 32), (128, 64) and (256, 128); no
kernel takes fp32, other widths or a layout that does not fit
(``resblock_tgn_kind`` 0), and a CUDA call then declines. The weights reach
the kernel as ``packed_weights`` lays them out, cached on the block's first
conv.

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
tensor it launches the kernel, or returns ``None`` where no kernel takes the
block, and the caller runs the unfused chain. Where an input requires grad,
the call is a ``torch.autograd.Function`` (funcodec_tpu's ``fused_fn``
custom_vjp): its forward is the kernel (the plain version on the CPU); its
backward replays the plain chain from the saved x and parameters under
autograd and returns the gradients of x and of every conv and norm
parameter, launching no kernel of this module.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from funcodec_tpu_torch.kernels import build
from funcodec_tpu_torch.ops.conv_kernel import PAD_MODES, apply_act
from funcodec_tpu_torch.ops.pad import conv_padding_total, pad1d_time, split_padding

# Launches of a pass since the last reset (three per block); a run sets it to 0
# and reads it back to show that its main path went through the kernel.
LAUNCHES = 0
# Launches of the finalize kernel between the passes (two per block).
FINALIZE_LAUNCHES = 0

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


@functools.lru_cache(maxsize=None)
def kernel_tile(C: int, H: int, K: int, dil: int, left: int) -> int:
    """Time steps a tile of the kernel resblock_tgn_launch runs for a bf16
    block, 0 where no kernel takes it; asked of csrc/resblock_tgn.cu once
    per block geometry."""
    return build.load().resblock_tgn_tile(C, H, K, dil, left)


def _bias(b: Optional[torch.Tensor], n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(n, device=like.device) if b is None else b.detach().float().contiguous()


def work_items(block: int, n_blocks: int, B: int, n_t: int) -> List[Tuple[int, int]]:
    """The (sample, tile) work items block `block` of a persistent grid of
    n_blocks takes, in its order: items block, block + n_blocks, ... of the
    B * n_t items numbered sample * n_t + tile (csrc/resblock_tgn.cu)."""
    return [divmod(item, n_t) for item in range(block, B * n_t, n_blocks)]


def _param_key(p: Optional[torch.Tensor]):
    if p is None:
        return None
    # an inference tensor has no version counter and cannot be updated in place
    return (p.data_ptr(), 0 if p.is_inference() else p._version, p.dtype, p.device)


def packed_weights(conv1, conv2, shortcut, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The block's parameters as the kernel reads them: w1 (H, K, C), w2
    (C, H), ws (C, C) in `dtype`; biases b1, b2, bs and the tgn scales and
    shifts g1, be1, g2, be2, gs, bes in fp32; all contiguous. Cached on conv1
    and rebuilt when any parameter's storage or version changes
    (load_state_dict, .to(dtype), an in-place update)."""
    w1, b1, g1, be1 = conv1.params()
    w2, b2, g2, be2 = conv2.params()
    ws, bs, gs, bes = shortcut.params()
    params = (w1, b1, g1, be1, w2, b2, g2, be2, ws, bs, gs, bes)
    key = (dtype, tuple(_param_key(p) for p in params))
    cached = getattr(conv1, "_resblock_pack", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    H, C = w1.shape[0], w1.shape[1]
    with torch.no_grad():
        pack = dict(
            w1=w1.detach().to(dtype).permute(0, 2, 1).contiguous(),  # (H, K, C)
            b1=_bias(b1, H, w1),
            w2=w2.detach().to(dtype)[:, :, 0].contiguous(),  # (C, H)
            b2=_bias(b2, C, w1),
            ws=ws.detach().to(dtype)[:, :, 0].contiguous(),  # (C, C)
            bs=_bias(bs, C, w1),
            g1=g1.detach().float().contiguous(), be1=be1.detach().float().contiguous(),
            g2=g2.detach().float().contiguous(), be2=be2.detach().float().contiguous(),
            gs=gs.detach().float().contiguous(), bes=bes.detach().float().contiguous(),
        )
    # the sources are held beside the pack, so that while it is cached no
    # other tensor (a later step's compute-type copy) can take their storage
    # and so their key
    conv1._resblock_pack = (key, pack, params)
    return pack


FINALIZE_THREADS = 128  # csrc/resblock_tgn.cu FIN_THREADS


def finalize_mirror(
    part: torch.Tensor, pair: int, T: int, gamma: torch.Tensor, beta: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch mirror of the device finalize: columns 2*pair, 2*pair + 1
    of part (B, n_t, 4) fp64 added up in the kernel's order (thread i takes
    tiles i, i + 128, ... in rising order, then a halving tree over the
    threads), then finalize_affine. -> fp32 (A, D), each (B, n_ch)."""
    B, n_t, _ = part.shape
    cols = part[:, :, 2 * pair: 2 * pair + 2].double()
    lanes = torch.zeros(B, FINALIZE_THREADS, 2, dtype=torch.float64, device=part.device)
    for t0 in range(0, n_t, FINALIZE_THREADS):  # rising tile order within a thread
        chunk = cols[:, t0: t0 + FINALIZE_THREADS]
        lanes[:, : chunk.shape[1]] += chunk
    off = FINALIZE_THREADS // 2
    while off > 0:
        lanes = lanes[:, :off] + lanes[:, off: 2 * off]
        off //= 2
    return finalize_affine(lanes[:, 0, 0], lanes[:, 0, 1], T * gamma.shape[0], gamma, beta)


def _block_params(conv1, conv2, shortcut) -> Tuple[Optional[torch.Tensor], ...]:
    """(w1, b1, g1, be1, w2, b2, g2, be2, ws, bs, gs, bes) of the block's convs."""
    return (*conv1.params(), *conv2.params(), *shortcut.params())


def fused_resblock_tgn_reference(x: torch.Tensor, conv1, conv2, shortcut) -> torch.Tensor:
    """Plain torch with the kernel's numerics; conv1/conv2/shortcut are the
    block's SConv1d modules. x (B, C, T) -> (B, C, T) in x's type."""
    plan = _plan(x, conv1, conv2, shortcut)
    if plan is None:
        raise ValueError("fused_resblock_tgn_reference: the block does not qualify")
    _, d, left, right = plan
    return resblock_chain(x, _block_params(conv1, conv2, shortcut), d, left, right, conv1.spec.pad_mode)


def resblock_chain(x: torch.Tensor, params, d: int, left: int, right: int, pad_mode: str) -> torch.Tensor:
    """The plain version on explicit parameters (as _block_params orders
    them); differentiable in x and in every parameter."""
    dt = x.dtype
    B, C, T = x.shape
    w1, b1, g1, be1, w2, b2, g2, be2, ws, bs, gs, bes = params
    H = w1.shape[0]

    def conv(u, w, b, dilation=1):
        y = F.conv1d(u.float(), w.to(dt).float(), None if b is None else b.float(), dilation=dilation)
        return y.to(dt)

    def sums(y):
        yd = y.double()
        return yd.sum(dim=(1, 2)), (yd * yd).sum(dim=(1, 2))

    u = pad1d_time(apply_act(x, "elu"), (left, right), mode=pad_mode)
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


def fused_resblock_tgn(x: torch.Tensor, conv1, conv2, shortcut, *, max_blocks: int = 0) -> Optional[torch.Tensor]:
    """One fused residual block; conv1 (K, d), conv2 (1x1) and shortcut (1x1)
    are the block's SConv1d modules. x (B, C, T) -> (B, C, T), or None when
    the block does not qualify or, for a CUDA tensor, no kernel takes it.
    ``max_blocks`` > 0 caps the persistent grid; it exists for tests and
    changes no result beyond the tile sums' grouping. Differentiable in x
    and in the block's parameters."""
    if max_blocks < 0:
        raise ValueError(f"fused_resblock_tgn: max_blocks={max_blocks} is negative")
    plan = _plan(x, conv1, conv2, shortcut)
    if plan is None:
        return None
    tile = 0
    if x.device.type == "cuda":  # declined unless bf16 at widths and a layout that a kernel takes
        K, d, left, _ = plan
        if x.dtype != torch.bfloat16:
            return None
        tile = kernel_tile(x.shape[1], conv1.spec.out_channels, K, d, left)
        if tile == 0:
            return None
    params = _block_params(conv1, conv2, shortcut)
    return _FusedResblockTGN.apply(x, (conv1, conv2, shortcut, plan, tile, max_blocks), *params)


class _FusedResblockTGN(torch.autograd.Function):
    """The kernel's forward; the backward replays resblock_chain from the
    saved x and parameters and returns their gradients."""

    @staticmethod
    def forward(ctx, x, call, *params):
        conv1, conv2, shortcut, plan, tile, max_blocks = call
        ctx.save_for_backward(x, *params)
        ctx.geometry = (plan[1], plan[2], plan[3], conv1.spec.pad_mode)
        return _resblock_forward(x, conv1, conv2, shortcut, plan, tile, max_blocks)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        want = ctx.needs_input_grad[:1] + ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(w) for t, w in zip(saved, want)]
            y = resblock_chain(leaves[0], leaves[1:], *ctx.geometry)
            inputs = [t for t, w in zip(leaves, want) if w and t is not None]
            grads = iter(torch.autograd.grad(y, inputs, g, allow_unused=True))
        out = [next(grads) if w and t is not None else None for t, w in zip(leaves, want)]
        return (out[0], None, *out[1:])


def _resblock_forward(x, conv1, conv2, shortcut, plan, tile, max_blocks) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one (with
    the tile the gate found)."""
    K, d, left, _ = plan
    if x.device.type == "cpu":
        return fused_resblock_tgn_reference(x, conv1, conv2, shortcut)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock_tgn: unsupported device {x.device}")
    B, C, T = x.shape
    xc = x.contiguous()
    w = packed_weights(conv1, conv2, shortcut, x.dtype)
    geometry = (K, d, left, PAD_MODES[conv1.spec.pad_mode])
    part = torch.empty((B, -(-T // tile), 4), dtype=torch.float64, device=x.device)
    aff = torch.zeros((B, 6, C), dtype=torch.float32, device=x.device)
    y = torch.empty_like(xc)
    args = dict(x=xc, aff=aff, part=part, y=y, geometry=geometry, max_blocks=max_blocks,
                **{k: w[k] for k in ("w1", "b1", "w2", "b2", "ws", "bs")})

    launch_resblock_tgn(0, **args)
    launch_resblock_finalize(part, aff, T, [(w["g1"], w["be1"], 0), (w["gs"], w["bes"], 4)])
    launch_resblock_tgn(1, **args)
    launch_resblock_finalize(part, aff, T, [(w["g2"], w["be2"], 2)])
    launch_resblock_tgn(2, **args)
    return y


def _check(what: str, x: torch.Tensor, expect: dict) -> None:
    for name, (t, dtype, shape) in expect.items():
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is {t.dtype}{tuple(t.shape)}, needs contiguous, "
                             f"16-byte aligned {dtype}{shape}")


def launch_resblock_tgn(mode: int, *, x, w1, b1, w2, b2, ws, bs, aff, part, y, geometry,
                        max_blocks: int = 0) -> None:
    """Launch one pass (mode 0/1/2) of csrc/resblock_tgn.cu on the current
    stream of x's device. x, y (B, C, T) and w1 (H, K, C), w2 (C, H),
    ws (C, C) bf16; b1, b2, bs, aff (B, 6, C) fp32; part (B, n_t, 4) fp64.
    Raises where no kernel takes the block (``resblock_tgn_kind`` 0)."""
    global LAUNCHES
    K, dilation, left, pad_mode = geometry
    B, C, T = x.shape
    H = w1.shape[0]
    if max_blocks < 0:
        raise ValueError(f"resblock_tgn: max_blocks {max_blocks}")
    tile = kernel_tile(C, H, K, dilation, left)
    if tile <= 0:
        raise ValueError(f"resblock_tgn: no kernel takes C={C}, H={H}, K={K}, dilation={dilation}, left={left}")
    n_t = -(-T // tile)
    bf = torch.bfloat16
    _check("resblock_tgn", x, {
        "x": (x, bf, (B, C, T)),
        "w1": (w1, bf, (H, K, C)),
        "b1": (b1, torch.float32, (H,)),
        "w2": (w2, bf, (C, H)),
        "b2": (b2, torch.float32, (C,)),
        "ws": (ws, bf, (C, C)),
        "bs": (bs, torch.float32, (C,)),
        "aff": (aff, torch.float32, (B, 6, C)),
        "part": (part, torch.float64, (B, n_t, 4)),
        "y": (y, bf, (B, C, T)),
    })
    if B > 65535 or B * T >= 2**31:
        raise ValueError(f"resblock_tgn: B={B}, T={T} outside the kernel's range")
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.resblock_tgn_launch(
            mode, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ws.data_ptr(),
            bs.data_ptr(), aff.data_ptr(), part.data_ptr(), y.data_ptr(), B, C, H, T, K, dilation, left,
            pad_mode, max_blocks, stream)
    build.check(lib, rc, "resblock_tgn_launch")
    LAUNCHES += 1


def launch_resblock_finalize(part: torch.Tensor, aff: torch.Tensor, T: int, pairs) -> None:
    """Launch the finalize of csrc/resblock_tgn.cu: for pair p of `pairs`
    [(gamma, beta, slot)], columns 2p, 2p + 1 of part (B, n_t, 4) fp64 become
    aff[:, slot, :n_ch] (A) and aff[:, slot + 1, :n_ch] (D) of the tgn over
    T * n_ch elements a sample. One or two pairs."""
    global FINALIZE_LAUNCHES
    if not 1 <= len(pairs) <= 2:
        raise ValueError(f"resblock_tgn_finalize: {len(pairs)} pairs, the kernel takes 1 or 2")
    B, n_t, _ = part.shape
    C = aff.shape[2]
    expect = {"part": (part, torch.float64, (B, n_t, 4)), "aff": (aff, torch.float32, (B, 6, C))}
    for i, (gamma, beta, slot) in enumerate(pairs):
        n_ch = gamma.shape[0]
        if not (0 < n_ch <= C and slot in (0, 2, 4)):
            raise ValueError(f"resblock_tgn_finalize: pair {i} has {n_ch} channels of {C}, slot {slot}")
        expect[f"gamma{i}"] = (gamma, torch.float32, (n_ch,))
        expect[f"beta{i}"] = (beta, torch.float32, (n_ch,))
    _check("resblock_tgn_finalize", part, expect)
    flat = []
    for gamma, beta, slot in list(pairs) + [pairs[0]] * (2 - len(pairs)):
        flat += [gamma.data_ptr(), beta.data_ptr(), gamma.shape[0], slot]
    lib = build.load()
    with torch.cuda.device(part.device):
        stream = torch.cuda.current_stream(part.device).cuda_stream
        rc = lib.resblock_tgn_finalize_launch(part.data_ptr(), n_t, aff.data_ptr(), B, C, T, len(pairs), *flat,
                                              stream)
    build.check(lib, rc, "resblock_tgn_finalize_launch")
    FINALIZE_LAUNCHES += 1
