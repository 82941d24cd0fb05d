"""Fused stride-1 conv1d: the CUDA kernels' wrapper and their plain version.

Counterpart of funcodec_tpu/ops/conv_pallas.py. ``fused_conv1d_s1`` computes
[act ->] pad -> stride-1 dilated "same" conv1d + bias on torch's (B, C, T)
layout, reading x once and writing y once (csrc/conv1d_s1.cu). The launch
picks one of three kernels from the shapes; ``plan`` mirrors that choice:
a bytes-bound stream for one input or one output channel ("thin"), a
persistent tensor-core kernel over (sample, time tile, output-channel tile)
work items (``work_items`` mirrors their order) with the weights resident
or streamed, and the first kernel ("legacy", csrc/conv1d_s1_legacy.cu) for
fp32 and what the others do not take. ``variant="legacy"`` forces the first
kernel (timing and tests). The weights reach the kernel as
``packed_conv_weights`` lays them out, cached on the weight tensor. Its plain
version ``fused_conv1d_s1_reference`` does the same arithmetic in plain
torch: the activation in fp32 rounded to x's type (ELU as exp(min(x, 0)) - 1),
the pad, an fp32 sum of the tap products with the fp32 bias, one rounding to
x's type. The CPU tests run it; the card checks the kernel against it.

Gates (``None``, decided from shapes and specs before any launch, so the
caller keeps the unfused path) are the JAX function's semantic ones: K < 2,
``left + right != (K-1)*dilation``, a pad mode outside {reflect, replicate,
constant, zero}, and the pad1d small-input regime (T <= max pad). The gates
the TPU's (8, 128) tiling needed (``MIN_C``, ``T % f``, ``pick_tile``, the
channel-packed ``_plan``/``_pack_weights`` lowering and its 8-row alignment)
are dropped: the CUDA kernel masks its own ragged time and channel tiles.

The wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises. Where an input requires grad,
the call is a ``torch.autograd.Function`` (funcodec_tpu's ``custom_vjp``
around the Pallas call): its forward is the kernel (the plain version on
the CPU), and ``conv1d_s1_backward`` is its backward, fp32 transposes of the
linear pad + conv through cuDNN's conv gradients and the activation's
derivative, as JAX has XLA compute them. The backward launches no kernel of
this module and never replays the forward.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from funcodec_tpu_torch.kernels import build
from funcodec_tpu_torch.ops.pad import pad1d_time

# Kernel launches since the last reset; a run sets it to 0 and reads it back
# to show that its main path went through the kernel.
LAUNCHES = 0

PAD_MODES = {"reflect": 0, "replicate": 1, "constant": 2, "zero": 2}
ACTS = {None: 0, "elu": 1, "relu": 2, "gelu": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the device code a call may ask for (csrc/conv1d_s1.cu conv1d_s1_launch)
VARIANTS = {"auto": 0, "legacy": 1}
# the kernels of csrc/conv1d_s1.cu, numbered as conv1d_s1_regime returns them
REGIMES = ("legacy", "thin", "tc_resident", "tc_streamed")

# csrc/conv1d_s1.cuh: time steps a tensor-core work item, a block's shared memory,
# an SM's (1 KB of it reserved for each resident block), blocks an SM at most
TILE = 256
MAX_SMEM = 232_448
SM_SMEM = 233_472
MAX_BLOCKS = 2


class Plan(NamedTuple):
    regime: str
    out_tile: int  # output channels a tensor-core work item (NO), else 0
    chunk: int  # input channels a chunk of the tensor-core kernels (CC), else 0


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _align128(v: int) -> int:
    return _round_up(v, 128)


def tc_layout(no: int, cc: int, cin: int, cout: int, K: int, dil: int, left: int, resident: bool) -> int:
    """Shared memory (bytes) of a tensor-core block (csrc/conv1d_s1.cuh
    tc_layout): weight chunks (all of them, or two stages), two window
    buffers around the time-major chunk, the output tile where it does not
    fit over a window buffer and the chunk, the bias, a dummy row."""
    span = (K - 1) * dil
    halo_l = _round_up(left, 8)
    win = TILE + halo_l + _round_up(span - left, 8)
    if (win // 8) % 2 == 0:
        win += 8
    wst = _align128(no * (K * cc + 8) * 2)
    raw = _align128(cc * win * 2 + 64)
    xe = _align128((TILE + span) * (cc + 8) * 2)
    out = _align128(no * (TILE + 8) * 2)
    return ((cin // cc if resident else 2) * wst + 2 * raw + xe + (0 if out <= raw + xe else out)
            + _align128(cout * 4) + 128)


def tc_blocks_per_sm(smem: int) -> int:
    """Blocks of a tensor-core kernel with `smem` bytes of shared memory that
    fit on an SM, 0 where one does not fit (csrc/conv1d_s1.cuh tc_blocks_per_sm)."""
    return 0 if smem > MAX_SMEM else min(SM_SMEM // (smem + 1024), MAX_BLOCKS)


def thin_applies(cin: int, cout: int, K: int, dil: int, left: int) -> bool:
    return ((cin == 1 or cout == 1) and dil == 1 and max(cin, cout) <= 2048 and K in (3, 5, 7)
            and left in ((K - 1) - (K - 1) // 2, K - 1))


def plan(cin: int, cout: int, K: int, dil: int, left: int, dtype: torch.dtype, variant: str = "auto") -> Plan:
    """The kernel conv1d_s1_launch runs for a layer (csrc/conv1d_s1.cu plan_of)."""
    if VARIANTS[variant] == 1 or dtype != torch.bfloat16:
        return Plan("legacy", 0, 0)
    if thin_applies(cin, cout, K, dil, left):
        return Plan("thin", 0, 0)
    if cin % 16 or cout % 16:
        return Plan("legacy", 0, 0)
    no = next(n for n in (64, 32, 16) if cout % n == 0)
    # the weights resident before streamed, chunks of 32 before 16: the first
    # that keeps the most blocks on an SM
    best, best_blocks = Plan("legacy", 0, 0), 0
    for resident in (True, False):
        for cc in (32, 16):
            if cin % cc or (resident and no != cout):
                continue
            blocks = tc_blocks_per_sm(tc_layout(no, cc, cin, cout, K, dil, left, resident))
            if blocks > best_blocks:
                best, best_blocks = Plan("tc_resident" if resident else "tc_streamed", no, cc), blocks
    return best


def work_items(block: int, n_blocks: int, B: int, n_t: int, n_o: int) -> List[Tuple[int, int, int]]:
    """The (sample, time tile, output-channel tile) work items block `block`
    of a persistent grid of n_blocks takes, in its order: items block,
    block + n_blocks, ... of the B * n_t * n_o items numbered
    (sample * n_t + tile) * n_o + o_tile (csrc/conv1d_s1.cu conv1d_s1_tc)."""
    out = []
    for item in range(block, B * n_t * n_o, n_blocks):
        bt, o = divmod(item, n_o)
        out.append((*divmod(bt, n_t), o))
    return out


def _param_key(p: Optional[torch.Tensor]):
    if p is None:
        return None
    # an inference tensor has no version counter and cannot be updated in place
    return (p.data_ptr(), 0 if p.is_inference() else p._version, p.dtype, p.device, tuple(p.shape))


def pack_weight(weight: torch.Tensor, dtype: torch.dtype, chunk: int) -> torch.Tensor:
    """weight (Cout, Cin, K) as a kernel reads it, in `dtype`: (Cout, K, Cin)
    for the thin and legacy kernels (chunk 0); (Cin / chunk, Cout, K, chunk)
    for the tensor-core kernels, so a chunk's slice of an output-channel tile
    is contiguous rows."""
    w = weight.detach().to(dtype)
    if chunk == 0:
        return w.permute(0, 2, 1).contiguous()
    cout, cin, K = w.shape
    return w.reshape(cout, cin // chunk, chunk, K).permute(1, 0, 3, 2).contiguous()


def packed_conv_weights(weight: torch.Tensor, bias: Optional[torch.Tensor], dtype: torch.dtype,
                        chunk: int) -> Dict[str, torch.Tensor]:
    """{"w": pack_weight(weight, dtype, chunk), "bias": fp32 (Cout,), zeros
    when bias is None}. Cached on the weight tensor and rebuilt when the
    weight's or the bias's storage or version changes (load_state_dict, an
    in-place update), for another bias tensor, dtype or chunk."""
    key = (dtype, chunk, _param_key(weight), None if bias is None else id(bias), _param_key(bias))
    cached = getattr(weight, "_conv1d_s1_pack", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        pack = dict(
            w=pack_weight(weight, dtype, chunk),
            bias=(torch.zeros(weight.shape[0], device=weight.device) if bias is None
                  else bias.detach().float().contiguous()),
            bias_ref=bias,  # keeps id(bias) in the key from naming another tensor
        )
    weight._conv1d_s1_pack = (key, pack)
    return pack


def act_fp32(xf: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The fused activation of an fp32 tensor (ELU as exp(min(x, 0)) - 1)."""
    if act is None:
        return xf
    if act == "elu":
        return torch.where(xf > 0, xf, torch.exp(torch.clamp(xf, max=0.0)) - 1.0)
    if act == "relu":
        return torch.clamp(xf, min=0.0)
    if act == "gelu":
        return F.gelu(xf, approximate="tanh")
    raise ValueError(f"unsupported fused act: {act}")


def apply_act(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The fused activation in fp32, rounded back to x's type."""
    if act is None:
        return x
    return act_fp32(x.float(), act).to(x.dtype)


def qualifies(T: int, K: int, left: int, right: int, dilation: int, pad_mode: str) -> bool:
    return (
        K >= 2
        and left + right == (K - 1) * dilation
        and pad_mode in PAD_MODES
        and T > max(left, right)
    )


def pad_transpose(d_up: torch.Tensor, left: int, right: int, pad_mode: str) -> torch.Tensor:
    """The transpose of pad1d_time(., (left, right), pad_mode) for T > max(left,
    right): the cotangent of the padded (B, C, left + T + right) tensor
    folded onto (B, C, T), the pad rows added onto the rows they copy."""
    T = d_up.shape[-1] - left - right
    du = d_up[..., left: left + T].clone()
    if pad_mode == "reflect":
        if left:
            du[..., 1: left + 1] += d_up[..., :left].flip(-1)
        if right:
            du[..., T - 1 - right: T - 1] += d_up[..., left + T:].flip(-1)
    elif pad_mode == "replicate":
        if left:
            du[..., :1] += d_up[..., :left].sum(dim=-1, keepdim=True)
        if right:
            du[..., -1:] += d_up[..., left + T:].sum(dim=-1, keepdim=True)
    return du


def conv1d_s1_backward(
    g: torch.Tensor,
    x: torch.Tensor,
    weight: torch.Tensor,
    left: int,
    right: int,
    dilation: int,
    pad_mode: str,
    act: Optional[str],
    need: Tuple[bool, bool, bool] = (True, True, True),
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dx, dw, db) of y = conv(pad(act(x)), weight) + bias for the cotangent
    g (B, Cout, T), in fp32: with u = act(x), dx = act'(x) * pad^T(conv^T(g, w)),
    dw = the weight gradient of the conv at pad(u), db = sum of g over batch
    and time (funcodec_tpu ops/conv_pallas.py f_bwd). Each is None where
    `need` says so."""
    g32, x32, w32 = g.float(), x.float(), weight.float()
    dx = dw = db = None
    if need[0]:
        d_up = torch.nn.grad.conv1d_input((x.shape[0], x.shape[1], x.shape[2] + left + right), w32, g32,
                                          dilation=dilation)
        dx = pad_transpose(d_up, left, right, pad_mode)
        if act is not None:
            with torch.enable_grad():
                xr = x32.detach().requires_grad_()
                (dx,) = torch.autograd.grad(act_fp32(xr, act), xr, dx)
    if need[1]:
        up = pad1d_time(act_fp32(x32, act), (left, right), mode=pad_mode)
        dw = torch.nn.grad.conv1d_weight(up, w32.shape, g32, dilation=dilation)
    if need[2]:
        db = g32.sum(dim=(0, 2))
    return dx, dw, db


class _FusedConv1dS1(torch.autograd.Function):
    """The kernel's forward with conv1d_s1_backward as its backward; each
    gradient in its input's type."""

    @staticmethod
    def forward(ctx, x, weight, bias, left, right, dilation, pad_mode, act, variant):
        ctx.save_for_backward(x, weight)
        ctx.geometry = (left, right, dilation, pad_mode, act)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _conv1d_s1_forward(x, weight, bias, left, right, dilation, pad_mode, act, variant)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        grads = conv1d_s1_backward(g, x, weight, *ctx.geometry, need=tuple(ctx.needs_input_grad[:3]))
        dtypes = (x.dtype, weight.dtype, ctx.bias_dtype)
        return (*(None if d is None else d.to(t) for d, t in zip(grads, dtypes)), None, None, None, None, None, None)


def fused_conv1d_s1_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    left: int,
    right: int,
    dilation: int = 1,
    pad_mode: str = "reflect",
    act: Optional[str] = None,
) -> torch.Tensor:
    """Plain torch with the kernel's numerics. x (B, Cin, T), weight
    (Cout, Cin, K), bias (Cout,) or None -> (B, Cout, T) in x's type."""
    up = pad1d_time(apply_act(x, act), (left, right), mode=pad_mode)
    y = F.conv1d(
        up.float(),
        weight.to(x.dtype).float(),
        None if bias is None else bias.float(),
        dilation=dilation,
    )
    return y.to(x.dtype)


def fused_conv1d_s1(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    left: int,
    right: int,
    dilation: int = 1,
    pad_mode: str = "reflect",
    act: Optional[str] = None,
    *,
    variant: str = "auto",
) -> Optional[torch.Tensor]:
    """Fused [act ->] pad -> conv (stride 1). x (B, Cin, T), weight
    (Cout, Cin, K) -> (B, Cout, T), or None when the layer does not qualify.
    ``variant`` picks the device code ("auto": the kernel ``plan`` names;
    "legacy": the first kernel); it exists for timing and tests and changes
    no result beyond the summation order. Differentiable in x, weight and
    bias (see conv1d_s1_backward)."""
    if x.dim() != 3 or weight.dim() != 3:
        return None
    if not qualifies(x.shape[-1], weight.shape[-1], left, right, dilation, pad_mode):
        return None
    if act not in ACTS:
        raise ValueError(f"unsupported fused act: {act}")
    if variant not in VARIANTS:
        raise ValueError(f"fused_conv1d_s1: variant {variant!r} is not one of {sorted(VARIANTS)}")
    return _FusedConv1dS1.apply(x, weight, bias, left, right, dilation, pad_mode, act, variant)


def _conv1d_s1_forward(x, weight, bias, left, right, dilation, pad_mode, act, variant) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if x.device.type == "cpu":
        return fused_conv1d_s1_reference(x, weight, bias, left, right, dilation, pad_mode, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv1d_s1: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"fused_conv1d_s1: x is {x.dtype}; the kernel takes float32 or bfloat16")
    B, Cin, T = x.shape
    Cout, w_cin, K = weight.shape
    if w_cin != Cin:
        raise ValueError(f"fused_conv1d_s1: weight {tuple(weight.shape)} for x {tuple(x.shape)}")
    xc = x.contiguous()
    chunk = build.load().conv1d_s1_chunk(Cin, Cout, K, dilation, left, DTYPES[x.dtype], VARIANTS[variant])
    pack = packed_conv_weights(weight, bias, x.dtype, chunk)
    y = torch.empty((B, Cout, T), dtype=x.dtype, device=x.device)
    launch_conv1d_s1(xc, pack["w"], pack["bias"], y, dilation, left, pad_mode, act, variant)
    return y


def launch_conv1d_s1(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    y: torch.Tensor,
    dilation: int,
    left: int,
    pad_mode: str,
    act: Optional[str],
    variant: str = "auto",
) -> None:
    """Launch csrc/conv1d_s1.cu on the current stream of x's device.

    x (B, Cin, T), bias (Cout,) fp32, w in x's type as pack_weight lays it
    out for the kernel the launch runs: (Cout, K, Cin), or (Cin / CC, Cout,
    K, CC) for a tensor-core kernel; writes y (B, Cout, T)."""
    global LAUNCHES
    B, Cin, T = x.shape
    if variant not in VARIANTS:
        raise ValueError(f"conv1d_s1: variant {variant!r} is not one of {sorted(VARIANTS)}")
    Cout, K = (w.shape[1], w.shape[2]) if w.dim() == 4 else (w.shape[0], w.shape[1])
    lib = build.load()
    dt, v = DTYPES.get(x.dtype, -1), VARIANTS[variant]
    chunk = lib.conv1d_s1_chunk(Cin, Cout, K, dilation, left, dt, v) if dt >= 0 else 0
    w_shape = (Cin // chunk, Cout, K, chunk) if chunk > 0 else (Cout, K, Cin)
    expect = {
        "x": (x, x.dtype, (B, Cin, T)),
        "w": (w, x.dtype, w_shape),
        "bias": (bias, torch.float32, (Cout,)),
        "y": (y, x.dtype, (B, Cout, T)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"conv1d_s1: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"conv1d_s1: {name} is {t.dtype}{tuple(t.shape)}, needs contiguous, "
                             f"16-byte aligned {dtype}{shape}")
    if B > 65535 or T >= 2**31:
        raise ValueError(f"conv1d_s1: x {tuple(x.shape)} exceeds the kernel's grid")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv1d_s1_launch(x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(), B, Cin, Cout,
                                  T, K, dilation, left, PAD_MODES[pad_mode], ACTS[act], dt, v, stream)
    build.check(lib, rc, "conv1d_s1_launch")
    LAUNCHES += 1
