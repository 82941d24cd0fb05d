"""Fused stride-1 conv1d: the CUDA kernel's wrapper and its plain version.

Counterpart of funcodec_tpu/ops/conv_pallas.py. ``fused_conv1d_s1`` computes
[act ->] pad -> stride-1 dilated "same" conv1d + bias on torch's (B, C, T)
layout, reading x once and writing y once (csrc/conv1d_s1.cu). Its plain
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
CUDA tensor it launches the kernel or raises. Forward only: a tensor that
requires grad, with grad enabled, raises (training is slice B).
"""

from __future__ import annotations

from typing import Optional

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


def apply_act(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """The fused activation in fp32, rounded back to x's type."""
    if act is None:
        return x
    xf = x.float()
    if act == "elu":
        y = torch.where(xf > 0, xf, torch.exp(torch.clamp(xf, max=0.0)) - 1.0)
    elif act == "relu":
        y = torch.clamp(xf, min=0.0)
    elif act == "gelu":
        y = F.gelu(xf, approximate="tanh")
    else:
        raise ValueError(f"unsupported fused act: {act}")
    return y.to(x.dtype)


def qualifies(T: int, K: int, left: int, right: int, dilation: int, pad_mode: str) -> bool:
    return (
        K >= 2
        and left + right == (K - 1) * dilation
        and pad_mode in PAD_MODES
        and T > max(left, right)
    )


def check_no_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward-only: its backward comes with training (ROADMAP.md slice B); "
            "run under torch.no_grad() or torch.inference_mode()"
        )


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
) -> Optional[torch.Tensor]:
    """Fused [act ->] pad -> conv (stride 1). x (B, Cin, T), weight
    (Cout, Cin, K) -> (B, Cout, T), or None when the layer does not qualify."""
    if x.dim() != 3 or weight.dim() != 3:
        return None
    if not qualifies(x.shape[-1], weight.shape[-1], left, right, dilation, pad_mode):
        return None
    if act not in ACTS:
        raise ValueError(f"unsupported fused act: {act}")
    check_no_grad("fused_conv1d_s1", x, weight, bias)
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
    w = weight.to(x.dtype).permute(0, 2, 1).contiguous()  # (Cout, K, Cin)
    b = torch.zeros(Cout, device=x.device) if bias is None else bias.float().contiguous()
    y = torch.empty((B, Cout, T), dtype=x.dtype, device=x.device)
    launch_conv1d_s1(xc, w, b, y, dilation, left, pad_mode, act)
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
) -> None:
    """Launch csrc/conv1d_s1.cu on the current stream of x's device.

    x (B, Cin, T), w (Cout, K, Cin) in x's type, bias (Cout,) fp32; writes
    y (B, Cout, T)."""
    global LAUNCHES
    B, Cin, T = x.shape
    Cout, K, _ = w.shape
    expect = {
        "x": (x, x.dtype, (B, Cin, T)),
        "w": (w, x.dtype, (Cout, K, Cin)),
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
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv1d_s1_launch(x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(), B, Cin, Cout,
                                  T, K, dilation, left, PAD_MODES[pad_mode], ACTS[act], DTYPES[x.dtype], stream)
    build.check(lib, rc, "conv1d_s1_launch")
    LAUNCHES += 1
