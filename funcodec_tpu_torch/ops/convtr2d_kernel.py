"""Grouped transposed 2D conv of FreqCodec's decoder: wrapper and plain version.

``convtr2d(x, weight, bias, stride, groups)`` is ``F.conv_transpose2d`` with
no padding for a kernel of twice the stride on both axes: x (B, Cin, F, T),
weight (Cin, Cout / groups, 2 sf, 2 st) -> y (B, Cout, (F + 1) sf, (T + 1) st),
untrimmed. On a card it is one launch of csrc/convtr2d.cu over every group
and the whole batch (bf16, fp32 sums, one rounding, the same bits from run to
run); on the CPU it is the plain version.

No TPU kernel is replaced: the JAX package leaves this conv to XLA.
ops/conv.apply_sconv_transpose2d routes a conv here by what its input shows:
a CUDA bf16 x whose result autograd does not need, with groups > 1. Training,
the CPU, fp32 and groups = 1 keep ``F.conv_transpose2d``.

``convtr2d_reference`` is the same polyphase arithmetic in plain torch: the
kernel is twice the stride, so output (qf sf + pf, qt st + pt) of cell
(qf, qt) sums the four input points (qf - df, qt - dt), df, dt in {0, 1},
through weight tap (pf + df sf, pt + dt st). It computes in float64 for
float64 inputs and in float32 otherwise (weight and bias in x's type first,
as the cuDNN route takes them), rounded once to x's type.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from funcodec_tpu_torch.kernels import build

# Launches since the last reset; a run sets it to 0 and reads it back to show
# that its path went through the kernel.
LAUNCHES = 0

MAX_GROUP_WIDTH = 64  # csrc/convtr2d.cu: input and output channels a group
MAX_PHASES = 8  # csrc/convtr2d.cu: stride_f * stride_t


def _geometry(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride: Tuple[int, int],
              groups: int) -> Tuple[int, int, int]:
    """(sf, st, Cout) after checking the shapes on every device."""
    sf, st = (int(s) for s in stride)
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"convtr2d: x {tuple(x.shape)}, weight {tuple(weight.shape)}; it takes 4D tensors")
    cin, cog, kf, kt = weight.shape
    if groups < 1 or x.shape[1] != cin or cin % groups:
        raise ValueError(f"convtr2d: x {tuple(x.shape)} and weight {tuple(weight.shape)} in {groups} groups")
    if sf < 1 or st < 1 or (kf, kt) != (2 * sf, 2 * st) or sf * st > MAX_PHASES:
        raise ValueError(f"convtr2d: kernel {(kf, kt)} at stride {(sf, st)}; it takes a kernel of twice the stride "
                         f"and stride_f * stride_t <= {MAX_PHASES}")
    if cin // groups > MAX_GROUP_WIDTH or cog > MAX_GROUP_WIDTH:
        raise ValueError(f"convtr2d: {cin // groups} -> {cog} channels a group; it takes at most {MAX_GROUP_WIDTH}")
    cout = cog * groups
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"convtr2d: bias {tuple(bias.shape)}, expected ({cout},)")
    return sf, st, cout


def convtr2d_reference(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride: Tuple[int, int],
                       groups: int) -> torch.Tensor:
    """The plain version: y (B, Cout, (F + 1) sf, (T + 1) st), in x's type."""
    sf, st, cout = _geometry(x, weight, bias, stride, groups)
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    B, cin, F, T = x.shape
    cig, cog = cin // groups, cout // groups
    # a zero point on each side: xp[..., 1 + fi, 1 + ti] = x[..., fi, ti]
    xp = torch.nn.functional.pad(x.detach().to(ct), (1, 1, 1, 1)).reshape(B, groups, cig, F + 2, T + 2)
    w = weight.detach().to(x.dtype).to(ct).reshape(groups, cig, cog, 2 * sf, 2 * st)
    y = torch.empty(B, groups, cog, F + 1, sf, T + 1, st, dtype=ct, device=x.device)
    for pf in range(sf):
        for pt in range(st):
            acc = torch.zeros(B, groups, cog, F + 1, T + 1, dtype=ct, device=x.device)
            for df in (0, 1):
                for dt in (0, 1):
                    xs = xp[..., 1 - df: 2 - df + F, 1 - dt: 2 - dt + T]
                    acc += torch.einsum("bgcft,gco->bgoft", xs, w[..., pf + df * sf, pt + dt * st])
            y[:, :, :, :, pf, :, pt] = acc
    y = y.reshape(B, cout, (F + 1) * sf, (T + 1) * st)
    if bias is not None:
        y = y + bias.detach().to(x.dtype).to(ct).reshape(1, cout, 1, 1)
    return y.to(x.dtype)


def convtr2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride: Tuple[int, int],
             groups: int) -> torch.Tensor:
    """y (B, Cout, (F + 1) sf, (T + 1) st), untrimmed and contiguous, in x's
    type: the kernel on a card, the plain version on the CPU."""
    global LAUNCHES
    sf, st, cout = _geometry(x, weight, bias, stride, groups)
    if x.device.type == "cpu":
        return convtr2d_reference(x, weight, bias, stride, groups)
    if x.device.type != "cuda":
        raise ValueError(f"convtr2d: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"convtr2d: x is {x.dtype}; the kernel takes bfloat16")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"convtr2d: {name} on {t.device}, x on {x.device}")
    B, cin, F, T = x.shape
    xc = x.contiguous()
    if xc.data_ptr() % 16:  # the kernel reads x in aligned 16-byte vectors
        xc = xc.clone()
    w = weight.detach().to(torch.bfloat16).contiguous()
    b = None if bias is None else bias.detach().to(torch.bfloat16).contiguous()
    y = torch.empty((B, cout, (F + 1) * sf, (T + 1) * st), dtype=x.dtype, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.convtr2d_launch(xc.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
                                 B, cin, F, T, groups, cout, sf, st, stream)
    build.check(lib, rc, "convtr2d_launch")
    LAUNCHES += 1
    return y
