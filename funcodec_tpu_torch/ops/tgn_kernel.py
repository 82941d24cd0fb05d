"""time_group_norm of the SEANet convs outside the residual blocks: wrapper and plain version.

GroupNorm(1, C) over a sample's channels and every spatial axis, on (B, C, T)
or (B, C, F, T): y = (x - mean) * rsqrt(var + 1e-5) * gamma[c] + beta[c].
On a card it runs as two launches of csrc/tgn_norm.cu: ``tgn_stats`` takes
per-tile (mean, M2) partials of each sample's C * S row over thousands of
blocks, ``tgn_apply`` combines them and writes ``x * A[c] + D[c]`` in x's
type. With ``trim`` = (left, right) the statistics are over the whole of x
and only the kept window ``x[..., left : T - right]`` is written, contiguous:
a transposed conv's unpad done by the apply (1D only).

No TPU kernel is replaced: the JAX package's ``_apply_post_norm`` is plain
XLA. ops/conv.py routes a CUDA ``time_group_norm`` here when autograd does
not need its result; the training path keeps ATen's group norm.

``time_group_norm_reference`` repeats the kernels' arithmetic and rounding
points in plain torch: the statistics in fp64 (the kernel's per-thread fp32
corrected two passes, combined in fp64, agree with them to ~1e-7 of the
variance), A = rstd * gamma and D = beta - mean * rstd * gamma in fp64 and
rounded to fp32, gamma and beta read in their own type, then one fma in
fp32 rounded once to x's type. The wrapper takes it only for a tensor on the
CPU; for a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from funcodec_tpu_torch.kernels import build

# Norms computed by the kernels since the last reset (two launches each); a
# run sets it to 0 and reads it back to show that its path went through them.
LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
EPS = 1e-5
TILE = 16_384  # csrc/tgn_norm.cu: elements of a statistics tile (the launch checks part's size)
MAX_TABLE = 4096  # csrc/tgn_norm.cu: channels an apply tile may span


def _geometry(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, trim: Tuple[int, int]) -> Tuple[int, int]:
    """(left, right) after checking the shapes on every device."""
    left, right = (int(v) for v in trim)
    if x.dim() not in (3, 4):
        raise ValueError(f"time_group_norm: x is {tuple(x.shape)}; it takes (B, C, T) or (B, C, F, T)")
    if left < 0 or right < 0 or left + right >= x.shape[-1] or ((left or right) and x.dim() != 3):
        raise ValueError(f"time_group_norm: trim {trim} of {tuple(x.shape)}; a trim is 1D and keeps a sample")
    C = x.shape[1]
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p is None or tuple(p.shape) != (C,) or p.device != x.device:
            raise ValueError(f"time_group_norm: {name} must be ({C},) on {x.device}")
    return left, right


def time_group_norm_reference(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, trim: Tuple[int, int] = (0, 0)
) -> torch.Tensor:
    """The plain version: x (B, C, T) or (B, C, F, T) -> the normalised x,
    of (B, C, T - left - right) with ``trim``, contiguous, in x's type."""
    left, right = _geometry(x, gamma, beta, trim)
    B = x.shape[0]
    xd = x.detach().double().reshape(B, -1)
    mean = xd.mean(dim=1)
    var = (xd - mean[:, None]).square().mean(dim=1)
    rstd = 1.0 / torch.sqrt(var + EPS)
    a = rstd[:, None] * gamma.detach().double()[None]
    d = beta.detach().double()[None] - mean[:, None] * a
    shape = (B, -1) + (1,) * (x.dim() - 2)
    a, d = a.float().double().reshape(shape), d.float().double().reshape(shape)
    kept = x.detach()[..., left: x.shape[-1] - right]
    # the fp32 product is exact in fp64, so one rounding to fp32 is the kernel's fma
    return (kept.double() * a + d).float().to(x.dtype).contiguous()


def time_group_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, trim: Tuple[int, int] = (0, 0)
) -> torch.Tensor:
    """x (B, C, T) or (B, C, F, T) -> the normalised x, of
    (B, C, T - left - right) with ``trim`` = (left, right), contiguous, in
    x's type: the kernels on a card, the plain version on the CPU."""
    global LAUNCHES
    left, right = _geometry(x, gamma, beta, trim)
    if x.device.type == "cpu":
        return time_group_norm_reference(x, gamma, beta, trim)
    if x.device.type != "cuda":
        raise ValueError(f"time_group_norm: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"time_group_norm: x is {x.dtype}; the kernels take float32 or bfloat16")
    if gamma.dtype not in DTYPES or beta.dtype != gamma.dtype or not (gamma.is_contiguous() and beta.is_contiguous()):
        raise ValueError(f"time_group_norm: gamma {gamma.dtype}, beta {beta.dtype}; the kernels take contiguous "
                         "float32 or bfloat16 vectors of one type")
    B, C = x.shape[:2]
    S = math.prod(x.shape[2:])
    S_out = S - left - right
    if B > 65535 or C * S >= 2**31 or min(C, (TILE - 1) // S_out + 2) > MAX_TABLE:
        raise ValueError(f"time_group_norm: {tuple(x.shape)} outside the kernels' range")
    xc = x.contiguous()
    y = torch.empty((*x.shape[:-1], x.shape[-1] - left - right), dtype=x.dtype, device=x.device)
    part = torch.empty((B, -(-C * S // TILE), 2), dtype=torch.float64, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tgn_norm_launch(xc.data_ptr(), y.data_ptr(), part.data_ptr(), part.shape[1], gamma.data_ptr(),
                                 beta.data_ptr(), B, C, S, left, right, DTYPES[x.dtype], DTYPES[gamma.dtype], stream)
    build.check(lib, rc, "tgn_norm_launch")
    LAUNCHES += 1
    return y

