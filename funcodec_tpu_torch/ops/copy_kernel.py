"""HBM copy probes: the CUDA kernels' wrappers and their plain version.

Counterparts of the TPU bandwidth probes' Pallas kernels
(scripts/pallas_stream_probe.py:74 and scripts/pallas_bw_probe.py:45
``scale_kernel``, scripts/pallas_bw_probe.py:113 ``dma_kernel``). Both kernels
(csrc/copy_probe.cu) compute o = 2 * x in x's type, exactly:

- ``scale_copy(x, tile, rows)``: the blocked copy, one block per
  (rows, tile, L) slab of x (B, T, L), the ragged last tile masked;
- ``dma_copy(x, chunk_rows)``: x viewed as (R, L) rows, streamed through
  shared memory by TMA bulk copies in chunks of ``chunk_rows`` rows.

``scale_reference`` is the plain version, ``x * 2``; the CPU tests run it and
the card holds both kernels to it bit for bit. The wrappers check the
kernels' input contract (float32 or bfloat16, contiguous, 16-byte aligned,
rows of a multiple of 16 bytes) on every device, then take the plain version
only for a tensor on the CPU; for a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from funcodec_tpu_torch.kernels import build

# Kernel launches since the last reset, per kernel; a run sets them to 0 and
# reads them back to show that its path went through the kernels.
LAUNCHES = {"scale_copy": 0, "dma_copy": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DMA_CHUNK_BYTES = 32 * 1024  # the default chunk: 4 slots of it fit one block's shared memory


def scale_reference(x: torch.Tensor) -> torch.Tensor:
    """o = 2 * x in x's type."""
    return x * 2


def _checked(name: str, x: torch.Tensor, out: Optional[torch.Tensor], dims: Optional[int] = None) -> int:
    """Raise on what the kernels do not take; returns the row size in bytes."""
    if x.dtype not in DTYPES:
        raise ValueError(f"{name}: x is {x.dtype}; the kernel takes float32 or bfloat16")
    if (dims is not None and x.dim() != dims) or x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"{name}: x {tuple(x.shape)} is empty or not {dims}-d")
    row_bytes = x.shape[-1] * x.element_size()
    if row_bytes % 16:
        raise ValueError(f"{name}: the last dim of x is {row_bytes} bytes; the kernel moves 16-byte vectors "
                         "and needs a multiple of 16")
    for what, t in (("x", x), ("out", out)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: {what} must be contiguous and 16-byte aligned")
    if out is not None and (out.device != x.device or out.dtype != x.dtype or out.shape != x.shape):
        raise ValueError(f"{name}: out is {out.dtype}{tuple(out.shape)} on {out.device}, "
                         f"x {x.dtype}{tuple(x.shape)} on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return row_bytes


def _plain(x: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    y = scale_reference(x)
    return y if out is None else out.copy_(y)


def scale_copy(x: torch.Tensor, tile: int, rows: int = 1, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """o = 2 * x over x (B, T, L), one block per (rows, tile, L) slab."""
    row_bytes = _checked("scale_copy", x, out, dims=3)
    B, T, _ = x.shape
    if tile < 1 or rows < 1 or -(-B // rows) > 65535:
        raise ValueError(f"scale_copy: tile={tile}, rows={rows} for B={B} (at most 65535 row groups)")
    if x.device.type == "cpu":
        return _plain(x, out)
    out = torch.empty_like(x) if out is None else out
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.scale_copy_launch(x.data_ptr(), out.data_ptr(), B, T, row_bytes, tile, rows, DTYPES[x.dtype], stream)
    build.check(lib, rc, "scale_copy_launch")
    LAUNCHES["scale_copy"] += 1
    return out


def dma_copy(x: torch.Tensor, chunk_rows: Optional[int] = None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """o = 2 * x over x viewed as (R, L) rows, chunk_rows rows per bulk copy
    (default: 32 KB chunks), one block per SM."""
    row_bytes = _checked("dma_copy", x, out)
    chunk_rows = max(1, DMA_CHUNK_BYTES // row_bytes) if chunk_rows is None else chunk_rows
    if chunk_rows < 1 or chunk_rows * row_bytes >= 1 << 20:
        raise ValueError(f"dma_copy: chunk_rows={chunk_rows} of {row_bytes} B (a chunk must stay under 1 MB)")
    if x.device.type == "cpu":
        return _plain(x, out)
    out = torch.empty_like(x) if out is None else out
    lib = build.load()
    smem = lib.dma_copy_smem_bytes(chunk_rows, row_bytes)
    limit = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"dma_copy: chunks of {chunk_rows} rows x {row_bytes} B need {smem} B of shared memory "
                         f"(2 input and 2 output slots); a block has {limit} B")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dma_copy_launch(x.data_ptr(), out.data_ptr(), x.numel() // x.shape[-1], row_bytes, chunk_rows,
                                 DTYPES[x.dtype], stream)
    build.check(lib, rc, "dma_copy_launch")
    LAUNCHES["dma_copy"] += 1
    return out
