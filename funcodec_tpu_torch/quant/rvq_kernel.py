"""Fused greedy RVQ encode: the CUDA kernel's wrapper and its plain version.

Counterpart of funcodec_tpu/quant/rvq_pallas.py. The kernel
(csrc/rvq_encode.cu) runs all n_q codebook searches of a token tile with the
residual held on chip. ``rvq_encode_reference`` does the same arithmetic in
plain torch: the CPU tests run it, and the card checks the kernel against it.

``rvq_encode_fused`` takes the plain version only for tensors on the CPU;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from funcodec_tpu_torch.kernels import build

# Kernel launches since the last reset; a run sets it to 0 and reads it back
# to show that its main path went through the kernel.
LAUNCHES = 0

KERNEL_DIM = 128  # the latent width csrc/rvq_encode.cu is compiled for


def embed_sq(embed: torch.Tensor, n_q: int) -> torch.Tensor:
    """||E||^2 per codeword (n_q, bins), from the fp32 codebooks."""
    return (embed[:n_q].float() ** 2).sum(dim=-1)


def rvq_encode_reference(
    x: torch.Tensor, embed: torch.Tensor, n_q: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch fused RVQ encode with the kernel's numerics.

    x (B, T, D), embed (>=n_q, bins, D) -> (indices (n_q, B, T) int32,
    quantized (B, T, D) fp32): bf16 latents, an fp32 residual re-rounded to
    bf16 for each stage's distances, bf16 codewords, ||E||^2 from fp32.
    """
    B, T, D = x.shape
    r = x.reshape(B * T, D).to(torch.bfloat16).float()
    e_bf = embed[:n_q].to(torch.bfloat16).float()
    esq = embed_sq(embed, n_q)
    quant = torch.zeros_like(r)
    idxs = []
    for q in range(n_q):
        scores = (r.to(torch.bfloat16).float() @ e_bf[q].T) * 2.0 - esq[q]
        idx = scores.argmax(dim=-1)
        c = e_bf[q][idx]
        r = r - c
        quant = quant + c
        idxs.append(idx.to(torch.int32))
    return torch.stack(idxs).reshape(n_q, B, T), quant.reshape(B, T, D)


def rvq_encode_fused(
    x: torch.Tensor, embed: torch.Tensor, n_q: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused greedy RVQ encode. x (B, T, D), embed (>=n_q, bins, D) ->
    (indices (n_q, B, T) int32, quantized (B, T, D) fp32)."""
    if x.device.type == "cpu":
        return rvq_encode_reference(x, embed, n_q)
    if x.device.type != "cuda":
        raise ValueError(f"rvq_encode_fused: unsupported device {x.device}")
    if x.dim() != 3 or embed.dim() != 3 or embed.shape[-1] != x.shape[-1]:
        raise ValueError(f"rvq_encode_fused: shapes x {tuple(x.shape)}, embed {tuple(embed.shape)}")
    if not 1 <= n_q <= embed.shape[0]:
        raise ValueError(f"rvq_encode_fused: n_q={n_q} of {embed.shape[0]} codebooks")
    B, T, D = x.shape
    N = B * T
    xb = x.reshape(N, D).to(torch.bfloat16).contiguous()
    eb = embed[:n_q].to(torch.bfloat16).contiguous()
    esq = embed_sq(embed, n_q).contiguous()
    idx = torch.empty((n_q, N), dtype=torch.int32, device=x.device)
    quant = torch.empty((N, D), dtype=torch.float32, device=x.device)
    if N > 0:
        launch_rvq_encode(xb, eb, esq, idx, quant)
    return idx.reshape(n_q, B, T), quant.reshape(B, T, D)


def launch_rvq_encode(
    x: torch.Tensor,
    embed: torch.Tensor,
    esq: torch.Tensor,
    idx: torch.Tensor,
    quant: torch.Tensor,
) -> None:
    """Launch csrc/rvq_encode.cu on the current stream of x's device.

    x (N, 128) bf16, embed (n_q, bins, 128) bf16, esq (n_q, bins) fp32;
    writes idx (n_q, N) int32 and quant (N, 128) fp32.
    """
    global LAUNCHES
    N, D = x.shape
    n_q, bins, _ = embed.shape
    expect = {
        "x": (x, torch.bfloat16, (N, KERNEL_DIM)),
        "embed": (embed, torch.bfloat16, (n_q, bins, KERNEL_DIM)),
        "esq": (esq, torch.float32, (n_q, bins)),
        "idx": (idx, torch.int32, (n_q, N)),
        "quant": (quant, torch.float32, (N, KERNEL_DIM)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"rvq_encode: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"rvq_encode: {name} is {t.dtype}{tuple(t.shape)}, needs {dtype}{shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"rvq_encode: {name} must be contiguous and 16-byte aligned")
    if N >= 2**31 or n_q * N >= 2**31:
        raise ValueError(f"rvq_encode: N={N} overflows the kernel's int indexing")
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rvq_encode_launch(x.data_ptr(), embed.data_ptr(), esq.data_ptr(), idx.data_ptr(),
                                   quant.data_ptr(), N, n_q, bins, stream)
    build.check(lib, rc, "rvq_encode_launch")
    LAUNCHES += 1
