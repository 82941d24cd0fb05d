"""Fused greedy RVQ encode: the CUDA kernel's wrapper and its plain version.

Counterpart of funcodec_tpu/quant/rvq_pallas.py. The kernel
(csrc/rvq_encode.cu) runs all n_q codebook searches of a token tile with the
residual held on chip. ``rvq_encode_reference`` does the same arithmetic in
plain torch: the CPU tests run it, and the card checks the kernel against it.

``rvq_encode_fused`` takes the plain version only for tensors on the CPU;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import weakref
from typing import Dict, Tuple

import torch

from funcodec_tpu_torch.kernels import build

# Kernel launches since the last reset; a run sets it to 0 and reads it back
# to show that its main path went through the kernel.
LAUNCHES = 0

KERNEL_DIM = 128  # the latent width csrc/rvq_encode.cu is compiled for
CHUNK = 128  # codewords a ring stage of the kernel holds (csrc/rvq_encode.cu CHUNK)


def embed_sq(embed: torch.Tensor, n_q: int) -> torch.Tensor:
    """||E||^2 per codeword (n_q, bins), from the fp32 codebooks."""
    return (embed[:n_q].float() ** 2).sum(dim=-1)


def arranged_offset(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Where element (bin n < 128, column d < 128) of a 128-bin chunk lies in
    the chunk's shared-memory image, in elements: the K-major 128-byte-swizzle
    layout wgmma reads. Two blocks of 64 columns; in a block, row n is 128
    bytes and its 16-byte piece p = (d % 64) // 8 sits at piece p ^ (n % 8)."""
    block, piece, e = d // 64, (d % 64) // 8, d % 8
    return block * (CHUNK * 64) + n * 64 + (piece ^ (n % 8)) * 8 + e


def _chunk_gather() -> torch.Tensor:
    """(CHUNK * 128,) int64: image position -> row-major position n * 128 + d."""
    n = torch.arange(CHUNK)[:, None].expand(CHUNK, KERNEL_DIM)
    d = torch.arange(KERNEL_DIM)[None, :].expand(CHUNK, KERNEL_DIM)
    src = torch.empty(CHUNK * KERNEL_DIM, dtype=torch.int64)
    src[arranged_offset(n, d).reshape(-1)] = (n * KERNEL_DIM + d).reshape(-1)
    return src


def arrange_codebooks(embed_bf16: torch.Tensor) -> torch.Tensor:
    """(n_q, bins, 128) bf16 -> (n_q, n_ch, 128 * 128): every 128-bin chunk
    (bins padded with zero rows) as the image of ``arranged_offset``."""
    n_q, bins, dim = embed_bf16.shape
    n_ch = -(-bins // CHUNK)
    padded = torch.zeros((n_q, n_ch * CHUNK, dim), dtype=embed_bf16.dtype, device=embed_bf16.device)
    padded[:, :bins] = embed_bf16
    flat = padded.reshape(n_q, n_ch, CHUNK * dim)
    return flat[:, :, _chunk_gather().to(flat.device)].contiguous()


def read_arranged(arranged: torch.Tensor, bins: int) -> torch.Tensor:
    """The inverse of arrange_codebooks: (n_q, n_ch, 128 * 128) -> (n_q, bins, 128)."""
    n_q, n_ch, _ = arranged.shape
    n = torch.arange(CHUNK, device=arranged.device)[:, None]
    d = torch.arange(KERNEL_DIM, device=arranged.device)[None, :]
    rows = arranged[:, :, arranged_offset(n, d)]  # (n_q, n_ch, CHUNK, 128)
    return rows.reshape(n_q, n_ch * CHUNK, KERNEL_DIM)[:, :bins]


# id(embed) -> (weak reference, key, tensors): what the kernel reads of a
# codebook tensor, rebuilt when its storage or version changes
_PREPARED: Dict[int, tuple] = {}


def prepared_codebooks(embed: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The kernel's view of embed (n_q, bins, 128): ``embed`` in bf16,
    ``arranged`` (arrange_codebooks of it) and ``esq`` (n_q, n_ch * 128) fp32,
    ||E||^2 from the fp32 codebooks with +inf past bins (a missing bin scores
    -inf). Cached per tensor, keyed on data_ptr() and _version, so a call pays
    the cast, the arrangement and the norms once per codebook."""
    key = (embed.data_ptr(), 0 if embed.is_inference() else embed._version, embed.dtype, embed.device,
           tuple(embed.shape))
    hit = _PREPARED.get(id(embed))
    if hit is not None and hit[0]() is embed and hit[1] == key:
        return hit[2]
    for k in [k for k, v in _PREPARED.items() if v[0]() is None]:
        del _PREPARED[k]
    n_q, bins, _ = embed.shape
    with torch.no_grad():
        e = embed.detach()
        eb = e.to(torch.bfloat16).contiguous()
        n_ch = -(-bins // CHUNK)
        esq = torch.full((n_q, n_ch * CHUNK), float("inf"), dtype=torch.float32, device=embed.device)
        esq[:, :bins] = embed_sq(e, n_q)
        prepared = dict(embed=eb, arranged=arrange_codebooks(eb), esq=esq)
    _PREPARED[id(embed)] = (weakref.ref(embed), key, prepared)
    return prepared


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


def rvq_encode_fused(x: torch.Tensor, embed: torch.Tensor, n_q: int) -> Tuple[torch.Tensor, torch.Tensor]:
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
    if embed.shape[-1] != KERNEL_DIM:
        raise ValueError(f"rvq_encode_fused: D={embed.shape[-1]}; the kernel is compiled for D={KERNEL_DIM}")
    if embed.device != x.device:
        raise ValueError(f"rvq_encode_fused: embed on {embed.device}, x on {x.device}")
    B, T, D = x.shape
    N = B * T
    xb = x.reshape(N, D).to(torch.bfloat16).contiguous()
    cb = prepared_codebooks(embed)
    idx = torch.empty((n_q, N), dtype=torch.int32, device=x.device)
    quant = torch.empty((N, D), dtype=torch.float32, device=x.device)
    if N > 0:
        launch_rvq_encode(xb, cb["embed"][:n_q], cb["arranged"][:n_q], cb["esq"][:n_q], idx, quant)
    return idx.reshape(n_q, B, T), quant.reshape(B, T, D)


def launch_rvq_encode(
    x: torch.Tensor,
    embed: torch.Tensor,
    arranged: torch.Tensor,
    esq: torch.Tensor,
    idx: torch.Tensor,
    quant: torch.Tensor,
) -> None:
    """Launch csrc/rvq_encode.cu on the current stream of x's device.

    x (N, 128) bf16, embed (n_q, bins, 128) bf16, arranged (n_q, n_ch,
    128 * 128) bf16 and esq (n_q, n_ch * 128) fp32 as prepared_codebooks
    makes them; writes idx (n_q, N) int32 and quant (N, 128) fp32.
    """
    global LAUNCHES
    N, D = x.shape
    n_q, bins, _ = embed.shape
    n_ch = -(-bins // CHUNK)
    expect = {
        "x": (x, torch.bfloat16, (N, KERNEL_DIM)),
        "embed": (embed, torch.bfloat16, (n_q, bins, KERNEL_DIM)),
        "arranged": (arranged, torch.bfloat16, (n_q, n_ch, CHUNK * KERNEL_DIM)),
        "esq": (esq, torch.float32, (n_q, n_ch * CHUNK)),
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
        rc = lib.rvq_encode_launch(x.data_ptr(), embed.data_ptr(), arranged.data_ptr(), esq.data_ptr(),
                                   idx.data_ptr(), quant.data_ptr(), N, n_q, bins, n_ch, stream)
    build.check(lib, rc, "rvq_encode_launch")
    LAUNCHES += 1
