"""The copy probes' plain version against the TPU probes' Pallas kernels, on the CPU.

The probes' pallas_calls are closures inside scripts/pallas_stream_probe.py
(pallas_copy) and scripts/pallas_bw_probe.py (main), so they are rebuilt here
with the kernel bodies copied verbatim and run in interpret mode at small
shapes. o = 2 * x is exact, so ops/copy_kernel.scale_reference must give the
Pallas kernels' bits, in bf16 and fp32, overflow to +-inf included. XLA
flushes subnormals to zero, as the TPU does, where torch and the CUDA
kernels keep them; the comparison holds normal values and the subnormal
case is pinned on its own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from funcodec_tpu_torch.ops import copy_kernel
from funcodec_tpu_torch.tools import bw_probe, stream_probe
from funcodec_tpu_torch.tools.benchlib import timeit_amortized

# one torch thread per test process: the suite runs in several processes at once,
# and the small CPU ops here gain nothing from more
torch.set_num_threads(1)

B, TP, L = 2, 40, 128
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp32": (jnp.float32, torch.float32)}
SPECIALS = (3.0e38, -3.0e38, 1e-30, -1e-30, 0.0, -0.0, 1.0, 3.3e38)  # +-inf after doubling


def scale_kernel(x_ref, o_ref):  # scripts/pallas_stream_probe.py:74, scripts/pallas_bw_probe.py:45
    o_ref[...] = x_ref[...] * 2.0


def _blocked(shape, dtype, block, grid, **kw):
    """The probes' blocked pallas_call: BlockSpec `block` over grid `grid`."""
    return pl.pallas_call(
        scale_kernel,
        grid=grid,
        in_specs=[pl.BlockSpec(block, lambda b, t: (b, t, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(block, lambda b, t: (b, t, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(shape, dtype),
        interpret=True,
        **kw,
    )


def _dma(shape, dtype, chunk):
    """scripts/pallas_bw_probe.py:113 dma_kernel (variant D), body verbatim."""
    B, Tp, L = shape

    def dma_kernel(h_ref, o_ref):
        n_chunks = (B * Tp) // chunk

        def body(scratch, osc, sem, osem):
            def get_in(slot, ci):
                return pltpu.make_async_copy(
                    h_ref.at[pl.ds(ci * chunk, chunk)],
                    scratch.at[slot], sem.at[slot])

            get_in(0, 0).start()

            def loop_body(ci, _):
                cur = lax.rem(ci, 2)
                nxt = lax.rem(ci + 1, 2)

                @pl.when(ci + 1 < n_chunks)
                def _():
                    get_in(nxt, ci + 1).start()

                get_in(cur, ci).wait()
                osc[cur] = scratch[cur] * 2.0
                out_dma = pltpu.make_async_copy(
                    osc.at[cur], o_ref.at[pl.ds(ci * chunk, chunk)],
                    osem.at[cur])
                out_dma.start()

                @pl.when(ci >= 1)
                def _():
                    pass
                out_dma.wait()

            lax.fori_loop(0, n_chunks, loop_body, None)

        pl.run_scoped(
            body,
            scratch=pltpu.VMEM((2, chunk, L), dtype),
            osc=pltpu.VMEM((2, chunk, L), dtype),
            sem=pltpu.SemaphoreType.DMA((2,)),
            osem=pltpu.SemaphoreType.DMA((2,)),
        )

    call = pl.pallas_call(
        dma_kernel,
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct((B * Tp, L), dtype),
        interpret=True,
    )
    return lambda v: call(v.reshape(B * Tp, L)).reshape(B, Tp, L)


VARIANTS = {
    # scripts/pallas_stream_probe.py:78, the tile sweep (tiles scaled to TP)
    "stream tile=8": lambda s, d: _blocked(s, d, (1, 8, L), (B, TP // 8)),
    "stream tile=20": lambda s, d: _blocked(s, d, (1, 20, L), (B, TP // 20)),
    # scripts/pallas_bw_probe.py:67 A and :169 E (E is A in fp32)
    "A tile=10": lambda s, d: _blocked(s, d, (1, 10, L), (B, TP // 10)),
    # :81 B, A with dimension_semantics
    "B parallel,arbitrary": lambda s, d: _blocked(
        s, d, (1, 10, L), (B, TP // 10),
        compiler_params=pltpu.CompilerParams(dimension_semantics=("parallel", "arbitrary"))),
    # :97 C, multi-row blocks
    "C block=(2,5)": lambda s, d: _blocked(s, d, (2, 5, L), (1, TP // 5)),
    # :155 D, chunks of 16 rows of the flattened (B * TP, L) array
    "D dma chunk=16": lambda s, d: _dma(s, d, 16),
}


def _inputs(seed):
    x = np.random.RandomState(seed).randn(B, TP, L).astype(np.float32)
    x.reshape(-1)[: len(SPECIALS)] = SPECIALS
    return x


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_version_matches_pallas_probe(variant, dtype):
    jdt, tdt = DTYPES[dtype]
    x = _inputs(seed=len(variant))
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(x).to(tdt)
    np.testing.assert_array_equal(_bits(xt), _jax_bits(xj))  # the same input bits in both
    ref = VARIANTS[variant]((B, TP, L), jdt)(xj)
    out = copy_kernel.scale_reference(xt)
    assert out.dtype == tdt and tuple(out.shape) == (B, TP, L)
    np.testing.assert_array_equal(_bits(out), _jax_bits(ref))
    assert torch.isinf(out.reshape(-1)[:2]).all() and torch.isinf(out.reshape(-1)[7])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_subnormals_are_kept_where_xla_flushes_them(dtype):
    jdt, tdt = DTYPES[dtype]
    x = np.array([1e-40, -1e-40, 1.5e-39], np.float32).reshape(1, 3, 1)
    xt = torch.from_numpy(x).to(tdt)
    out = copy_kernel.scale_reference(xt)
    assert torch.equal(out.float(), 2 * xt.float()) and out.abs().min() > 0
    ref = np.asarray(jax.jit(lambda v: v * 2.0)(jnp.asarray(x, jdt))).astype(np.float32)
    assert (ref == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_wrappers_take_the_plain_version_on_the_cpu(dtype):
    x = torch.from_numpy(_inputs(seed=1)).to(dtype)
    ref = copy_kernel.scale_reference(x)
    before = dict(copy_kernel.LAUNCHES)
    outs = [copy_kernel.scale_copy(x, 8), copy_kernel.scale_copy(x, 7, 2), copy_kernel.dma_copy(x),
            copy_kernel.dma_copy(x, 16)]
    buf = torch.empty_like(x)
    outs += [copy_kernel.scale_copy(x, 8, out=buf), copy_kernel.dma_copy(x, out=torch.empty_like(x))]
    assert outs[4] is buf
    assert copy_kernel.LAUNCHES == before  # a CPU tensor never launches
    for out in outs:
        np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    flat = torch.zeros(B * TP * L + 8, dtype=torch.bfloat16)
    misaligned = flat[1 : 1 + B * TP * L].view(B, TP, L)  # contiguous, 2 bytes past a 16-byte boundary
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16
    for call in (lambda: copy_kernel.scale_copy(misaligned, 8), lambda: copy_kernel.dma_copy(misaligned)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            call()
    with pytest.raises(ValueError, match="16-byte aligned"):
        copy_kernel.scale_copy(torch.zeros(B, TP, L), 8, out=torch.zeros(B, L, TP).transpose(1, 2))
    with pytest.raises(ValueError, match="multiple of 16"):
        copy_kernel.dma_copy(torch.zeros(4, 6, dtype=torch.bfloat16))  # 12-byte rows
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        copy_kernel.scale_copy(torch.zeros(B, TP, L, dtype=torch.float16), 8)
    with pytest.raises(ValueError, match="not 3-d"):
        copy_kernel.scale_copy(torch.zeros(TP, L), 8)
    with pytest.raises(ValueError, match="tile"):
        copy_kernel.scale_copy(torch.zeros(B, TP, L), 0)
    with pytest.raises(ValueError, match="1 MB"):
        copy_kernel.dma_copy(torch.zeros(B, TP, L), chunk_rows=4096)
    with pytest.raises(ValueError, match="device"):
        copy_kernel.scale_copy(torch.zeros(B, TP, L, device="meta"), 8)


def test_timeit_amortized_chains_each_launch_on_the_last_output():
    seen = []

    def op(a, b):
        seen.append((a.data_ptr(), b.data_ptr()))
        return copy_kernel.scale_copy(a, 8, out=b)

    x = torch.ones(B, TP, L)
    assert timeit_amortized(op, x, 4) > 0
    assert len(seen) == 5  # one warm-up, then 4
    for (a0, b0), (a1, b1) in zip(seen, seen[1:]):
        assert (a1, b1) == (b0, a0)  # each reads the buffer the last one wrote
    assert torch.equal(x, torch.ones(B, TP, L))  # x itself is not written


def test_tools_run_the_plain_version_on_the_cpu(tmp_path):
    rows = bw_probe.main(["--device", "cpu", "--log", str(tmp_path / "bw.log")])
    kernels = {r["kernel"] for r in rows}
    assert kernels == {"scale_copy", "dma_copy", "torch.mul", "copy_"}
    assert all(r["ms"] > 0 and tuple(r["shape"]) == bw_probe.TINY for r in rows)
    log = (tmp_path / "bw.log").read_text()
    assert "ceiling" not in log and "of 3.35 TB/s" not in log  # a CPU run names no device rate
    stream_probe.main(["copy", "--device", "cpu", "--log", str(tmp_path / "stream.log")])
    assert (tmp_path / "stream.log").read_text().count("scale_copy tile=") == len(stream_probe.TILES)
