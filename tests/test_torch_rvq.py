"""funcodec_tpu_torch.quant against funcodec_tpu.quant on the CPU.

* rvq_encode_reference (the CUDA kernel's plain version) against the Pallas
  kernel in interpret mode, with the cases of tests/test_rvq_pallas.py:
  >= 99.9% of tokens agree (the only difference is summation order) and the
  summed codewords agree to 1e-5 on rows whose tokens all agree.
* the fp32 scan against the JAX scan: tokens exactly equal.
* the FUSED_RVQ wiring, as test_pallas_rvq_flag_wiring.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import funcodec_tpu_torch.quant.rvq as trvq
from funcodec_tpu.quant import rvq as jrvq
from funcodec_tpu.quant.rvq_pallas import rvq_encode_pallas
from funcodec_tpu_torch.quant import rvq_kernel

# one torch thread per test process: the suite runs in several processes at once,
# and the small CPU ops here gain nothing from more
torch.set_num_threads(1)


def _codebooks(n_q, bins, dim, seed):
    """kaiming-uniform codebooks as init_rvq_state draws them, from numpy."""
    bound = np.sqrt(2.0 / 6.0) * np.sqrt(3.0 / dim)
    return np.random.RandomState(seed).uniform(-bound, bound, (n_q, bins, dim)).astype(np.float32)


def _states(embed):
    n_q, bins, dim = embed.shape
    jstate = jrvq.RVQState(
        inited=jnp.ones((n_q,)), cluster_size=jnp.zeros((n_q, bins)),
        embed=jnp.asarray(embed), embed_avg=jnp.asarray(embed),
    )
    cfg = dict(dim=dim, codebook_size=bins, num_quantizers=n_q, kmeans_init=True)
    tstate = trvq.RVQState(trvq.RVQConfig(**cfg), device="cpu")
    tstate.embed.copy_(torch.from_numpy(embed))
    tstate.embed_avg.copy_(torch.from_numpy(embed))
    tstate.inited.fill_(1.0)
    return jrvq.RVQConfig(**cfg), jstate, trvq.RVQConfig(**cfg), tstate


@pytest.mark.parametrize(
    "shape,bins,n_total,n_q,scale",
    [
        ((2, 300, 128), 256, 4, 4, 0.5),  # test_pallas_rvq_encode_interpret
        ((1, 137, 128), 256, 8, 3, 1.0),  # partial n_q + ragged N
        ((3, 50, 128), 64, 2, 2, 0.3),
    ],
    ids=["d128_bins256_nq4", "partial_nq3_ragged137", "bins64"],
)
def test_reference_matches_pallas_interpret(shape, bins, n_total, n_q, scale):
    embed = _codebooks(n_total, bins, shape[-1], seed=bins + n_q)
    x = (scale * np.random.RandomState(n_q).randn(*shape)).astype(np.float32)
    j_idx, j_quant = rvq_encode_pallas(jnp.asarray(x), jnp.asarray(embed), n_q=n_q, tile=128, interpret=True)
    t_idx, t_quant = rvq_kernel.rvq_encode_reference(torch.from_numpy(x), torch.from_numpy(embed), n_q)
    assert t_idx.shape == (n_q,) + shape[:2] and t_idx.dtype == torch.int32
    assert t_quant.shape == shape and t_quant.dtype == torch.float32
    j_idx, t_idx = np.asarray(j_idx), t_idx.numpy()
    assert (j_idx == t_idx).mean() >= 0.999
    rows = (j_idx == t_idx).all(axis=0)
    assert rows.mean() >= 0.99
    np.testing.assert_allclose(t_quant.numpy()[rows], np.asarray(j_quant)[rows], atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_q", [1, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp32_scan_matches_jax_exactly(n_q, dtype):
    embed = _codebooks(4, 64, 32, seed=n_q)
    jcfg, jstate, tcfg, tstate = _states(embed)
    x = (0.5 * np.random.RandomState(7).randn(2, 40, 32)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, ji, js = jrvq.rvq_inference(jcfg, jstate, jx, n_q=n_q)
    tq, ti, ts = trvq.rvq_inference(tcfg, tstate, tx, n_q=n_q)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tq.dtype == tx.dtype and ts.dtype == tx.dtype and ti.dtype == torch.int32
    np.testing.assert_allclose(tq.float().numpy(), np.asarray(jq.astype(jnp.float32)), atol=1e-5)
    np.testing.assert_allclose(ts.float().numpy(), np.asarray(js.astype(jnp.float32)), atol=1e-5)
    enc = trvq.rvq_encode(tcfg, tstate, tx, n_q=n_q)
    np.testing.assert_array_equal(enc.numpy(), np.asarray(jrvq.rvq_encode(jcfg, jstate, jx, n_q=n_q)))
    np.testing.assert_allclose(
        trvq.rvq_decode(tcfg, tstate, enc).numpy(),
        np.asarray(jrvq.rvq_decode(jcfg, jstate, jnp.asarray(enc.numpy()))), atol=1e-6,
    )


def test_nearest_codebook_first_max_ties():
    """Duplicate codewords tie exactly: the lower index wins, as in JAX."""
    e = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    e[5] = e[2]
    x = np.concatenate([e[2:3], e[5:6], np.random.RandomState(1).randn(6, 16).astype(np.float32)])
    t = trvq.nearest_codebook_indices(torch.from_numpy(x), torch.from_numpy(e)).numpy()
    j = np.asarray(jrvq.nearest_codebook_indices(jnp.asarray(x), jnp.asarray(e)))
    np.testing.assert_array_equal(t, j)
    assert t[0] == 2 and t[1] == 2


@pytest.mark.parametrize("bandwidth", [None, 0.0, 499.0, 500.0, 8000.0, 16000.0, 1e9])
def test_bandwidth_to_n_q(bandwidth):
    kw = dict(codebook_size=1024, num_quantizers=32, encoder_hop_length=320)
    assert trvq.RVQConfig(**kw).num_quantizers_for_bandwidth(bandwidth) == (
        jrvq.RVQConfig(**kw).num_quantizers_for_bandwidth(bandwidth)
    )


def test_fused_flag_wiring(monkeypatch):
    """FUSED_RVQ routes rvq_inference through the fused path with the same
    outputs (as test_pallas_rvq_flag_wiring); on the CPU that is the plain
    version, and no kernel launch is counted."""
    n_q, bins, D = 4, 32, 128
    rs = np.random.RandomState(0)
    embed = rs.randn(n_q, bins, D).astype(np.float32)
    _, _, cfg, state = _states(embed)
    # latents near a sum of codewords: every search has a wide margin, so
    # the bf16 search must pick the fp32 scan's tokens
    picks = rs.randint(0, bins, (n_q, 2, 40))
    x = sum(embed[q][picks[q]] * 0.5**q for q in range(n_q)) + 0.05 * rs.randn(2, 40, D)
    x = torch.from_numpy(x.astype(np.float32))
    q0, i0, s0 = trvq.rvq_inference(cfg, state, x)
    launches = rvq_kernel.LAUNCHES
    monkeypatch.setattr(trvq, "FUSED_RVQ", True)
    q1, i1, s1 = trvq.rvq_inference(cfg, state, x)
    assert rvq_kernel.LAUNCHES == launches
    np.testing.assert_array_equal(i1.numpy(), i0.numpy())
    np.testing.assert_allclose(q1.numpy(), q0.numpy(), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), atol=2e-2, rtol=2e-2)
    # sub_quants come from the fp32 codebooks, as in the JAX branch
    np.testing.assert_array_equal(s1.numpy(), s0.numpy())
