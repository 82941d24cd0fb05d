"""The fused SEANet configuration of the port against the JAX package's, on the CPU.

The port with ``FUSED_STRIDE1`` and ``FUSED_RESBLOCK`` (and ``FUSED_RVQ``)
on, where every kernel wrapper takes its plain version for CPU tensors,
against funcodec_tpu with ``PALLAS_STRIDE1``, ``PALLAS_RESBLOCK`` (and
``PALLAS_RVQ``) and the three ``INTERPRET`` switches on. The model has
resblocks at 64 and 128 channels, so the JAX resblock peephole (C >= 128)
fires too. Pass criteria: latents and decoder outputs within atol 5e-4,
rtol 2e-3 (the JAX peephole test's tolerance), >= 99% all-stage token
agreement, and no kernel launch counted on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import funcodec_tpu.ops.conv as jconv
import funcodec_tpu.ops.conv_pallas as jcp
import funcodec_tpu.ops.resblock_pallas as jrbp
import funcodec_tpu.quant.rvq as jrvq
import funcodec_tpu.quant.rvq_pallas as jrp
import funcodec_tpu_torch.ops.conv as tconv
import funcodec_tpu_torch.quant.rvq as trvq
from funcodec_tpu_torch.cli.codec_inference import Speech2Token
from funcodec_tpu_torch.ops import conv_kernel, resblock_kernel
from funcodec_tpu_torch.quant import rvq_kernel
from funcodec_tpu_torch.tasks.codec import build_codec_model as tbuild
from test_torch_encodec import _config, _jit, _pair, _speech


def _fused_config():
    return _config(n_q=4, bins=64, dim=16, n_filters=64)  # resblocks at C = 64 and 128


def _launches():
    return conv_kernel.LAUNCHES, resblock_kernel.LAUNCHES, rvq_kernel.LAUNCHES


def _flags(monkeypatch, stride1, resblock, rvq=False):
    for mod, name, on in ((jconv, "PALLAS_STRIDE1", stride1), (jconv, "PALLAS_RESBLOCK", resblock),
                          (jrvq, "PALLAS_RVQ", rvq), (tconv, "FUSED_STRIDE1", stride1),
                          (tconv, "FUSED_RESBLOCK", resblock), (trvq, "FUSED_RVQ", rvq)):
        monkeypatch.setattr(mod, name, on)
    for mod in (jcp, jrbp, jrp):
        monkeypatch.setattr(mod, "INTERPRET", True)


def _count_plain_calls(monkeypatch):
    """Count the plain versions the wrappers take, to show the fused branches ran."""
    calls = {"conv": 0, "resblock": 0}
    for key, mod, name in (("conv", conv_kernel, "fused_conv1d_s1_reference"),
                           ("resblock", resblock_kernel, "fused_resblock_tgn_reference")):
        real = getattr(mod, name)

        def spy(*a, _key=key, _real=real, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize(
    "stride1,resblock,expect",
    [(True, False, {"conv": 8, "resblock": 0}), (True, True, {"conv": 4, "resblock": 4})],
    ids=["stride1", "stride1+resblock"],
)
def test_fused_seanet_matches_jax(monkeypatch, stride1, resblock, expect):
    jm, params, state, tm = _pair(_fused_config())
    x = _speech(batch=2, length=1600, seed=11)
    _flags(monkeypatch, stride1, resblock)
    calls = _count_plain_calls(monkeypatch)
    j_lat = np.asarray(_jit(jm.encoder, params["encoder"], jnp.asarray(x)))
    j_dec = np.asarray(_jit(jm.decoder, params["decoder"], jnp.asarray(j_lat)))
    before = _launches()
    with torch.no_grad():
        t_lat = tm.encoder(torch.from_numpy(x))
        t_dec = tm.decoder(torch.from_numpy(j_lat.copy()))
    assert _launches() == before
    # encoder: first conv, 2 resblocks (1 conv each unless fused), ELU + last
    # conv; the decoder the same, mirrored
    assert calls == expect
    np.testing.assert_allclose(t_lat.numpy(), j_lat, atol=5e-4, rtol=2e-3)
    np.testing.assert_allclose(t_dec.numpy(), j_dec, atol=5e-4, rtol=2e-3)


def test_speech2token_fused_matches_jax(monkeypatch, tmp_path):
    """The whole fused configuration through the public entry point."""
    config = _fused_config()
    jm, params, state, tm = _pair(config)
    pth = tmp_path / "model.pth"
    torch.save(tm.state_dict(), pth)
    s2t = Speech2Token(config, str(pth), dtype="float32", bit_width=None, device="cpu")
    x = _speech(batch=2, length=1600, seed=12)
    _flags(monkeypatch, True, True, rvq=True)
    ref = _jit(jm.inference, params, state, jnp.asarray(x), need_recon=True)
    before = _launches()
    codes, _, recon, _ = s2t(x)
    assert _launches() == before
    j_idx = np.asarray(ref["code_indices"][0])
    assert codes[0].shape == j_idx.shape == (4, 2, 200)
    assert (codes[0] == j_idx).mean() >= 0.99
    assert recon.shape == x.shape and np.isfinite(recon).all()


def test_default_device_is_the_card():
    """build_codec_model and Speech2Token default to "cuda"; where torch sees
    no card they raise instead of dropping to the CPU."""
    config = _config()
    if torch.cuda.is_available():
        model, _ = tbuild(config)
        assert next(model.parameters()).device.type == "cuda"
        assert Speech2Token(config).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tbuild(config)
    with pytest.raises(RuntimeError, match="cuda"):
        Speech2Token(config)
