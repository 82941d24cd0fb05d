"""The port's trainer against funcodec_tpu's over one epoch, on the CPU.

Both trainers start from the same weights: the JAX train state of
tests/test_torch_gan_step.py's tiny model, cut further (``_config``; seeded
numpy values; k-means
init off, no quantizer dropout, expiry "reference": no random draws), carried
into the port by ``compat/from_jax.train_state_from_jax``. Both run
``shared_forward`` (the recipe's mode), Adam lr 1e-3 for both turns, over
the same corpus of 6 utterances no longer than speech_max_length (zero-padded:
the preprocessor draws nothing), 1 epoch x 3 iterations of batch 2, then
validation with two dumps scored by the quality metrics. The JAX trainer
runs once (its step and its valid step jit once).

Tolerances: the per-epoch train and valid stats of reporter.json rtol 1e-4
(fp32, summation order; the timing stats excluded); the final generator
parameters within 0.05 lr of JAX's, with the exemption of
tests/test_torch_gan_two_steps.py (the bias a one-channel time_group_norm
removes: a 0 gradient in exact arithmetic, rounding noise that Adam turns
into steps of about +-lr, held finite); the discriminator's as
``_assert_disc_params_close`` says. The carried state stepped once
more holds the two-step test's tolerances; the port's weights file,
imported by funcodec_tpu's compat/torch_import.import_encodec, gives JAX
tokens equal to the port's in fp32.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from funcodec_tpu.compat.torch_import import import_encodec
from funcodec_tpu.data.dataset import CodecDataset as JDataset
from funcodec_tpu.data.preprocessor import CodecPreprocessor as JPre
from funcodec_tpu.train import step as jstep
from funcodec_tpu.train.gan_trainer import GANCodecTrainer as JTrainer
from funcodec_tpu.train.gan_trainer import TrainerOptions as JOptions
from funcodec_tpu_torch.cli.codec_inference import Speech2Token
from funcodec_tpu_torch.compat.from_jax import train_state_from_jax
from funcodec_tpu_torch.data.dataset import CodecDataset as TDataset
from funcodec_tpu_torch.data.preprocessor import CodecPreprocessor as TPre
from funcodec_tpu_torch.data.wav_io import write_wav
from funcodec_tpu_torch.tasks.codec import build_codec_model as tbuild
from funcodec_tpu_torch.train import step as tstep
from funcodec_tpu_torch.train.gan_trainer import GANCodecTrainer as TTrainer
from funcodec_tpu_torch.train.gan_trainer import TrainerOptions as TOptions
from tests.test_torch_gan_step import LR, build_pair, config, np_tree
from tests.test_torch_gan_two_steps import _assert_params_within_lr, _norm_removed_biases

torch.set_num_threads(1)

MAX_LEN = 4096
TIMING = ("iter_time", "step_time")


def _options(cls, out):
    return cls(output_dir=str(out), max_epoch=1, num_iters_per_epoch=3, batch_size=2, seed=0, log_interval=1000,
               keep_nbest_models=1, num_workers=1, optim_conf={"lr": LR, "betas": (0.5, 0.9)},
               optim2_conf={"lr": LR, "betas": (0.5, 0.9)}, num_valid_dump_wavs=2, use_tensorboard=False,
               shared_forward=True)


def _config():
    """tests/test_torch_gan_step.py's tiny model with one downsampling stage,
    a one-layer LSTM, two quantizers and one mel scale: each package's graph
    is smaller, which keeps the JAX step's trace and compile short."""
    cfg = config(num_quantizers=2)
    for k in ("encoder_conf", "decoder_conf"):
        cfg[k] = dict(cfg[k], ratios=[2], seq_layer_num=1)
    cfg["model_conf"] = dict(cfg["model_conf"], multi_spectral_window_powers_of_two=[6])
    return cfg


def _datasets(dataset_cls, pre_cls, scp):
    train = dataset_cls([(scp, "speech", "sound")], preprocess=pre_cls(train=True, speech_max_length=MAX_LEN))
    valid = dataset_cls([(scp, "speech", "sound")], preprocess=pre_cls(train=False, speech_max_length=MAX_LEN))
    return train, valid


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    rs = np.random.RandomState(0)
    lines = []
    for i, n in enumerate([2500, 2800, 3100, 3400, 3700, MAX_LEN]):
        w = 0.2 * np.sin(2 * np.pi * (120 + 50 * i) * np.arange(n) / 16000) + 0.05 * rs.randn(n)
        write_wav(root / f"u{i}.wav", w.astype(np.float32), 16000)
        lines.append(f"u{i} {root / f'u{i}.wav'}")
    (root / "wav.scp").write_text("\n".join(lines) + "\n")
    scp = str(root / "wav.scp")

    cfg = _config()
    p = build_pair(cfg)
    jtr = JTrainer(p.jm, p.jdisc, _options(JOptions, root / "jax"))
    j_state0 = jstep.create_gan_train_state(p.params, p.disc_params, p.state, jtr.optimizer_g, jtr.optimizer_d)
    ttr = TTrainer(p.tm, p.tdisc, _options(TOptions, root / "port"))
    t_state0 = train_state_from_jax(p.tm, p.tdisc, j_state0, ttr.optimizer_g, ttr.optimizer_d)
    p.state = np_tree(p.state)  # the JAX step donates its state; port_params reads these buffers

    j_state = jtr.run(j_state0, *_datasets(JDataset, JPre, scp))
    t_state = ttr.run(t_state0, *_datasets(TDataset, TPre, scp))
    reports = [json.loads((root / d / "reporter.json").read_text()) for d in ("jax", "port")]
    return dict(root=root, cfg=cfg, pair=p, jtr=jtr, j_state=j_state, t_state=t_state, reports=reports)


def _assert_disc_params_close(got, want):
    """The discriminator after the epoch: in each tensor every element within
    0.25 lr of JAX's and 99% of them within 0.05 lr. Its gradient is the
    difference of the real and the fake branches' (hinge on each), which
    nearly cancel at some elements; the packages' rounding there is a larger
    share of the gradient, and Adam's early, sign-like steps carry it into
    the parameters."""
    for name, t in got.items():
        d = np.abs(t.detach().numpy() - np.asarray(want[name])) / LR
        assert float(d.max()) <= 0.25 and float((d > 0.05).mean()) <= 0.01, (
            f"discriminator {name}: max {float(d.max())} lr, {float((d > 0.05).mean())} beyond 0.05 lr")


def test_epoch_stats_match_jax(runs):
    j_rep, t_rep = runs["reports"]
    assert j_rep["epoch"] == t_rep["epoch"] == 1
    for phase in ("train", "valid"):
        want, got = j_rep["stats"]["1"][phase], t_rep["stats"]["1"][phase]
        assert set(got) == set(want), phase
        for k in want:
            if k not in TIMING:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7, err_msg=f"{phase} {k}")
    assert {"stoi", "nsim", "si_snr_db"} <= set(t_rep["stats"]["1"]["valid"])


def test_epoch_params_match_jax(runs):
    p, j_state, t_state = runs["pair"], runs["j_state"], runs["t_state"]
    assert t_state.step == int(j_state.step) == 3
    exempt = _norm_removed_biases(p.tm)
    assert len(exempt) == 1  # SEANet's last decoder conv
    _assert_params_within_lr(t_state.params, p.port_params(j_state.params), "generator", exempt)
    _assert_disc_params_close(t_state.disc_params, p.port_disc_params(j_state.disc_params))
    for name in ("cluster_size", "embed", "embed_avg", "inited"):
        np.testing.assert_allclose(getattr(t_state.rvq_state, name).numpy(),
                                   np.asarray(getattr(j_state.rvq_state, name)), rtol=1e-4, atol=1e-5)
    # the artifacts of both packages, under their own names
    root = runs["root"]
    assert (root / "jax" / "latest.ckpt").is_symlink() and (root / "port" / "latest.pth").is_symlink()


def test_carried_state_steps_like_jax(runs):
    """train_state_from_jax on JAX's state after the epoch (Adam count 3):
    one more step in each package agrees as the two-step test holds them."""
    p, jtr = runs["pair"], runs["jtr"]
    tm, tdisc = tbuild(runs["cfg"], device="cpu", generator=torch.Generator().manual_seed(1))
    opt_g, opt_d = tstep.make_optimizer(lr=LR), tstep.make_optimizer(lr=LR)
    carried = train_state_from_jax(tm, tdisc, runs["j_state"], opt_g, opt_d)
    assert carried.step == 3 and carried.opt_state_g[0]["count"] == 3 and carried.opt_state_d[1] == 3
    x = (0.3 * np.random.RandomState(3).randn(2, MAX_LEN)).astype(np.float32)
    j_state, j_stats = jtr._get_train_step()(runs["j_state"], {"speech": jnp.asarray(x)}, jax.random.PRNGKey(0))
    step = tstep.make_gan_train_step(tm, tdisc, opt_g, opt_d, shared_forward=True)
    t_state, t_stats = step(carried, {"speech": torch.from_numpy(x)}, torch.Generator().manual_seed(0))
    for k, v in jax.device_get(j_stats).items():
        np.testing.assert_allclose(float(t_stats[k]), float(v), rtol=2e-3, atol=1e-5, err_msg=k)
    _assert_params_within_lr(t_state.params, p.port_params(j_state.params), "generator", _norm_removed_biases(tm))
    _assert_params_within_lr(t_state.disc_params, p.port_disc_params(j_state.disc_params), "discriminator")
    for name in ("cluster_size", "embed", "embed_avg", "inited"):
        np.testing.assert_allclose(getattr(t_state.rvq_state, name).numpy(),
                                   np.asarray(getattr(j_state.rvq_state, name)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(t_state.gen_loss_carry), float(j_state.gen_loss_carry), rtol=2e-3)


def test_weights_file_gives_jax_the_same_tokens(runs):
    """The port's 1epoch.pth through JAX's import_encodec: JAX's fp32 tokens
    equal the port's (Speech2Token on the CPU, the same file)."""
    pth = runs["root"] / "port" / "1epoch.pth"
    sd = torch.load(pth, weights_only=True)
    params, rvq_state = import_encodec(sd, runs["pair"].jm)
    x = (0.3 * np.random.RandomState(4).randn(2, 3200)).astype(np.float32)
    j_codes = jax.jit(lambda prm, st, s: runs["pair"].jm.inference(prm, st, s)["code_indices"])(
        params, rvq_state, jnp.asarray(x))
    s2t = Speech2Token(runs["cfg"], str(pth), device="cpu")
    t_codes = s2t.model.inference(torch.from_numpy(x))["code_indices"]
    assert len(t_codes) == len(j_codes)
    for t, j in zip(t_codes, j_codes):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
