"""The port's learning-rate schedules (funcodec_tpu_torch/train/schedulers.py)
against funcodec_tpu's and against torch.optim.lr_scheduler, on the CPU.

Every build_scheduler name over the first 2,000 updates:

- against torch.optim.lr_scheduler's own class, where torch has one (the
  reference trains with those): within 1e-7 relative, update by update;
- against the JAX package's schedule as optax evaluates it (jitted, an int32
  count, float32 arithmetic): JAX's rates carry float32 rounding (measured
  up to about 1.2e-7 relative to the rate, more near a cancellation), so the
  port's float64 rates are held within 2.5e-7 of the schedule's largest rate
  in the window, i.e. two float32 ulps of it. CyclicLR's exp_range raises
  gamma to the s-th power, and JAX's gamma is rounded to float32 (a 5e-6
  drift at s = 2,000 for gamma 0.999): there the port is given JAX's
  float32 gamma.

The same ValueErrors as JAX's build_scheduler; ReduceLROnPlateau step by step
against JAX's and torch's, and its state dict across a resume.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from funcodec_tpu.train import schedulers as jsched
from funcodec_tpu_torch.train import schedulers as tsched

torch.set_num_threads(1)

N = 2000
LR = 1e-3
REL = 1e-7
F32_PEAK = 2.5e-7

# (name, conf, build_scheduler kwargs)
CASES = [
    ("warmuplr", {"warmup_steps": 300}, {}),
    ("warmuplr", {"warmup_steps": 10000}, {}),  # the shipped LauraTTS schedule
    ("noamlr", {"model_size": 256, "warmup_steps": 300}, {}),
    ("tri_stage", {}, {"max_update": 1500}),
    ("steplr", {"step_size": 2, "gamma": 0.5}, {"steps_per_epoch": 100}),
    ("multisteplr", {"milestones": [3, 7, 12], "gamma": 0.1}, {"steps_per_epoch": 100}),
    ("exponentiallr", {"gamma": 0.9}, {"steps_per_epoch": 50}),
    ("cosineannealinglr", {"T_max": 15, "eta_min": 1e-5}, {"steps_per_epoch": 100}),
    ("lambdalr", {"lr_lambda": lambda e: 1.0 / (1 + e)}, {"steps_per_epoch": 100}),
    ("cycliclr", {"max_lr": 1e-2, "step_size_up": 300, "step_size_down": 200}, {}),
    ("cycliclr", {"max_lr": 1e-2, "step_size_up": 300, "mode": "triangular2"}, {}),
    ("cycliclr", {"max_lr": 1e-2, "step_size_up": 300, "mode": "exp_range", "gamma": 0.999}, {}),
    ("onecyclelr", {"total_steps": N}, {}),
    ("onecyclelr", {"total_steps": N, "anneal_strategy": "linear", "pct_start": 0.25}, {}),
    ("cosineannealingwarmrestarts", {"T_0": 300}, {}),
    ("cosineannealingwarmrestarts", {"T_0": 100, "T_mult": 2, "eta_min": 1e-6}, {}),
]
IDS = [f"{n}-{i}" for i, (n, _, _) in enumerate(CASES)]


def port_rates(name, conf, kw):
    schedule = tsched.build_scheduler(name, conf, LR, **kw)
    return np.array([schedule(i) for i in range(N)])


@pytest.mark.parametrize("name,conf,kw", CASES, ids=IDS)
def test_schedule_matches_jax(name, conf, kw):
    schedule = jsched.build_scheduler(name, conf, LR, **kw)
    if name == "lambdalr":  # a Python callable: JAX evaluates it on the host too
        ref = np.array([schedule(i) for i in range(N)], np.float64)
    else:
        ref = np.asarray(jax.jit(jax.vmap(schedule))(jnp.arange(N, dtype=jnp.int32)), np.float64)
    if conf.get("mode") == "exp_range":
        # JAX raises gamma, rounded to float32, to the s-th power: the rounding grows with s
        conf = dict(conf, gamma=float(np.float32(conf["gamma"])))
    ours = port_rates(name, conf, kw)
    assert np.abs(ours - ref).max() <= F32_PEAK * np.abs(ref).max(), np.abs(ours - ref).max() / np.abs(ref).max()


def _torch_builtin(name, conf, kw):
    """torch's scheduler class for a name, and how many updates one of its
    steps covers (an epoch for the epoch-wise ones)."""
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=LR, momentum=0.9)
    S = torch.optim.lr_scheduler
    spe = kw.get("steps_per_epoch", 1)
    if name == "steplr":
        return S.StepLR(opt, conf["step_size"], conf["gamma"]), spe
    if name == "multisteplr":
        return S.MultiStepLR(opt, conf["milestones"], conf["gamma"]), spe
    if name == "exponentiallr":
        return S.ExponentialLR(opt, conf["gamma"]), spe
    if name == "cosineannealinglr":
        return S.CosineAnnealingLR(opt, conf["T_max"], conf["eta_min"]), spe
    if name == "lambdalr":
        return S.LambdaLR(opt, conf["lr_lambda"]), spe
    if name == "cycliclr":
        return S.CyclicLR(opt, LR, conf["max_lr"], conf["step_size_up"], conf.get("step_size_down"),
                          conf.get("mode", "triangular"), conf.get("gamma", 1.0), cycle_momentum=False), 1
    if name == "onecyclelr":
        return S.OneCycleLR(opt, LR, total_steps=conf["total_steps"], pct_start=conf.get("pct_start", 0.3),
                            anneal_strategy=conf.get("anneal_strategy", "cos"), cycle_momentum=False), 1
    return S.CosineAnnealingWarmRestarts(opt, conf["T_0"], conf.get("T_mult", 1), conf.get("eta_min", 0.0)), 1


@pytest.mark.parametrize("name,conf,kw", [c for c in CASES if c[0] not in ("warmuplr", "noamlr", "tri_stage")],
                         ids=[i for i, c in zip(IDS, CASES) if c[0] not in ("warmuplr", "noamlr", "tri_stage")])
def test_schedule_matches_torch_scheduler(name, conf, kw):
    sched, per = _torch_builtin(name, conf, kw)
    ref = []
    for i in range(N):
        if i and i % per == 0:
            sched.optimizer.step()  # no gradients: a no-op that keeps torch's step order
            sched.step()
        ref.append(sched.get_last_lr()[0])
    ours = port_rates(name, conf, kw)
    np.testing.assert_allclose(ours, np.array(ref), rtol=REL, atol=0)


def test_warmup_peaks_at_base_lr_and_is_one_indexed():
    schedule = tsched.build_scheduler("warmuplr", {"warmup_steps": 10000}, LR)
    assert math.isclose(schedule(9999), LR, rel_tol=1e-12)
    assert math.isclose(schedule(0), LR / 10000, rel_tol=1e-12)  # 1e-7: the first update of the shipped recipe
    assert schedule(10000) < LR


@pytest.mark.parametrize("name,conf,kw,match", [
    ("tri_stage", {}, {}, "max_update"),
    ("steplr", {"step_size": 1}, {}, "steps per EPOCH"),
    ("multisteplr", {}, {}, "steps per EPOCH"),
    ("exponentiallr", {"gamma": 0.9}, {}, "steps per EPOCH"),
    ("cosineannealinglr", {"T_max": 3}, {}, "steps per EPOCH"),
    ("lambdalr", {}, {}, "steps per EPOCH"),
    ("lambdalr", {"lr_lambda": 2.0}, {"steps_per_epoch": 10}, "python callable"),
    ("onecyclelr", {}, {}, "total_steps"),
    ("reducelronplateau", {}, {}, "val-metric-dependent"),
    ("nosuchlr", {}, {}, "unknown scheduler"),
])
def test_build_scheduler_raises_as_jax(name, conf, kw, match):
    with pytest.raises((ValueError, AssertionError), match=match):  # JAX asserts max_update
        jsched.build_scheduler(name, conf, LR, **kw)
    with pytest.raises(ValueError, match=match):
        tsched.build_scheduler(name, conf, LR, **kw)


def test_no_name_is_no_schedule():
    assert tsched.build_scheduler(None, {}, LR) is None


@pytest.mark.parametrize("kw", [dict(), dict(mode="max", threshold_mode="abs", threshold=0.05, cooldown=2,
                                              factor=0.5, patience=1, min_lr=2e-4)])
def test_reduce_lr_on_plateau_matches_jax_and_torch(kw):
    """Step by step against JAX's and torch's on one metric sequence; a
    state dict taken halfway resumes into the same remaining rates."""
    rs = np.random.RandomState(0)
    metrics = list(np.cumsum(rs.randn(60)) * 0.1 + 5.0)
    ours, ref = tsched.ReduceLROnPlateau(LR, **kw), jsched.ReduceLROnPlateau(LR, **kw)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=LR)
    th = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, eps=0.0, **kw)
    rates = []
    for i, m in enumerate(metrics):
        if i == 30:
            saved = ours.state_dict()
        rates.append(ours.step(m))
        th.step(m)
        assert rates[-1] == ref.step(m)
        assert math.isclose(rates[-1], opt.param_groups[0]["lr"], rel_tol=1e-12)
    assert len(set(rates)) > 1, "the metric sequence never reduced the rate"
    resumed = tsched.ReduceLROnPlateau(LR, **kw)
    resumed.load_state_dict(saved)
    assert [resumed.step(m) for m in metrics[30:]] == rates[30:]
