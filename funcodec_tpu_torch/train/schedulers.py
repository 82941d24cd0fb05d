"""Learning-rate schedules as functions of the update count (port of
funcodec_tpu/train/schedulers.py).

Behavioral reference: funcodec/schedulers/warmup_lr.py:11-50 (WarmupLR),
noam_lr.py (NoamLR), tri_stage_scheduler.py:16-120 (TriStageLR), and the
torch.optim.lr_scheduler classes the reference registers
(abs_task.py:155-168).

A schedule maps the optimizer's update count (0 before the first update)
to a learning rate; train/step.py's ``scale_by_learning_rate`` calls it.
They evaluate in Python floats (float64), as torch's schedulers do; the
JAX package evaluates the same formulas in float32 inside optax, so its
rates differ from these by float32 rounding. The epoch-wise torch schedulers
take ``steps_per_epoch`` and evaluate at epoch = step // steps_per_epoch,
the trajectory torch gives when every epoch has that many steps.
``ReduceLROnPlateau`` depends on the validation metric, so it is a host
object the trainer steps once an epoch, not a schedule.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def _inverse_sqrt(base: float, warmup_steps: int) -> Schedule:
    """base * min(s^-0.5, s * warmup^-1.5) with s = step + 1 (torch
    schedulers are 1-indexed through last_epoch)."""

    def schedule(step: int) -> float:
        s = step + 1
        return base * min(s ** -0.5, s * warmup_steps ** -1.5)

    return schedule


def warmup_lr(base_lr: float, warmup_steps: int = 25000) -> Schedule:
    """lr * warmup^0.5 * min(s^-0.5, s * warmup^-1.5): the peak is exactly
    base_lr at s == warmup_steps."""
    return _inverse_sqrt(base_lr * warmup_steps ** 0.5, warmup_steps)


def noam_lr(base_lr: float, model_size: int = 320, warmup_steps: int = 25000) -> Schedule:
    return _inverse_sqrt(base_lr * model_size ** -0.5, warmup_steps)


def tri_stage_lr(
    peak_lr: float,
    max_update: int,
    phase_ratio=(0.1, 0.4, 0.5),
    init_lr_scale: float = 0.01,
    final_lr_scale: float = 0.01,
) -> Schedule:
    """fairseq-style tri-stage: linear warmup, hold, exponential decay."""
    warmup = int(max_update * phase_ratio[0])
    hold = int(max_update * phase_ratio[1])
    decay = int(max_update * phase_ratio[2])
    init_lr = init_lr_scale * peak_lr
    final_lr = final_lr_scale * peak_lr
    lr_step = (peak_lr - init_lr) / max(warmup, 1)
    decay_factor = -math.log(final_lr_scale) / max(decay, 1)

    def schedule(step: int) -> float:
        if step < warmup:
            lr = init_lr + lr_step * step
        elif step < warmup + hold:
            lr = peak_lr
        else:
            lr = peak_lr * math.exp(-decay_factor * (step - warmup - hold))
        return max(lr, final_lr)

    return schedule


def step_lr(base_lr: float, steps_per_epoch: int, step_size: int, gamma: float = 0.1) -> Schedule:
    """torch StepLR: base * gamma^(epoch // step_size); epoch-wise."""
    return lambda step: base_lr * gamma ** (step // steps_per_epoch // step_size)


def multi_step_lr(base_lr: float, steps_per_epoch: int, milestones, gamma: float = 0.1) -> Schedule:
    """torch MultiStepLR: base * gamma^(number of milestones <= epoch)."""
    ms = sorted(int(m) for m in milestones)
    return lambda step: base_lr * gamma ** sum(step // steps_per_epoch >= m for m in ms)


def exponential_lr(base_lr: float, steps_per_epoch: int, gamma: float) -> Schedule:
    """torch ExponentialLR: base * gamma^epoch."""
    return lambda step: base_lr * gamma ** (step // steps_per_epoch)


def _cosine(lo: float, hi: float, t: float, period: float) -> float:
    """lo + (hi - lo) * (1 + cos(pi * t / period)) / 2."""
    return lo + (hi - lo) * (1 + math.cos(math.pi * t / period)) / 2


def cosine_annealing_lr(base_lr: float, steps_per_epoch: int, T_max: int, eta_min: float = 0.0) -> Schedule:
    """torch CosineAnnealingLR, closed form; epoch-wise."""
    return lambda step: _cosine(eta_min, base_lr, step // steps_per_epoch, T_max)


def cyclic_lr(
    base_lr: float,
    max_lr: float,
    step_size_up: int = 2000,
    step_size_down: Optional[int] = None,
    mode: str = "triangular",
    gamma: float = 1.0,
) -> Schedule:
    """torch CyclicLR (batch-wise): triangular / triangular2 / exp_range."""
    if mode not in ("triangular", "triangular2", "exp_range"):
        raise ValueError(f"unknown CyclicLR mode {mode}")
    down = step_size_down if step_size_down is not None else step_size_up
    total = step_size_up + down

    def schedule(step: int) -> float:
        cycle = math.floor(1 + step / total)
        pos = step - (cycle - 1) * total
        frac = pos / step_size_up if pos < step_size_up else 1 - (pos - step_size_up) / down
        amp = max_lr - base_lr
        if mode == "triangular2":
            amp = amp / (2.0 ** (cycle - 1))
        elif mode == "exp_range":
            amp = amp * gamma ** step
        return base_lr + amp * max(frac, 0.0)

    return schedule


def one_cycle_lr(
    max_lr: float,
    total_steps: int,
    pct_start: float = 0.3,
    anneal_strategy: str = "cos",
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Schedule:
    """torch OneCycleLR (batch-wise, two phases): from max_lr / div_factor up
    to max_lr over pct_start * total_steps, then down to
    max_lr / (div_factor * final_div_factor)."""
    if anneal_strategy not in ("cos", "linear"):
        raise ValueError(f"unknown anneal_strategy {anneal_strategy}")
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up = float(pct_start * total_steps) - 1
    down = float(total_steps - 1) - up

    def interp(frac: float, lo: float, hi: float) -> float:
        if anneal_strategy == "cos":
            return lo + (hi - lo) * (1 - math.cos(math.pi * frac)) / 2
        return lo + (hi - lo) * frac

    def schedule(step: int) -> float:
        if step <= up:
            return interp(min(max(step / max(up, 1e-8), 0.0), 1.0), initial_lr, max_lr)
        return interp(min(max((step - up) / max(down, 1e-8), 0.0), 1.0), max_lr, min_lr)

    return schedule


def cosine_annealing_warm_restarts(base_lr: float, T_0: int, T_mult: int = 1, eta_min: float = 0.0) -> Schedule:
    """torch CosineAnnealingWarmRestarts (batch-wise): cosine cycles
    restarting every T_0 * T_mult^i steps."""

    def schedule(step: int) -> float:
        if T_mult == 1:
            t_cur, t_i = step % T_0, T_0
        else:
            # the closed form of torch's CosineAnnealingWarmRestarts.step
            n = math.floor(math.log(step / T_0 * (T_mult - 1) + 1) / math.log(T_mult))
            t_cur = step - T_0 * (T_mult ** n - 1) / (T_mult - 1)
            t_i = T_0 * T_mult ** n
        return _cosine(eta_min, base_lr, t_cur, t_i)

    return schedule


class ReduceLROnPlateau:
    """The validation-metric scheduler (torch ReduceLROnPlateau semantics;
    AbsValEpochStepScheduler in the reference). Call ``step(val_metric)``
    once an epoch and read ``.lr``; ``state_dict``/``load_state_dict``
    carry it across a resume."""

    def __init__(
        self,
        base_lr: float,
        mode: str = "min",
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
        cooldown: int = 0,
        min_lr: float = 0.0,
    ):
        if mode not in ("min", "max") or threshold_mode not in ("rel", "abs"):
            raise ValueError(f"ReduceLROnPlateau: mode {mode!r}, threshold_mode {threshold_mode!r}")
        self.lr = float(base_lr)
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr = cooldown, min_lr
        self.best: Optional[float] = None
        self.num_bad = 0
        self.cooldown_counter = 0

    def _is_better(self, val: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            thr = self.best * (1 - self.threshold) if self.threshold_mode == "rel" else self.best - self.threshold
            return val < thr
        thr = self.best * (1 + self.threshold) if self.threshold_mode == "rel" else self.best + self.threshold
        return val > thr

    def step(self, val: float) -> float:
        val = float(val)
        if self._is_better(val):
            self.best, self.num_bad = val, 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        return self.lr

    def state_dict(self):
        return dict(lr=self.lr, best=self.best, num_bad=self.num_bad, cooldown_counter=self.cooldown_counter)

    def load_state_dict(self, state):
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad = state["num_bad"]
        self.cooldown_counter = state["cooldown_counter"]


EPOCH_WISE = ("steplr", "multisteplr", "exponentiallr", "cosineannealinglr", "lambdalr")


def build_scheduler(
    name: Optional[str],
    conf: dict,
    base_lr: float,
    max_update: Optional[int] = None,
    steps_per_epoch: Optional[int] = None,
) -> Optional[Schedule]:
    """The schedule of a reference registry name (abs_task.py:155-168), or
    None for no name. Epoch-wise torch schedulers need `steps_per_epoch`
    (the reference's num_iters_per_epoch); reducelronplateau is not a
    schedule (see ReduceLROnPlateau)."""
    if name is None:
        return None
    name = name.lower()
    if name == "warmuplr":
        return warmup_lr(base_lr, conf.get("warmup_steps", 25000))
    if name == "noamlr":
        return noam_lr(base_lr, conf.get("model_size", 320), conf.get("warmup_steps", 25000))
    if name == "tri_stage":
        if not max_update:
            raise ValueError("tri_stage needs max_update (abs_task.py:1383-1385)")
        return tri_stage_lr(
            base_lr, max_update,
            phase_ratio=tuple(conf.get("phase_ratio", (0.1, 0.4, 0.5))),
            init_lr_scale=conf.get("init_lr_scale", 0.01),
            final_lr_scale=conf.get("final_lr_scale", 0.01),
        )
    if name in EPOCH_WISE and not steps_per_epoch:
        raise ValueError(
            f"{name} steps per EPOCH in the reference (abs_scheduler.py:68-77); "
            "pass steps_per_epoch (num_iters_per_epoch) to map it onto a "
            "per-step schedule"
        )
    if name == "steplr":
        return step_lr(base_lr, steps_per_epoch, conf["step_size"], conf.get("gamma", 0.1))
    if name == "multisteplr":
        return multi_step_lr(base_lr, steps_per_epoch, conf.get("milestones", (30, 80)), conf.get("gamma", 0.1))
    if name == "exponentiallr":
        return exponential_lr(base_lr, steps_per_epoch, conf["gamma"])
    if name == "cosineannealinglr":
        return cosine_annealing_lr(base_lr, steps_per_epoch, conf["T_max"], conf.get("eta_min", 0.0))
    if name == "lambdalr":
        fn = conf.get("lr_lambda")
        if not callable(fn):
            raise ValueError(
                "lambdalr needs a python callable (torch LambdaLR's lr_lambda "
                "is not yaml-expressible in the reference either); pass "
                "conf={'lr_lambda': fn} or hand any step->lr callable directly "
                "to the trainer as the schedule"
            )
        return lambda step: base_lr * fn(step // steps_per_epoch)
    if name == "cycliclr":
        return cyclic_lr(
            conf.get("base_lr", base_lr), conf["max_lr"],
            conf.get("step_size_up", 2000), conf.get("step_size_down"),
            conf.get("mode", "triangular"), conf.get("gamma", 1.0),
        )
    if name == "onecyclelr":
        total = conf.get("total_steps", max_update)
        if not total:
            raise ValueError("onecyclelr needs total_steps (or max_update)")
        return one_cycle_lr(
            conf.get("max_lr", base_lr), total,
            conf.get("pct_start", 0.3), conf.get("anneal_strategy", "cos"),
            conf.get("div_factor", 25.0), conf.get("final_div_factor", 1e4),
        )
    if name == "cosineannealingwarmrestarts":
        return cosine_annealing_warm_restarts(base_lr, conf["T_0"], conf.get("T_mult", 1), conf.get("eta_min", 0.0))
    if name == "reducelronplateau":
        raise ValueError(
            "reducelronplateau is val-metric-dependent (AbsValEpochStepScheduler, "
            "trainer.py:332-335) and cannot be a pure step schedule; use "
            "funcodec_tpu_torch.train.schedulers.ReduceLROnPlateau on the trainer"
        )
    raise ValueError(f"unknown scheduler {name}")
