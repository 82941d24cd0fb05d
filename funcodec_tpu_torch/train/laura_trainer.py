"""Single-optimizer trainer for the Laura text2audio model (port of
funcodec_tpu/train/laura_trainer.py).

Behavioral reference: funcodec/train/trainer.py (Trainer :101-877) driving
LauraGenModel.forward; the optimizer and scheduler of the shipped
text2audio_codec_lm_nq2_uni_rel_pos.yaml (adam lr 1e-3, warmuplr 10k,
grad_clip 5, batch_bins 10240, best criterion (valid, loss, min)).

One process trains on one device. A step casts the fp32 master parameters
(the frozen codebook too) and the batch's floating inputs to the compute
dtype (``torch.func.functional_call``), so the gradients arrive in fp32 on
the masters; the fp32 islands are the model's (the LM's log_softmax, the
sampler's softmax, the attention softmax). The frozen codebook is not in
the optimizer. A step whose global gradient norm is not finite changes
nothing. Each step draws from a ``torch.Generator`` seeded from (seed,
step), validation batch i from (seed, i), so a resumed run draws what an
uninterrupted one draws.

Batches are padded as the JAX package pads them (``bucket_batch``: text
and codec lengths rounded up to multiples of 32 with zeros; codec clamped
at 0): two quirks of the reference loss (the regression loss's mask over
the feature axis, the accuracy counting pads) depend on the padded length.
Checkpoints are PyTorch files under the reference's names
(train/checkpoint.py); ``{epoch}epoch.pth`` is the model's state_dict,
which cli/text2audio_inference serves. A run of the JAX package's trainer
resumes from its checkpoint.ckpt.

Under data parallelism (``group``, a ``parallel.dist.DataGroup``, the JAX
trainer's ``mesh``) every rank runs the loop over the same batches; a batch
is bucketed whole, so every rank pads to the same lengths, and each rank
keeps its equal block of the rows (a batch must split evenly, as a sharded
batch must in JAX). The loss's denominators and the stats are the global
batch's (models/laura.py), the gradients are averaged over the ranks in
one all_reduce a step, and rank 0 alone writes the files while the others
wait at a barrier. cli/text2audio_train stays one process, as JAX's.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from funcodec_tpu_torch.parallel.dist import DataGroup, barrier, broadcast_value, is_writer, shard_rows
from funcodec_tpu_torch.train.checkpoint import (
    load_jax_train_state,
    load_train_state,
    save_train_state,
    save_weights,
    update_symlink,
)
from funcodec_tpu_torch.train.gan_trainer import _sync, fetch_stats, step_generator
from funcodec_tpu_torch.train.reporter import Reporter
from funcodec_tpu_torch.train.schedulers import build_scheduler
from funcodec_tpu_torch.train.step import (
    GradientTransformation,
    _grads,
    _skip,
    apply_updates_if_finite,
    cast_floating,
    make_optimizer,
)


def trainable(model: nn.Module) -> List[nn.Parameter]:
    """The parameters the optimizer holds: all but the frozen codebook."""
    return [p for p in model.parameters() if p.requires_grad]


@dataclasses.dataclass
class LauraTrainState:
    """The update count, the model (its parameters are the fp32 masters)
    and the optimizer state over ``trainable(model)``."""

    step: int
    model: nn.Module
    opt_state: Any


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def bucket_batch(batch: Dict[str, np.ndarray], quantum: int = 32) -> Dict[str, np.ndarray]:
    """text and codec zero-padded to lengths that are multiples of `quantum`."""
    out = dict(batch)
    for name in ("text", "codec"):
        if name not in batch or isinstance(batch[name], list):
            continue
        arr = batch[name]
        pad = _round_up(arr.shape[1], quantum) - arr.shape[1]
        if pad > 0:
            out[name] = np.pad(arr, [(0, 0), (0, pad)] + [(0, 0)] * (arr.ndim - 2))
    return out


@dataclasses.dataclass
class LauraTrainerOptions:
    output_dir: str = "exp/laura"
    max_epoch: int = 50
    num_iters_per_epoch: Optional[int] = None
    batch_bins: int = 10240
    seed: int = 0
    log_interval: int = 50
    keep_nbest_models: int = 50
    best_model_criterion: Tuple[str, str, str] = ("valid", "loss", "min")
    patience: Optional[int] = None
    resume: bool = True
    num_workers: int = 8
    grad_clip: float = 5.0
    optim: str = "adam"
    optim_conf: Dict[str, Any] = dataclasses.field(default_factory=lambda: {"lr": 1e-3})
    scheduler: Optional[str] = "warmuplr"
    scheduler_conf: Dict[str, Any] = dataclasses.field(default_factory=lambda: {"warmup_steps": 10000})
    accum_grad: int = 1
    # torch.profiler trace over a window of steps (utils/profiling.py)
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_num_steps: int = 5
    # "float32" or "bfloat16": mixed precision over fp32 masters
    train_dtype: str = "float32"


def make_laura_train_step(model: nn.Module, optimizer: GradientTransformation,
                          compute_dtype: Optional[torch.dtype] = None,
                          group: Optional[DataGroup] = None) -> Callable:
    """step(state, batch, generator) -> (state, stats): the loss's forward
    and backward on `compute_dtype` copies of the parameters and the batch's
    floating inputs, then the gated optimizer update of the fp32 masters in
    place. `batch` holds text, text_lengths, codec and codec_lengths on the
    model's device (this rank's rows under a data `group`, the gradients
    then averaged over the ranks); stats are the model's plus grad_norm and
    nonfinite_skip."""
    masters = trainable(model)

    def step(state: LauraTrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        params = cast_floating(dict(model.named_parameters()), compute_dtype)
        loss, stats = functional_call(model, params, (
            cast_floating(batch["text"], compute_dtype), batch["text_lengths"], batch["codec"],
            batch["codec_lengths"], generator), {"group": group})
        grads = _grads(loss, masters, group)
        state.opt_state, grad_norm, finite = apply_updates_if_finite(optimizer, grads, state.opt_state, masters)
        stats = {k: v.detach() for k, v in stats.items()}  # not the graph's: it is freed here
        stats.update(grad_norm=grad_norm, nonfinite_skip=_skip(finite, grad_norm.device))
        state.step += 1
        return state, stats

    return step


class LauraTrainer:
    """Trains `model` (built by tasks/text2audio.py on the device it runs
    on, its codebook grafted) with `options`; `group` is this rank's data
    group (None: one process)."""

    def __init__(self, model: nn.Module, options: LauraTrainerOptions, group: Optional[DataGroup] = None):
        o = options
        self.model = model
        self.opt = o
        self.group = group
        self.device = model.device
        self.reporter = Reporter()
        lr = o.optim_conf.get("lr", 1e-3)
        self.optimizer = make_optimizer(
            lr=lr,
            betas=tuple(o.optim_conf.get("betas", o.optim_conf.get("adam_betas", (0.9, 0.999)))),
            eps=o.optim_conf.get("eps", o.optim_conf.get("adam_eps", 1e-8)),
            weight_decay=o.optim_conf.get("weight_decay", 0.0),
            grad_clip=o.grad_clip,
            schedule=build_scheduler(o.scheduler, o.scheduler_conf, lr),
            accum_grad=o.accum_grad,
            name=o.optim,
            momentum=o.optim_conf.get("momentum", 0.0),
        )
        self.train_step = make_laura_train_step(
            model, self.optimizer, torch.bfloat16 if o.train_dtype in ("bfloat16", "bf16") else None, group)
        # per-epoch walls (train, valid, checkpoint), steps and codec frames trained on
        self.epoch_walls: Dict[int, Dict[str, float]] = {}

    def init_state(self) -> LauraTrainState:
        return LauraTrainState(step=0, model=self.model, opt_state=self.optimizer.init(trainable(self.model)))

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A collated batch bucketed (whole), its codec clamped at 0, this
        rank's rows on the device (through pinned memory without blocking,
        on a card)."""
        batch = bucket_batch(batch)
        host = dict(text=batch["text"], text_lengths=batch["text_lengths"], codec=np.maximum(batch["codec"], 0),
                    codec_lengths=batch["codec_lengths"])
        return shard_rows(host, self.group, self.device)

    # -- loops ---------------------------------------------------------------

    def train_one_epoch(self, state: LauraTrainState, loader, epoch: int, tracer) -> LauraTrainState:
        o = self.opt
        sub = self.reporter.start_epoch("train")
        t0 = time.time()
        frames = steps = 0
        for i, (keys, batch) in enumerate(loader):
            tracer.tick(state.step)
            dev_batch = self.to_device(batch)
            state, stats = self.train_step(state, dev_batch, step_generator(self.device, o.seed, state.step))
            frames += int(np.sum(batch["codec_lengths"]))
            steps += 1
            sub.register(fetch_stats(stats), weight=len(keys))
            if (i + 1) % o.log_interval == 0:
                logging.info(sub.log_message())
            if o.num_iters_per_epoch and (i + 1) >= o.num_iters_per_epoch:
                break
        tracer.stop()
        _sync(self.device)
        self.epoch_walls.setdefault(epoch, {}).update(train_s=time.time() - t0, train_frames=frames, train_steps=steps)
        self.reporter.finish_epoch(sub)
        return state

    def validate(self, state: LauraTrainState, loader, epoch: int) -> Dict[str, float]:
        """The loss and its stats on the fp32 masters, with the training
        forward's draws (valid batch i draws from (seed, i)), as JAX's."""
        t0 = time.time()
        sub = self.reporter.start_epoch("valid")
        with torch.inference_mode():
            for vi, (keys, batch) in enumerate(loader):
                b = self.to_device(batch)
                _, stats = state.model(b["text"], b["text_lengths"], b["codec"], b["codec_lengths"],
                                       step_generator(self.device, self.opt.seed, vi), group=self.group)
                sub.register(fetch_stats(stats), weight=len(keys))
        self.reporter.finish_epoch(sub)
        self.epoch_walls.setdefault(epoch, {})["valid_s"] = time.time() - t0
        return sub.to_dict()

    # -- checkpoints ---------------------------------------------------------

    def _save_epoch(self, state: LauraTrainState, epoch: int) -> None:
        """The epoch's files, written by rank 0; every rank waits for them."""
        if is_writer(self.group):
            self._write_epoch(state, epoch)
        barrier(self.group)

    def _write_epoch(self, state: LauraTrainState, epoch: int) -> None:
        o = self.opt
        d = Path(o.output_dir)
        t0 = time.time()
        save_train_state(str(d / "checkpoint.pth"), state)
        walls = self.epoch_walls.setdefault(epoch, {})
        walls["checkpoint_s"] = time.time() - t0
        walls["checkpoint_bytes"] = float(os.path.getsize(d / "checkpoint.pth"))
        weights = d / f"{epoch}epoch.pth"
        save_weights(str(weights), state.model)
        update_symlink(str(weights), str(d / "latest.pth"))
        (d / "reporter.json").write_text(json.dumps(self.reporter.state_dict()))
        phase, key, mode = o.best_model_criterion
        if self.reporter.best_epoch(phase, key, mode) == epoch:
            update_symlink(str(weights), str(d / f"{phase}.{key}.best.pth"))
        keep = set(self.reporter.sort_epochs(phase, key, mode)[: o.keep_nbest_models]) | {epoch}
        for p in d.glob("*epoch.pth"):
            if int(p.name.replace("epoch.pth", "")) not in keep:
                p.unlink()

    def resume(self, state: LauraTrainState) -> Tuple[LauraTrainState, int]:
        """checkpoint.pth and reporter.json of output_dir, when resuming and
        they exist; in a directory of the JAX package's trainer without a
        checkpoint.pth, its checkpoint.ckpt (the JAX run goes on here, the
        port's files written beside the JAX ones, which stay as they are):
        (the restored state, the next epoch)."""
        d = Path(self.opt.output_dir)
        ckpt = d / "checkpoint.pth"
        if not ckpt.exists() and (d / "checkpoint.ckpt").exists():
            ckpt = d / "checkpoint.ckpt"
        if not (self.opt.resume and ckpt.exists()):
            return state, 1
        if ckpt.suffix == ".ckpt":
            state = load_jax_train_state(str(ckpt), state, self.optimizer)
        else:
            state = load_train_state(str(ckpt), state)
        start = 1
        rep = d / "reporter.json"
        if rep.exists():
            self.reporter.load_state_dict(json.loads(rep.read_text()))
            start = self.reporter.epoch + 1
        logging.info("resumed from %s at epoch %d", ckpt, start)
        return state, start

    # -- entry ---------------------------------------------------------------

    def run(self, state: LauraTrainState, train_loader_factory, valid_loader_factory) -> LauraTrainState:
        """Epochs from the resumed one to max_epoch: train, validate, save;
        the loader factories map an epoch to an iterable of (keys, batch)."""
        from funcodec_tpu_torch.utils.profiling import StepTraceCapture

        o = self.opt
        Path(o.output_dir).mkdir(parents=True, exist_ok=True)
        state, start_epoch = self.resume(state)
        tracer = StepTraceCapture(o.profile_dir if is_writer(self.group) else None, o.profile_start_step,
                                  o.profile_num_steps)
        phase, key, mode = o.best_model_criterion
        for epoch in range(start_epoch, o.max_epoch + 1):
            self.reporter.set_epoch(epoch)
            state = self.train_one_epoch(state, train_loader_factory(epoch), epoch, tracer)
            self.validate(state, valid_loader_factory(epoch), epoch)
            self._save_epoch(state, epoch)
            stats = self.reporter.stats[epoch]
            logging.info("epoch %d: train loss=%.4f valid loss=%.4f", epoch, stats["train"]["loss"],
                         stats["valid"]["loss"])
            if o.patience is not None and broadcast_value(
                    float(self.reporter.check_early_stopping(o.patience, phase, key, mode)), self.group):
                break
        return state
