"""GAN codec training loop: epochs, validation, checkpoints, n-best (port of
funcodec_tpu/train/gan_trainer.py).

Behavioral reference: funcodec/train/trainer.py (Trainer.run :186-517:
resume, per-epoch validate, checkpoint/latest/best symlinks, n-best pruning
+ averaging) and funcodec/train/gan_trainer.py (:97-495: alternating turns,
max_update stop, validation wav dumps).

One process drives one card (or the CPU, when the modules live there). The
step is train/step.py's ``make_gan_train_step``; the epoch loop is host
orchestration. Batches stream from a threaded prefetch loader as numpy and
reach the card through pinned memory without blocking, or are cut on the
card from the device cache (data/device_cache.py). Each step draws from a
``torch.Generator`` seeded from (seed, step), so a resumed run draws what an
uninterrupted one draws. Stats are fetched every ``stats_interval`` steps in
one device-to-host copy. Checkpoints are PyTorch files under the reference's
names (train/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from funcodec_tpu_torch.data.dataset import collate_fn
from funcodec_tpu_torch.data.loader import PrefetchLoader
from funcodec_tpu_torch.data.sampler import (
    length_batches,
    shuffle_batches_for_epoch,
    sorted_batches,
    unsorted_batches,
)
from funcodec_tpu_torch.train.checkpoint import (
    load_train_state,
    save_train_state,
    save_weights,
    update_symlink,
)
from funcodec_tpu_torch.train.reporter import Reporter
from funcodec_tpu_torch.train.step import (
    GANTrainState,
    create_gan_train_state,
    make_gan_train_step,
    make_optimizer,
)


@dataclasses.dataclass
class TrainerOptions:
    """Mirrors the recipe training settings (encodec_16k_n32_600k_step.yaml:65-92)."""

    output_dir: str = "exp/codec"
    max_epoch: int = 60
    num_iters_per_epoch: Optional[int] = 10000
    batch_size: int = 16
    drop_last: bool = True
    seed: int = 0
    log_interval: int = 50
    keep_nbest_models: int = 60
    best_model_criterion: Tuple[str, str, str] = (
        "valid", "generator_multi_spectral_recon_loss", "min",
    )
    patience: Optional[int] = None
    resume: bool = True
    max_update: Optional[int] = None
    num_workers: int = 8
    save_ckpt_every_steps: Optional[int] = None
    gen_train_interval: int = 1
    disc_train_interval: int = 1
    optim: str = "adam"  # adam | adamw | fairseq_adam | lazy_adamw | sgd
    optim2: str = "adam"
    optim_conf: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"lr": 3e-4, "betas": (0.5, 0.9)}
    )
    optim2_conf: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"lr": 3e-4, "betas": (0.5, 0.9)}
    )
    grad_clip: float = -1.0
    disc_grad_clip: float = -1.0
    num_valid_dump_wavs: int = 5
    sampling_rate: int = 16000
    use_tensorboard: bool = True
    use_wandb: bool = False
    accum_grad: int = 1
    grad_noise: bool = False
    batch_type: str = "unsorted"  # unsorted | sorted | length
    batch_bins: int = 4_000_000  # for batch_type=length (samples per batch)
    # precomputed `uttid length` file (speech_shape, reference
    # abs_task.py:1177-1184) so sorted/length batching does not decode the
    # whole corpus before step 1
    train_shape_file: Optional[str] = None
    # torch.profiler trace over a window of steps (utils/profiling.py; the
    # reference's closest analog is thop --stat_flops + host phase timers)
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_num_steps: int = 5
    # "float32" (reference parity) or "bfloat16": mixed-precision training —
    # fp32 master params and optimizer moments, bf16 forward/backward
    # (train/step.py compute_dtype; the reference's AMP, trainer.py:213-227,
    # minus the loss scaling bf16 does not need)
    train_dtype: str = "float32"
    # One generator forward per step, its detached reconstruction into the
    # disc turn (train/step.py shared_train_step). Default ON for throughput;
    # false for the reference's two-forward step (the differences — one RVQ
    # EMA advance, a one-step-stale D in the adv loss — are documented at
    # make_gan_train_step)
    shared_forward: bool = True
    # Stage the training corpus on the card once and cut random crops there
    # (data/device_cache.py): a step uploads B row indices and B offsets
    # instead of B x crop samples. For corpora that fit in device memory;
    # crop-only preprocessing (no RIR/noise/per-crop normalization).
    # device_cache_crop is the crop length (speech_max_length).
    device_cache: bool = False
    device_cache_crop: int = -1
    # Fetch + register step stats every N iterations (1 = every step, exact
    # reference semantics). N>1 skips the device-to-host copy of the stats
    # in between, so steps queue on the card without a host sync; curves
    # sample every Nth step.
    stats_interval: int = 1


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The generator of one step's draws (quantizer dropout, k-means,
    expiry), on `device`, seeded from (seed, step): the counterpart of the
    JAX package's fold_in(rng, step), so the draws of step n do not depend
    on how the run got there."""
    return torch.Generator(device=device).manual_seed((int(seed) * 2**32 + int(step)) % 2**63)


def fetch_stats(stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar stats on the host in ONE device-to-host copy (a float() per
    stat would sync once per stat)."""
    names = list(stats)
    values = torch.stack([stats[k].detach().float() for k in names]).cpu()
    return dict(zip(names, values.tolist()))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GANCodecTrainer:
    """Trains `model` and `discriminator` (built by tasks/codec.py on the
    device they run on) with `options`."""

    def __init__(self, model, discriminator, options: TrainerOptions):
        self.model = model
        self.discriminator = discriminator
        self.opt = options
        self.device = next(model.parameters()).device
        self.reporter = Reporter()
        self._tb = None
        self._tracer = None
        # per-epoch walls of the loop's phases (train, valid, checkpoint) and
        # the training audio they covered
        self.epoch_walls: Dict[int, Dict[str, float]] = {}

        o = options
        self.optimizer_g = make_optimizer(
            lr=o.optim_conf.get("lr", 3e-4),
            betas=tuple(o.optim_conf.get("betas", o.optim_conf.get("adam_betas", (0.5, 0.9)))),
            eps=o.optim_conf.get("eps", o.optim_conf.get("adam_eps", 1e-8)),
            weight_decay=o.optim_conf.get("weight_decay", 0.0),
            grad_clip=o.grad_clip,
            accum_grad=o.accum_grad,
            grad_noise=o.grad_noise,
            name=o.optim,
            momentum=o.optim_conf.get("momentum", 0.0),
        )
        self.optimizer_d = make_optimizer(
            lr=o.optim2_conf.get("lr", 3e-4),
            betas=tuple(o.optim2_conf.get("betas", o.optim2_conf.get("adam_betas", (0.5, 0.9)))),
            eps=o.optim2_conf.get("eps", o.optim2_conf.get("adam_eps", 1e-8)),
            weight_decay=o.optim2_conf.get("weight_decay", 0.0),
            grad_clip=o.disc_grad_clip,
            accum_grad=o.accum_grad,
            name=o.optim2,
            momentum=o.optim2_conf.get("momentum", 0.0),
        )
        self._train_step = make_gan_train_step(
            model, discriminator, self.optimizer_g, self.optimizer_d,
            gen_train_interval=o.gen_train_interval,
            disc_train_interval=o.disc_train_interval,
            compute_dtype=(
                torch.bfloat16 if o.train_dtype in ("bfloat16", "bf16") else None
            ),
            shared_forward=o.shared_forward,
        )

    # -- setup ---------------------------------------------------------------

    def init_state(self) -> GANTrainState:
        """A fresh train state over the modules' current weights."""
        return create_gan_train_state(
            self.model, self.discriminator, self.optimizer_g, self.optimizer_d
        )

    def _to_device(self, a) -> torch.Tensor:
        """A host batch on the device; on a card through pinned memory
        without blocking, so it queues behind the steps already issued."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        if t.device == self.device:
            return t
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # -- loops ---------------------------------------------------------------

    def train_one_epoch(self, state, loader, epoch: int, seed: int) -> Tuple[Any, Dict]:
        sub = self.reporter.start_epoch("train")
        o = self.opt
        if self._tracer is None:
            from funcodec_tpu_torch.utils.profiling import StepTraceCapture

            self._tracer = StepTraceCapture(
                o.profile_dir, o.profile_start_step, o.profile_num_steps
            )
        host_step = int(state.step)
        si = max(1, o.stats_interval)
        # logging fires at the stats-fetch cadence, so a log_interval that si
        # does not divide would only fire at lcm(si, log_interval) — possibly
        # never within an epoch. Round it up to a multiple of si.
        log_interval = -(-o.log_interval // si) * si
        if log_interval != o.log_interval and not getattr(
            self, "_warned_log_interval", False
        ):
            logging.warning(
                "log_interval %d rounded up to %d (multiple of "
                "stats_interval %d)", o.log_interval, log_interval, si,
            )
            self._warned_log_interval = True
        t_start = t_last = time.time()
        samples = 0
        for i, (keys, batch) in enumerate(loader):
            self._tracer.tick(host_step)
            t_data = time.time()
            speech = self._to_device(batch["speech"])
            samples += speech.numel()
            state, stats = self._train_step(
                state, {"speech": speech}, step_generator(self.device, seed, host_step)
            )
            host_step += 1
            # host-side controls run every step (not at the stats cadence),
            # on the host-mirrored step count
            if o.save_ckpt_every_steps and host_step % o.save_ckpt_every_steps == 0:
                self._save_step_checkpoint(state)
            if o.max_update is not None and host_step >= o.max_update:
                logging.info("reached max_update=%d", o.max_update)
                break
            if (i + 1) % si != 0:
                continue  # no host sync: the next steps queue behind this one
            # the fetch syncs with the card, so step_time is wall-per-step
            # averaged over the stats_interval window
            host_stats = fetch_stats(stats)
            now = time.time()
            host_stats["iter_time"] = (now - t_last) / si
            host_stats["step_time"] = (
                (now - t_data) if si == 1 else (now - t_last) / si
            )
            t_last = now
            sub.register(host_stats, weight=batch["speech"].shape[0])
            if (i + 1) % log_interval == 0:
                logging.info(sub.log_message())
        self._tracer.stop()
        _sync(self.device)
        walls = self.epoch_walls.setdefault(epoch, {})
        walls["train_s"] = time.time() - t_start
        walls["train_audio_s"] = samples / float(o.sampling_rate)
        self.reporter.finish_epoch(sub)
        return state, sub.to_dict()

    def validate(self, state, loader, epoch: int, seed: int) -> Dict[str, float]:
        """Eval forwards on the fp32 masters (no cast to the compute dtype),
        as the JAX package's valid_step: the generator's losses and, on its
        reconstruction, the discriminator's; a few real/fake pairs dumped
        and scored with the quality metrics."""
        from funcodec_tpu_torch.data.wav_io import save_audio
        from funcodec_tpu_torch.utils.quality import reconstruction_metrics

        t0 = time.time()
        sub = self.reporter.start_epoch("valid")
        model, disc = state.model, state.discriminator
        dumped = 0
        out_dir = Path(self.opt.output_dir) / "valid_wavs" / f"epoch{epoch}"
        with torch.inference_mode():
            zero = torch.zeros((), device=self.device)
            for vi, (keys, batch) in enumerate(loader):
                speech = self._to_device(batch["speech"])
                _, gout = model.forward_generator(
                    disc, speech, step_generator(self.device, seed, vi), training=False
                )
                fake = gout["fake"]
                # the eval reconstruction is deterministic: one encode ->
                # RVQ -> decode serves both turns' stats
                _, dout = model._discriminator_losses(
                    disc, speech.to(fake.dtype), fake, zero, training=False,
                    generator=step_generator(self.device, seed, vi),
                )
                sub.register(
                    fetch_stats({**gout["stats"], **dout["stats"]}),
                    weight=speech.shape[0],
                )
                # dump a few real/fake pairs per epoch (gan_trainer.py:482-495)
                # and score them (the recipe's ViSQOL role, run.sh:249-295)
                if dumped < self.opt.num_valid_dump_wavs:
                    out_dir.mkdir(parents=True, exist_ok=True)
                    fake_np = fake.float().cpu().numpy()
                    real_np = np.asarray(batch["speech"], np.float32)
                    for b, key in enumerate(keys):
                        if dumped >= self.opt.num_valid_dump_wavs:
                            break
                        save_audio(
                            real_np[b], out_dir / f"{key}_real.wav",
                            self.opt.sampling_rate, rescale=True,
                        )
                        save_audio(
                            fake_np[b], out_dir / f"{key}_fake.wav",
                            self.opt.sampling_rate, rescale=True,
                        )
                        q = reconstruction_metrics(
                            real_np[b], fake_np[b], sr=self.opt.sampling_rate
                        )
                        sub.register(q, weight=1)
                        dumped += 1
        self.reporter.finish_epoch(sub)
        self.epoch_walls.setdefault(epoch, {})["valid_s"] = time.time() - t0
        return sub.to_dict()

    # -- checkpointing -------------------------------------------------------

    def _tb_writer(self):
        """Optional TensorBoard emission (reporter.py:499-534 role)."""
        if not self.opt.use_tensorboard:
            return None
        if self._tb is None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(Path(self.opt.output_dir) / "tensorboard"))
            except Exception:
                self.opt.use_tensorboard = False
                return None
        return self._tb

    def _emit_tb(self, epoch: int) -> None:
        tb = self._tb_writer()
        if tb is not None:
            for phase, stats in self.reporter.stats.get(epoch, {}).items():
                for k, v in stats.items():
                    tb.add_scalar(f"{phase}/{k}", v, epoch)
            tb.flush()
        # optional wandb emission (reporter.py:519-534 role); a silent no-op
        # where the package is absent
        if getattr(self.opt, "use_wandb", False):
            try:
                import wandb  # type: ignore

                if wandb.run is None:
                    wandb.init(project="funcodec_tpu_torch",
                               dir=self.opt.output_dir, resume="allow")
                flat = {
                    f"{phase}/{k}": v
                    for phase, stats in self.reporter.stats.get(epoch, {}).items()
                    for k, v in stats.items()
                }
                wandb.log(flat, step=epoch)
            except ImportError:
                pass

    def _ckpt_dir(self) -> Path:
        p = Path(self.opt.output_dir)
        p.mkdir(parents=True, exist_ok=True)
        return p

    def _save_step_checkpoint(self, state):
        path = self._ckpt_dir() / f"{int(state.step)}steps.pth"
        save_train_state(str(path), state)

    def _save_epoch(self, state, epoch: int) -> None:
        d = self._ckpt_dir()
        t0 = time.time()
        save_train_state(str(d / "checkpoint.pth"), state)
        walls = self.epoch_walls.setdefault(epoch, {})
        walls["checkpoint_s"] = time.time() - t0
        walls["checkpoint_bytes"] = float(os.path.getsize(d / "checkpoint.pth"))
        weights_path = d / f"{epoch}epoch.pth"
        save_weights(str(weights_path), state.model)
        update_symlink(str(weights_path), str(d / "latest.pth"))
        with open(d / "reporter.json", "w") as f:
            json.dump(self.reporter.state_dict(), f)

        phase, key, mode = self.opt.best_model_criterion
        if self.reporter.has(phase, key, epoch):
            best = self.reporter.best_epoch(phase, key, mode)
            if best == epoch:
                update_symlink(
                    str(weights_path), str(d / f"{phase}.{key}.best.pth")
                )
        # n-best pruning (trainer.py:403-509)
        order = self.reporter.sort_epochs(phase, key, mode)
        keep = set(order[: self.opt.keep_nbest_models])
        keep.add(epoch)
        for p in d.glob("*epoch.pth"):
            e = int(p.name.replace("epoch.pth", ""))
            if e not in keep:
                p.unlink()

    def resume(self, state_template) -> Tuple[Any, int]:
        d = self._ckpt_dir()
        ckpt = d / "checkpoint.pth"
        start_epoch = 1
        state = state_template
        if self.opt.resume and ckpt.exists():
            state = load_train_state(str(ckpt), state_template)
            rep_file = d / "reporter.json"
            if rep_file.exists():
                with open(rep_file) as f:
                    self.reporter.load_state_dict(json.load(f))
                start_epoch = self.reporter.epoch + 1
            logging.info("resumed from %s at epoch %d", ckpt, start_epoch)
        return state, start_epoch

    # -- entry ---------------------------------------------------------------

    def run(
        self,
        state: GANTrainState,
        train_dataset,
        valid_dataset,
        seed: Optional[int] = None,
    ) -> GANTrainState:
        o = self.opt
        seed = o.seed if seed is None else seed
        state, start_epoch = self.resume(state)

        train_ids = list(train_dataset.uttids)
        valid_ids = list(valid_dataset.uttids)
        phase, key, mode = o.best_model_criterion

        def make_batches(ids, dataset):
            if o.batch_type == "unsorted":
                return unsorted_batches(ids, o.batch_size, o.drop_last)
            # sorted/length need utterance lengths (speech_shape role,
            # samplers/build_batch_sampler.py:78-168). Prefer the precomputed
            # shape file (reference loads it at abs_task.py:1309); decoding
            # audio only for ids the file is missing.
            lengths = {}
            if o.train_shape_file:
                with open(o.train_shape_file) as f:
                    for line in f:
                        parts = line.split()
                        if len(parts) >= 2:
                            # "uttid T" or "uttid T,D" (csv shape)
                            lengths[parts[0]] = int(parts[1].split(",")[0])
                lengths = {u: lengths[u] for u in ids if u in lengths}
            for u in ids:
                if u in lengths:
                    continue
                _, data = dataset[u]
                lengths[u] = int(np.asarray(data["speech"]).shape[0])
            if o.batch_type == "sorted":
                return sorted_batches(ids, lengths, o.batch_size, o.drop_last)
            if o.batch_type == "length":
                return length_batches(ids, lengths, o.batch_bins)
            raise ValueError(f"unknown batch_type {o.batch_type}")

        train_batches_base = make_batches(train_ids, train_dataset)

        device_cache = None
        if o.device_cache:
            if getattr(train_dataset, "preprocess", None) is not None:
                p = train_dataset.preprocess
                if getattr(p, "rirs", None) or getattr(p, "noises", None) or \
                        getattr(p, "speech_volume_normalize", None) or \
                        getattr(p, "speech_rms_normalize", False):
                    raise ValueError(
                        "device_cache supports crop-only preprocessing; "
                        "RIR/noise/normalization are per-crop host transforms"
                    )
            from funcodec_tpu_torch.data.device_cache import DeviceCachedCrops

            device_cache = DeviceCachedCrops(
                train_dataset, train_ids, crop_len=o.device_cache_crop,
                seed=o.seed, device=self.device,
            )
            logging.info(
                "device cache: %d utts staged on %s (%.1f MB, t_max=%d, "
                "padding overhead %.2fx), crop=%d on the device", len(train_ids),
                self.device, device_cache.nbytes() / 1e6, device_cache.t_max,
                device_cache.padding_overhead, o.device_cache_crop,
            )

        for epoch in range(start_epoch, o.max_epoch + 1):
            self.reporter.set_epoch(epoch)
            batches = list(train_batches_base)
            batches = shuffle_batches_for_epoch(batches, o.seed, epoch)
            if o.num_iters_per_epoch:
                reps = -(-o.num_iters_per_epoch // max(len(batches), 1))
                batches = (batches * reps)[: o.num_iters_per_epoch]
            if device_cache is not None:
                loader = device_cache.epoch_loader(batches, epoch)
            else:
                loader = PrefetchLoader(
                    train_dataset, batches, collate_fn, num_workers=o.num_workers
                )
            state, train_stats = self.train_one_epoch(state, loader, epoch, seed)

            v_batches = unsorted_batches(valid_ids, o.batch_size, drop_last=False)
            v_loader = PrefetchLoader(
                valid_dataset, v_batches, collate_fn, num_workers=o.num_workers
            )
            self.validate(state, v_loader, epoch, seed)
            self._save_epoch(state, epoch)
            self._emit_tb(epoch)
            keys_of_interest = (
                "generator_loss", "generator_recon_loss",
                "generator_multi_spectral_recon_loss", "discriminator_loss",
            )
            valid_stats = self.reporter.stats[epoch].get("valid", {})
            logging.info(
                "epoch %d done: train=%s valid=%s", epoch,
                {k: round(train_stats[k], 4) for k in keys_of_interest if k in train_stats},
                {k: round(valid_stats[k], 4) for k in keys_of_interest if k in valid_stats},
            )
            if o.patience is not None and self.reporter.check_early_stopping(
                o.patience, phase, key, mode
            ):
                logging.info("early stopping at epoch %d", epoch)
                break
            if o.max_update is not None and int(state.step) >= o.max_update:
                break
        return state
