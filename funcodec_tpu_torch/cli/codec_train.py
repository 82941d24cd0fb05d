"""Codec training CLI: config.yaml + wav.scp -> trained checkpoints (port of
funcodec_tpu/cli/codec_train.py).

Behavioral reference: funcodec/bin/codec_train.py:9-48 +
GANSpeechCodecTask.main_worker (tasks/abs_task.py:1152-1442): build model
from config, dump the resolved config.yaml (round-trip contract), train.

Data-parallel training, one process per card (the reference forks one
process per GPU; the JAX package drives all local chips through a "data"
mesh). The world size is the largest count of the visible cards, or of
``--data_parallel`` processes, that divides the batch (``make_mesh``'s
rule); each rank trains on its block of every batch (train/gan_trainer.py).
On the card unless ``--device cpu`` asks for the CPU (a CUDA device without
a card raises; there is no fallback):

    python -m funcodec_tpu_torch.cli.codec_train --config conf.yaml \\
        --output_dir exp/ --train_wav_scp train/wav.scp \\
        --valid_wav_scp dev/wav.scp [--train_dtype bfloat16]

Started plainly it spawns one process per rank on this host (NCCL over the
cards; gloo with ``--device cpu --data_parallel N``). Under ``torchrun`` (its
environment: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR) each process joins
as its rank on cuda:LOCAL_RANK, which is also how several hosts train:

    torchrun --nproc_per_node 8 -m funcodec_tpu_torch.cli.codec_train ...

It writes {epoch}epoch.pth weights, checkpoint.pth (the resumable train
state), the latest.pth and valid.<key>.best.pth links, reporter.json and
validation wav dumps (rank 0 alone); run again with a higher --max_epoch,
it resumes. Given the output directory of the JAX package's trainer
(checkpoint.ckpt, reporter.json, no checkpoint.pth), it continues that
run: the step, the epoch, both modules and the Adam moments come from the
JAX files, and the port's files are written beside them.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path
from typing import Optional

import torch

from funcodec_tpu_torch.data.dataset import CodecDataset
from funcodec_tpu_torch.data.preprocessor import CodecPreprocessor
from funcodec_tpu_torch.parallel.dist import (
    DataGroup,
    data_world_size,
    destroy_process_group,
    file_init_method,
    init_process_group,
    is_writer,
    spawn_ranks,
)
from funcodec_tpu_torch.tasks.codec import build_codec_model, load_config, resolve_device
from funcodec_tpu_torch.train.gan_trainer import GANCodecTrainer, TrainerOptions
from funcodec_tpu_torch.utils.misc import codec_flops_tree, model_summary


def build_datasets(args, config):
    preprocess = None
    if config.get("use_preprocessor", True):
        preprocess = CodecPreprocessor(
            train=True,
            speech_max_length=config.get("speech_max_length", -1),
            rir_scp=config.get("rir_scp"),
            noise_scp=config.get("noise_scp"),
        )
    valid_preprocess = CodecPreprocessor(
        train=False,
        speech_max_length=config.get("valid_max_length", config.get("speech_max_length", -1)),
    )
    train = CodecDataset(
        [(args.train_wav_scp, "speech", "sound")], preprocess=preprocess
    )
    valid = CodecDataset(
        [(args.valid_wav_scp, "speech", "sound")], preprocess=valid_preprocess
    )
    return train, valid


def options_from_config(args, config) -> TrainerOptions:
    """TrainerOptions from the resolved config and the command line."""
    return TrainerOptions(
        output_dir=args.output_dir,
        max_epoch=config.get("max_epoch", 60),
        num_iters_per_epoch=config.get("num_iters_per_epoch"),
        batch_size=config.get("batch_size", 16),
        drop_last=config.get("drop_last", True),
        seed=config.get("seed", 0),
        log_interval=config.get("log_interval", 50),
        keep_nbest_models=config.get("keep_nbest_models", 60),
        best_model_criterion=tuple(config.get(
            "best_model_criterion",
            [["valid", "generator_multi_spectral_recon_loss", "min"]],
        )[0]),
        patience=config.get("patience"),
        resume=args.resume,
        max_update=config.get("max_update"),
        num_workers=config.get("num_workers", 8),
        gen_train_interval=config.get("gen_train_interval", 1),
        disc_train_interval=config.get("disc_train_interval", 1),
        optim=config.get("optim", "adam"),
        optim2=config.get("optim2", config.get("optim", "adam")),
        optim_conf=config.get("optim_conf", {}),
        optim2_conf=config.get("optim2_conf", {}),
        grad_clip=config.get("grad_clip", -1),
        disc_grad_clip=config.get("disc_grad_clip", -1),
        sampling_rate=config.get("sampling_rate", 16000),
        accum_grad=config.get("accum_grad", 1),
        grad_noise=config.get("grad_noise", False),
        batch_type=config.get("batch_type", "unsorted"),
        batch_bins=config.get("batch_bins", 4_000_000),
        shared_forward=config.get("shared_forward", True),
        num_valid_dump_wavs=config.get("num_valid_dump_wavs", 5),
        train_shape_file=args.train_shape_file or config.get("train_shape_file"),
        profile_dir=args.profile_dir,
        # "bfloat16" = mixed-precision training (fp32 masters, bf16 compute);
        # the reference's train_dtype/AMP knob (abs_task.py --train_dtype)
        train_dtype=args.train_dtype or config.get("train_dtype", "float32"),
        # device-resident corpus cache: crops cut on the card, a step uploads
        # row indices + offsets (data/device_cache.py)
        device_cache=config.get("device_cache", False),
        device_cache_crop=config.get("speech_max_length", -1),
        stats_interval=config.get("stats_interval", 1),
        # the reference's --use_tensorboard / --use_wandb; silent without the package
        use_tensorboard=config.get("use_tensorboard", True),
        use_wandb=config.get("use_wandb", False),
    )


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="data-parallel codec training, one process per CUDA card (or gloo processes on the CPU)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--train_wav_scp", type=str, required=True)
    parser.add_argument("--train_shape_file", type=str, default=None,
                        help="precomputed 'uttid length' file for sorted/length "
                             "batching (abs_task.py:710, speech_shape)")
    parser.add_argument("--valid_wav_scp", type=str, required=True)
    parser.add_argument("--resume", type=lambda s: s.lower() == "true", default=True)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--max_epoch", type=int, default=None)
    parser.add_argument("--num_iters_per_epoch", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--print_config", action="store_true",
                        help="dump the resolved config yaml and exit (abs_task.py:1108)")
    parser.add_argument("--dry_run", action="store_true",
                        help="build everything, run zero steps (abs_task.py:1299)")
    parser.add_argument("--stat_flops", action="store_true",
                        help="log the per-layer FLOPs/params tree of the serving path at "
                             "speech_max_length samples (gan_speech_codec.py:345-355)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="capture a torch.profiler trace of a few steps "
                             "into this directory (utils/profiling.py)")
    parser.add_argument("--train_dtype", type=str, default=None,
                        choices=["float32", "bfloat16", "bf16"],
                        help="bfloat16 = mixed-precision training: fp32 master "
                             "params, bf16 forward/backward (train/step.py)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda; 'cpu' for the CPU)")
    parser.add_argument("--data_parallel", type=int, default=-1,
                        help="the most processes to train in (-1: every visible card; one on the CPU); "
                             "the world size is the largest count up to it that divides the batch")
    return parser


def _resolved(argv):
    """(args, config): the command line and the config with its overrides."""
    args = get_parser().parse_args(argv)
    config = load_config(args.config)
    for field in ("seed", "max_epoch", "num_iters_per_epoch", "batch_size"):
        v = getattr(args, field)
        if v is not None:
            config[field] = v
    return args, config


def _logging(group: Optional[DataGroup]) -> None:
    rank = "" if group is None else f"[rank {group.rank}/{group.world}] "
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s {rank}(%(module)s:%(lineno)d) %(levelname)s: %(message)s",
    )


def world_size(batch_size: int, device: torch.device, data_parallel: int) -> int:
    """make_mesh's rule: the largest process count up to the visible cards
    (on the CPU: one) and up to `data_parallel` (-1: no cap) that divides
    the batch."""
    visible = torch.cuda.device_count() if device.type == "cuda" else None
    if data_parallel is None or data_parallel < 0:
        cap = visible or 1
    else:
        cap = max(1, min(data_parallel, visible) if visible is not None else data_parallel)
    return data_world_size(batch_size, cap)


def main(argv=None):
    """Train as the command line says. One process (world 1): returns
    (trainer, train state) after training, or as built with --dry_run.
    Several: under torchrun, this rank's (trainer, state); started plainly,
    it spawns the ranks, waits for them and returns None. None with
    --print_config."""
    args, config = _resolved(argv)
    if args.print_config:
        import sys

        import yaml

        yaml.safe_dump(config, sys.stdout)
        return None
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:  # torchrun
        group = init_process_group(None if args.device == "cuda" else args.device)
        try:
            return train(args, config, group)
        finally:
            destroy_process_group(group)
    world = world_size(config.get("batch_size", 16), torch.device(args.device), args.data_parallel)
    if world == 1:
        return train(args, config, None)
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    spawn_ranks(_rank_main, world, (argv, file_init_method(args.output_dir), torch.get_num_threads()))
    return None


def _rank_main(rank: int, world: int, argv, init_method: str, host_threads: int) -> None:
    """One spawned rank: cuda:rank (NCCL), or the CPU (gloo) with the host's
    threads split over the ranks."""
    args, config = _resolved(argv)
    if args.device == "cpu":
        device = torch.device("cpu")
        torch.set_num_threads(max(1, host_threads // world))
    else:
        device = torch.device("cuda", rank)
    group = init_process_group(device, init_method=init_method, world_size=world, rank=rank)
    try:
        train(args, config, group)
    finally:
        destroy_process_group(group)


def train(args, config, group: Optional[DataGroup]):
    """Build the model, the data and the trainer on this rank's device and
    train (or stop after building, with --dry_run). Returns (trainer, state)."""
    _logging(group)
    device = group.device if group is not None else resolve_device(args.device)
    options = options_from_config(args, config)
    model, discriminator = build_codec_model(
        config, device=device, generator=torch.Generator(device=device).manual_seed(options.seed)
    )

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    if is_writer(group):
        # config round-trip: the dumped file reconstructs the model at
        # inference (abs_task.py:1282-1297)
        import yaml

        with open(out / "config.yaml", "w") as f:
            yaml.safe_dump(config, f)

    train_ds, valid_ds = build_datasets(args, config)
    logging.info("train: %d utts, valid: %d utts", len(train_ds), len(valid_ds))

    trainer = GANCodecTrainer(model, discriminator, options, group=group)
    state = trainer.init_state()
    logging.info(
        "generator: %d parameters, discriminator: %d, on %s%s",
        sum(p.numel() for p in model.parameters()),
        sum(p.numel() for p in discriminator.parameters()), device,
        "" if group is None else f", data-parallel rank {group.rank} of {group.world} ({group.backend})",
    )
    logging.info(model_summary(model, "generator"))
    if args.stat_flops:
        logging.info("\n%s", codec_flops_tree(model, samples=config.get("speech_max_length", 16000)))
    if args.dry_run:
        logging.info("--dry_run: model and data built, exiting before training")
        return trainer, state
    return trainer, trainer.run(state, train_ds, valid_ds)


if __name__ == "__main__":
    main()
