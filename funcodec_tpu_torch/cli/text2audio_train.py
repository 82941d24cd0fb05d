"""LauraTTS training CLI: (text, codec tokens) -> codec language model (port
of funcodec_tpu/cli/text2audio_train.py).

Behavioral reference: funcodec/bin/text2audio_train.py + Text2AudioGenTask
(tasks/text2audio_generation.py) and the LibriTTS recipe's stage 2
(egs/LibriTTS/text2speech_laura/run.sh), with its
`--init_param codec.pth:quantizer.rq.model:quantizer_codebook` codebook graft.

One process trains on one device, the card unless ``--device cpu`` asks for
the CPU (a CUDA device without a card raises):

    python -m funcodec_tpu_torch.cli.text2audio_train --config laura.yaml \\
        --output_dir exp/laura --train_text train/text \\
        --train_codec tokens_train/indices.scp --valid_text dev/text \\
        --valid_codec tokens_dev/indices.scp --token_list tokens.txt \\
        --token_type word --codec_init_param codec/model.pth

It writes {epoch}epoch.pth (the model's state_dict), checkpoint.pth, the
latest.pth and valid.loss.best.pth links and reporter.json;
cli/text2audio_inference serves latest.pth. Run again with a higher
--max_epoch, it resumes: from its own checkpoint.pth, or, in an output
directory of the JAX package's trainer, from that run's checkpoint.ckpt and
reporter.json (train/laura_trainer.py). --codec_init_param also takes the
JAX package's codec .ckpt, with --codec_config.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import yaml

from funcodec_tpu_torch.compat.from_jax import load_torch_state_dict
from funcodec_tpu_torch.data.dataset import CodecDataset, collate_fn
from funcodec_tpu_torch.data.loader import PrefetchLoader
from funcodec_tpu_torch.data.sampler import length_batches, shuffle_batches_for_epoch
from funcodec_tpu_torch.data.text import Text2AudioPreprocessor
from funcodec_tpu_torch.tasks.codec import build_codec_model, load_config, resolve_device
from funcodec_tpu_torch.tasks.text2audio import build_laura_model
from funcodec_tpu_torch.train.checkpoint import is_torch_file, load_jax_checkpoint_params
from funcodec_tpu_torch.train.laura_trainer import LauraTrainer, LauraTrainerOptions

CODEBOOK = "quantizer.rq.model.embed"  # the codec's RVQ codebooks (nq, bins, dim)


def graft_codebooks(model, codec_model_file: str, codec_config_file: Optional[str] = None):
    """Copy a codec checkpoint's codebooks into the model's frozen
    ``quantizer_codebook`` (the first nq x bins x dim of them). The file is
    a PyTorch state_dict (.pth, .pt, .bin: a released codec's model.pth,
    the port's codec trainer's latest.pth) or the JAX package's .ckpt (its
    codec trainer's latest.ckpt), which loads into the codec of its config:
    `codec_config_file`, else the config.yaml beside the file, as the JAX
    CLI takes it. Returns the model."""
    if is_torch_file(codec_model_file):
        embed = load_torch_state_dict(codec_model_file)[CODEBOOK]
    else:
        cfg_path = codec_config_file or str(Path(codec_model_file).parent / "config.yaml")
        codec, _ = build_codec_model(load_config(cfg_path), device="cpu")
        embed = load_jax_checkpoint_params(codec_model_file, codec)[CODEBOOK]
    dst = model.quantizer_codebook.embed
    nq, bins, dim = dst.shape
    with torch.no_grad():
        dst.copy_(embed[:nq, :bins, :dim])
    return model


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="LauraTTS training on one CUDA card (or the CPU)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--train_text", type=str, required=True,
                        help="text file/scp: uttid <tokens or raw text>")
    parser.add_argument("--train_codec", type=str, required=True,
                        help="codec scp: kaldi ark scp of (T, n_q) token matrices")
    parser.add_argument("--valid_text", type=str, required=True)
    parser.add_argument("--valid_codec", type=str, required=True)
    parser.add_argument("--token_list", type=str, default=None)
    parser.add_argument("--token_type", type=str, default=None)
    parser.add_argument("--codec_init_param", type=str, default=None,
                        help="codec checkpoint whose quantizer codebooks are grafted")
    parser.add_argument("--codec_config", type=str, default=None,
                        help="the codec's config.yaml for a .ckpt codec_init_param (default: the "
                             "config.yaml beside it); a .pth needs none")
    parser.add_argument("--resume", type=lambda s: s.lower() == "true", default=True)
    parser.add_argument("--max_epoch", type=int, default=None)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="capture a torch.profiler trace of a few steps into this directory "
                             "(utils/profiling.py)")
    parser.add_argument("--train_dtype", type=str, default=None, choices=["float32", "bfloat16", "bf16"],
                        help="bfloat16 = mixed-precision training: fp32 master params, bf16 forward/backward")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda; 'cpu' for the CPU)")
    return parser


def options_from_config(args, config) -> LauraTrainerOptions:
    return LauraTrainerOptions(
        output_dir=args.output_dir,
        max_epoch=config.get("max_epoch", 50),
        num_iters_per_epoch=config.get("num_iters_per_epoch"),
        batch_bins=config.get("batch_bins", 10240),
        seed=config.get("seed", 0),
        log_interval=config.get("log_interval", 50),
        keep_nbest_models=config.get("keep_nbest_models", 50),
        best_model_criterion=tuple(config.get("best_model_criterion", [["valid", "loss", "min"]])[0]),
        patience=config.get("patience"),
        resume=args.resume,
        grad_clip=config.get("grad_clip", 5),
        optim=config.get("optim", "adam"),
        optim_conf=config.get("optim_conf", {"lr": 1e-3}),
        scheduler=config.get("scheduler", "warmuplr"),
        scheduler_conf=config.get("scheduler_conf", {"warmup_steps": 10000}),
        num_workers=config.get("num_workers", 8),
        accum_grad=config.get("accum_grad", 1),
        profile_dir=args.profile_dir,
        train_dtype=args.train_dtype or config.get("train_dtype", "float32"),
    )


def main(argv=None):
    """Train as the command line says. Returns (trainer, final train state)."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    with open(args.config) as f:
        config = yaml.safe_load(f)
    if args.max_epoch is not None:
        config["max_epoch"] = args.max_epoch

    token_list = None
    if args.token_list:
        with open(args.token_list, encoding="utf-8") as f:
            token_list = [line.strip() for line in f if line.strip()]

    device = resolve_device(args.device)
    options = options_from_config(args, config)
    model = build_laura_model(config, token_list=token_list, device=device,
                              generator=torch.Generator(device=device).manual_seed(options.seed))
    if args.codec_init_param:
        graft_codebooks(model, args.codec_init_param, args.codec_config)

    def make_pre(train):
        return Text2AudioPreprocessor(
            train=train,
            audio_max_duration=config.get("audio_max_duration", 30),
            codec_token_rate=config.get("codec_token_rate", 25),
            token_list=token_list,
            token_type=args.token_type,
        )

    text_type = "text" if args.token_type else "text_int"
    train_ds = CodecDataset([(args.train_text, "text", text_type), (args.train_codec, "codec", "kaldi_ark")],
                            preprocess=make_pre(True))
    valid_ds = CodecDataset([(args.valid_text, "text", text_type), (args.valid_codec, "codec", "kaldi_ark")],
                            preprocess=make_pre(False))
    logging.info("train=%d valid=%d utts; %d parameters on %s", len(train_ds), len(valid_ds),
                 sum(p.numel() for p in model.parameters()), device)

    def utt_lengths(ds):
        """batch_bins lengths: codec frames + text tokens."""
        lens = {}
        for u in ds.uttids:
            _, data = ds[u]
            lens[u] = int(np.asarray(data["codec"]).shape[0]) + len(np.atleast_1d(data["text"]))
        return lens

    base_train = length_batches(train_ds.uttids, utt_lengths(train_ds), options.batch_bins)
    base_valid = length_batches(valid_ds.uttids, utt_lengths(valid_ds), options.batch_bins)

    def loader(ds, base, epoch, shuffle):
        batches = shuffle_batches_for_epoch(base, options.seed, epoch, shuffle)
        return PrefetchLoader(ds, batches, lambda items: collate_fn(items, int_pad_value=-1),
                              num_workers=options.num_workers)

    trainer = LauraTrainer(model, options)
    state = trainer.run(trainer.init_state(), lambda e: loader(train_ds, base_train, e, True),
                        lambda e: loader(valid_ds, base_valid, e, False))
    return trainer, state


if __name__ == "__main__":
    main()
