"""Average the n best epoch checkpoints into one weights file (port of
funcodec_tpu/cli/average_nbest.py).

Behavioral reference: funcodec/util_funcs/average_nbest_models.py:18 (n-best
weight averaging ranked by the reporter's per-epoch stats). It reads the
training directory's reporter.json and the chosen epochs' weights files:

- ``{epoch}epoch.pth`` (the port's generator state_dicts): averaged by
  train/checkpoint.average_checkpoints (fp64 mean, the codebook buffers of
  the best epoch) into ``{phase}.{key}.ave_{n}best.pth``;
- ``{epoch}epoch.ckpt`` (the JAX package's trainer's): averaged by
  train/checkpoint.average_jax_checkpoints into
  ``{phase}.{key}.ave_{n}best.ckpt``, byte for byte the file that
  funcodec_tpu/cli/average_nbest.py writes from them.

The kind that every chosen epoch has is averaged (the .pth where each has
both); chosen epochs that no one kind covers (a JAX run resumed by the
port: its early epochs .ckpt, its later ones .pth) are refused.
cli/codec_inference serves either output. Host-only: no device is touched.

    python -m funcodec_tpu_torch.cli.average_nbest --exp_dir exp/codec --nbest 5
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import torch


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="n-best checkpoint averaging")
    parser.add_argument("--exp_dir", type=str, required=True,
                        help="training output dir (reporter.json + {epoch}epoch.pth or {epoch}epoch.ckpt)")
    parser.add_argument("--config", type=str, default=None,
                        help="config.yaml (defaults to exp_dir/config.yaml)")
    parser.add_argument("--nbest", type=int, default=10)
    parser.add_argument("--criterion", type=str, default=None,
                        help="phase.key.mode, e.g. valid.loss.min "
                             "(default valid.generator_multi_spectral_recon_loss.min)")
    parser.add_argument("--output", type=str, default=None)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from funcodec_tpu_torch.tasks.codec import build_codec_model, load_config
    from funcodec_tpu_torch.train.checkpoint import average_checkpoints, average_jax_checkpoints, save_jax_tree
    from funcodec_tpu_torch.train.reporter import Reporter

    exp = Path(args.exp_dir)
    config = load_config(args.config or str(exp / "config.yaml"))
    # the parameter names (and the JAX files' check) only: built on the host, never run
    model, _ = build_codec_model(config, device="cpu")

    reporter = Reporter()
    reporter.load_state_dict(json.loads((exp / "reporter.json").read_text()))
    if args.criterion:
        phase, key, mode = args.criterion.rsplit(".", 2)
    else:
        phase, key, mode = "valid", "generator_multi_spectral_recon_loss", "min"
    order = reporter.sort_epochs(phase, key, mode)[: args.nbest]
    kinds = {e: [s for s in (".pth", ".ckpt") if (exp / f"{e}epoch{s}").exists()] for e in order}
    epochs = [e for e in order if kinds[e]]
    if not epochs:
        raise SystemExit("no epoch checkpoints found for the requested criterion")
    common = [s for s in (".pth", ".ckpt") if all(s in kinds[e] for e in epochs)]
    if not common:
        raise SystemExit(f"{exp}: the chosen epochs' weights files are of both kinds, .pth and .ckpt "
                         f"({ {e: kinds[e] for e in epochs} }): no one kind holds them all")
    suffix = common[0]  # the port's own where every chosen epoch has both
    logging.info("averaging %d checkpoints (%s): epochs %s", len(epochs), suffix, epochs)
    paths = [str(exp / f"{e}epoch{suffix}") for e in epochs]
    out = args.output or str(exp / f"{phase}.{key}.ave_{len(epochs)}best{suffix}")
    if suffix == ".ckpt":
        save_jax_tree(out, average_jax_checkpoints(paths, model))
    else:
        torch.save(average_checkpoints(paths, model), out)
    logging.info("wrote %s", out)
    return out


if __name__ == "__main__":
    main()
