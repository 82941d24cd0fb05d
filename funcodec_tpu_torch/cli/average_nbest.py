"""Average the n best epoch checkpoints into one weights file (port of
funcodec_tpu/cli/average_nbest.py).

Behavioral reference: funcodec/util_funcs/average_nbest_models.py:18 (n-best
weight averaging ranked by the reporter's per-epoch stats). It reads the
training directory's reporter.json and ``{epoch}epoch.pth`` files (the
port's generator state_dicts), averages the parameters through
train/checkpoint.average_checkpoints (fp64 mean, the codebook buffers of
the best epoch) and writes ``{phase}.{key}.ave_{n}best.pth``, which
cli/codec_inference serves. Host-only: no device is touched.

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
                        help="training output dir (reporter.json + {epoch}epoch.pth)")
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
    from funcodec_tpu_torch.train.checkpoint import average_checkpoints
    from funcodec_tpu_torch.train.reporter import Reporter

    exp = Path(args.exp_dir)
    config = load_config(args.config or str(exp / "config.yaml"))
    # the parameter names only: built on the host, never run
    model, _ = build_codec_model(config, device="cpu")

    reporter = Reporter()
    reporter.load_state_dict(json.loads((exp / "reporter.json").read_text()))
    if args.criterion:
        phase, key, mode = args.criterion.rsplit(".", 2)
    else:
        phase, key, mode = "valid", "generator_multi_spectral_recon_loss", "min"
    order = reporter.sort_epochs(phase, key, mode)[: args.nbest]
    epochs = [e for e in order if (exp / f"{e}epoch.pth").exists()]
    if not epochs:
        raise SystemExit("no epoch checkpoints found for the requested criterion")
    logging.info("averaging %d checkpoints: epochs %s", len(epochs), epochs)
    avg = average_checkpoints([str(exp / f"{e}epoch.pth") for e in epochs], model)
    out = args.output or str(exp / f"{phase}.{key}.ave_{len(epochs)}best.pth")
    torch.save(avg, out)
    logging.info("wrote %s", out)
    return out


if __name__ == "__main__":
    main()
