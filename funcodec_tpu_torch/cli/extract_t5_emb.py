"""Extract T5 text embeddings for text2music training (port of funcodec_tpu/cli/extract_t5_emb.py).

Behavioral reference: egs/jamendo/text2music_laura/scripts/extract_t5_emb.py:
tag text -> T5 encoder hidden states, written as a Kaldi ark/scp that the
Laura model reads with text_encoder=None (embedding inputs, input_size 1536
for t5-large).

    python -m funcodec_tpu_torch.cli.extract_t5_emb --text_scp text \\
        --output exp/t5_train --t5_model /path/to/t5-large [--device cpu]

writes ``{output}.ark`` and ``{output}.scp``, as the JAX CLI does. It needs
local T5 weights (``--t5_model``, a downloaded checkpoint directory) and the
``transformers`` package, which is imported only when the CLI runs. The
encoder runs on `--device`, the card by default.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from funcodec_tpu_torch.data.kaldi_ark import ArkWriter
from funcodec_tpu_torch.data.wav_io import read_2column_text
from funcodec_tpu_torch.tasks.codec import resolve_device


def load_t5(name: str):
    """(tokenizer, T5EncoderModel) from a Hugging Face name or a local
    checkpoint directory."""
    try:
        from transformers import AutoTokenizer, T5EncoderModel
    except ImportError as e:
        raise SystemExit(f"transformers unavailable: {e}")
    try:
        return AutoTokenizer.from_pretrained(name), T5EncoderModel.from_pretrained(name)
    except Exception as e:
        raise SystemExit(
            f"could not load T5 weights from {name!r}: {e}\n"
            "Download the checkpoint on a machine with network access and pass the local "
            "directory via --t5_model."
        )


def main(argv=None):
    parser = argparse.ArgumentParser(description="T5 text embedding extraction")
    parser.add_argument("--text_scp", type=str, required=True)
    parser.add_argument("--output", type=str, required=True, help="output basename; writes {output}.ark/.scp")
    parser.add_argument("--t5_model", type=str, default="t5-large",
                        help="HF model name or local checkpoint directory")
    parser.add_argument("--max_length", type=int, default=128)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    tokenizer, model = load_t5(args.t5_model)
    model = model.to(device).eval()
    texts = read_2column_text(args.text_scp)
    with ArkWriter(args.output + ".ark", args.output + ".scp") as writer, torch.no_grad():
        for key, text in texts.items():
            ids = tokenizer(text, return_tensors="pt", truncation=True, max_length=args.max_length)
            h = model(**{k: v.to(device) for k, v in ids.items()}).last_hidden_state[0]  # (L, D)
            writer(key, h.float().cpu().numpy().astype(np.float32))
    logging.info("wrote %d embeddings to %s.ark", len(texts), args.output)


if __name__ == "__main__":
    main()
