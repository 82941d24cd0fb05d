"""The port's cli/extract_t5_emb on the CPU, with a tiny random T5 encoder.

The repo holds no T5 weights and none may be downloaded, so ``load_t5`` is
patched to return a ``T5EncoderModel`` built from a small ``T5Config``
with seeded random weights and a whitespace tokenizer over a fixed word
list. The ark the CLI writes must hold that model's hidden states for each
line (atol 1e-6), under the keys and in the {output}.ark/.scp layout of
the JAX CLI.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from funcodec_tpu_torch.cli import extract_t5_emb
from funcodec_tpu_torch.data.kaldi_ark import ArkScpReader

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

WORDS = ["<pad>", "</s>", "rock", "piano", "calm", "drums", "jazz", "fast", "slow", "vocal"]


class WordTokenizer:
    """A whitespace tokenizer over WORDS that returns what a HF tokenizer's
    __call__ returns (input_ids, attention_mask), eos appended, truncated."""

    def __call__(self, text, return_tensors="pt", truncation=True, max_length=128):
        ids = [WORDS.index(w) for w in text.split()][: max_length - 1] + [1]
        ids = torch.tensor([ids])
        return {"input_ids": ids, "attention_mask": torch.ones_like(ids)}


def tiny_t5():
    cfg = transformers.T5Config(vocab_size=len(WORDS), d_model=16, d_kv=4, d_ff=32, num_layers=2, num_heads=4,
                                decoder_start_token_id=0)
    torch.manual_seed(0)
    return transformers.T5EncoderModel(cfg).eval()


def test_main_writes_the_hidden_states(tmp_path, monkeypatch):
    model = tiny_t5()
    tokenizer = WordTokenizer()
    seen = []

    def load(name):
        seen.append(name)
        return tokenizer, model

    monkeypatch.setattr(extract_t5_emb, "load_t5", load)
    texts = {"utt1": "rock piano fast", "utt2": "calm jazz", "utt3": "drums drums vocal slow"}
    scp = tmp_path / "text"
    scp.write_text("".join(f"{k} {v}\n" for k, v in texts.items()))
    out = tmp_path / "t5_train"
    extract_t5_emb.main(["--text_scp", str(scp), "--output", str(out), "--t5_model", "local/t5", "--device", "cpu",
                         "--max_length", "3"])
    assert seen == ["local/t5"]
    assert (tmp_path / "t5_train.ark").exists() and (tmp_path / "t5_train.scp").exists()
    reader = ArkScpReader(str(tmp_path / "t5_train.scp"))
    assert sorted(reader.keys()) == sorted(texts)
    with torch.no_grad():
        for key, text in texts.items():
            ids = tokenizer(text, max_length=3)
            want = model(**ids).last_hidden_state[0].numpy()
            got = reader[key]
            assert got.dtype == np.float32 and got.shape == (min(len(text.split()) + 1, 3), 16)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_defaults_and_lazy_import():
    """--device defaults to cuda (raising without a card); importing the module
    does not import transformers."""
    code = ("import sys; import funcodec_tpu_torch.cli.extract_t5_emb; "
            "print('transformers' in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            extract_t5_emb.main(["--text_scp", "x", "--output", "y"])
