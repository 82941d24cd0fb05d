"""The port's LauraTTS CLI against funcodec_tpu's, on the CPU.

A tiny codec (test_torch_encodec._config at the Laura codebook's shape)
saved as a .pth from the port, and a tiny Laura LM (test_torch_laura) whose
codebook is that codec's, saved as a .pth with laura_state_dict_from_jax,
drive both packages' text2audio_inference.main over one text.scp of word
tokens (two lines, one with a zero-shot prompt), greedy, in the three
decode modes. The port writes the same files and tts_eval.json keys, and
every wav agrees within 2 PCM16 steps.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import funcodec_tpu.cli.codec_inference as jcodec
import funcodec_tpu.cli.text2audio_inference as jcli
import funcodec_tpu.data.wav_io as jwav
import funcodec_tpu_torch.cli.text2audio_inference as tcli
from test_torch_encodec import _config, _pair
from test_torch_laura import BINS, DIM, NQ, laura_pair, tiny_config

torch.set_num_threads(1)

SR = 16000
MODES = {"b1": [], "batch": ["--batch_size", "2"], "serving": ["--serving_slots", "2"]}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("tts")
    codec_config = _config(n_q=NQ, bins=BINS, dim=DIM)
    (root / "codec.yaml").write_text(yaml.safe_dump(codec_config))
    _, _, state, codec = _pair(codec_config, seed=1)
    torch.save(codec.state_dict(), root / "codec.pth")

    config = tiny_config("uni")
    config.update(audio_max_duration=0.4, codec_token_rate=25)  # 10 token groups a request
    (root / "laura.yaml").write_text(yaml.safe_dump(config))
    tokens = [str(i) for i in range(10)]
    (root / "tokens.txt").write_text("".join(f"{t}\n" for t in tokens))
    jm, params, tm = laura_pair(config, token_list=tokens, seed=2, eos_bias=-10.0)
    with torch.no_grad():  # the codec's codebooks grafted in, as Laura training does
        tm.quantizer_codebook.embed.copy_(codec.quantizer.state.embed)
    torch.save(tm.state_dict(), root / "laura.pth")

    rs = np.random.RandomState(3)
    lines, prompts = [], []
    for i in range(2):
        lines.append(f"k{i} " + " ".join(str(x) for x in rs.randint(0, 10, 5)))
        if i % 2:
            wav = np.clip(rs.randn(160) * 0.2 * 32768, -32768, 32767).astype(np.int16)
            jwav.write_wav(root / f"p{i}.wav", wav, SR)
            prompts.append(f"k{i} {root / f'p{i}.wav'}")
    (root / "text.scp").write_text("\n".join(lines) + "\n")
    (root / "prompt.scp").write_text("\n".join(prompts) + "\n")
    return root


def _args(root, out, mode):
    return ["--output_dir", str(out), "--config_file", str(root / "laura.yaml"), "--model_file",
            str(root / "laura.pth"), "--codec_config_file", str(root / "codec.yaml"), "--codec_model_file",
            str(root / "codec.pth"), "--text_scp", str(root / "text.scp"), "--token_list", str(root / "tokens.txt"),
            "--token_type", "word", "--prompt_wav_scp", str(root / "prompt.scp"), "--sampling", "false",
            *MODES[mode]]


@pytest.fixture(scope="module")
def jax_pipeline(setup):
    """One JAX Text2Audio for the three modes' runs, so that its jitted codec
    and decode programs compile once (greedy: its key does not matter)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcodec, "_CACHE_DIR", "disabled")
    made = []
    real = jcli.Text2Audio

    def shared(*a, **kw):
        if not made:
            made.append(real(*a, **kw))
        return made[0]

    mp.setattr(jcli, "Text2Audio", shared)
    yield
    mp.undo()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_matches_jax(setup, jax_pipeline, mode):
    jcli.main(_args(setup, setup / f"jax_{mode}", mode))
    tcli.main(_args(setup, setup / f"torch_{mode}", mode) + ["--device", "cpu"])
    jdir, tdir = setup / f"jax_{mode}", setup / f"torch_{mode}"
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir())
    assert len([n for n in names if n.endswith(".wav")]) == 4  # gen and gen_only_lm for 2 lines
    for name in names:
        if not name.endswith(".wav"):
            continue
        sr_j, wj = jwav.read_wav(jdir / name, normalize=False)
        sr_t, wt = jwav.read_wav(tdir / name, normalize=False)
        assert sr_j == sr_t == SR and wj.shape == wt.shape == (10 * 8,), name  # 10 groups x hop 8
        assert np.abs(wj.astype(np.int32) - wt.astype(np.int32)).max() <= 2, name
    ej = json.loads((jdir / "tts_eval.json").read_text())
    et = json.loads((tdir / "tts_eval.json").read_text())
    assert et.keys() == ej.keys() and et["per_utt"].keys() == ej["per_utt"].keys()
    for key, row in ej["per_utt"].items():
        assert et["per_utt"][key].keys() == row.keys()


def test_cli_defaults_to_the_card(setup):
    """Without --device the CLI asks for cuda, which raises where torch sees no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    out = subprocess.run([sys.executable, "-m", "funcodec_tpu_torch.cli.text2audio_inference",
                          *_args(setup, setup / "default", "b1")], capture_output=True, text=True)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
