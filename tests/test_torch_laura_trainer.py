"""The port's Laura trainer (train/laura_trainer.py, cli/text2audio_train.py)
against funcodec_tpu's, on the CPU, fp32.

A tiny corpus (6 train and 2 valid utterances of word-token text and
4-group codec matrices in a kaldi ark, each 20 tokens long, so that
batch_bins 40 gives batches of 2 of one bucketed shape: the JAX step and
valid step compile once) and the tiny LM of tests/test_torch_laura.py
(seeded numpy weights, sampling ratio 0 and no SpecAug: no draws) drive
both packages' text2audio_train.main for one epoch from the same weights,
the codebook grafted from the same codec .pth. The JAX CLI runs once.

Tolerances: reporter.json's train and valid stats rtol 1e-4 (fp32,
summation order); parameters within 0.05 of the largest learning rate the
schedule reached (the measured worst is about 0.02, a few elements of the
rel-pos projections; Adam moves an element by about lr a step whichever its
gradient's size, so an element's rounding shows at most as a fraction of
lr), but the attention key biases, whose gradient is rounding noise in both
packages: within 2 lr a step. The port's own contracts (the non-finite skip, resume, the state
carried from JAX, the served weights) hold exactly.
"""

import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import funcodec_tpu.cli.text2audio_train as jcli
import funcodec_tpu.train.laura_trainer as jtrain
import funcodec_tpu_torch.cli.text2audio_train as tcli
from funcodec_tpu.data.text import Text2AudioPreprocessor as JPre
from funcodec_tpu_torch.compat.from_jax import laura_state_dict_from_jax, laura_train_state_from_jax
from funcodec_tpu_torch.data.kaldi_ark import ArkWriter
from funcodec_tpu_torch.data.text import Text2AudioPreprocessor as TPre
from funcodec_tpu_torch.train import laura_trainer as ttrain
from funcodec_tpu_torch.train.checkpoint import load_train_state
from test_torch_encodec import _config, _pair
from test_torch_laura import BINS, DIM, NQ, laura_pair, tiny_config
from test_torch_transformer import np_tree

torch.set_num_threads(1)

TOKENS = [f"t{i}" for i in range(10)]
LR, WARMUP = 1e-3, 10
PARAM_FRAC = 0.05  # as tests/test_torch_gan_two_steps.py holds the GAN step
STAT_RTOL = 1e-4


def _config_dict():
    cfg = tiny_config("uni")
    cfg["model_conf"].update(lsm_weight=0.1, codec_sampling_ratio=0.0)
    cfg.update(optim="adam", optim_conf={"lr": LR}, scheduler="warmuplr", scheduler_conf={"warmup_steps": WARMUP},
               grad_clip=5, max_epoch=1, batch_bins=40, num_workers=1, log_interval=1000, keep_nbest_models=2,
               audio_max_duration=30, codec_token_rate=25)
    return cfg


def _max_rate(steps):
    return max(LR * WARMUP ** 0.5 * min((s + 1) ** -0.5, (s + 1) * WARMUP ** -1.5) for s in range(steps))


def _write_split(root, name, n, rs):
    lines = []
    with ArkWriter(root / f"{name}.ark", root / f"{name}.scp") as ark:
        for i in range(n):
            tl = 6 + i % 4
            lines.append(f"{name}{i} " + " ".join(TOKENS[t] for t in rs.randint(0, len(TOKENS), tl)))
            ark(f"{name}{i}", rs.randint(0, BINS, (20 - tl, NQ)))
    (root / f"{name}_text").write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("laura_train")
    rs = np.random.RandomState(0)
    _write_split(root, "train", 6, rs)
    _write_split(root, "valid", 2, rs)
    (root / "tokens.txt").write_text("".join(f"{t}\n" for t in TOKENS))
    cfg = _config_dict()
    (root / "laura.yaml").write_text(yaml.safe_dump(cfg))
    codec_config = _config(n_q=NQ, bins=BINS, dim=DIM)
    (root / "codec.yaml").write_text(yaml.safe_dump(codec_config))
    _, _, _, codec = _pair(codec_config, seed=1)
    torch.save(codec.state_dict(), root / "codec.pth")
    jm, params, tm = laura_pair(cfg, token_list=TOKENS, seed=4)
    return dict(root=root, jm=jm, params=params, sd=tm.state_dict(),
                embed=codec.quantizer.state.embed.detach().clone())


def _cli_args(root, out, *extra):
    return ["--config", str(root / "laura.yaml"), "--output_dir", str(out), "--train_text", str(root / "train_text"),
            "--train_codec", str(root / "train.scp"), "--valid_text", str(root / "valid_text"), "--valid_codec",
            str(root / "valid.scp"), "--token_list", str(root / "tokens.txt"), "--token_type", "word",
            "--codec_init_param", str(root / "codec.pth"), "--codec_config", str(root / "codec.yaml"), *extra]


@pytest.fixture(scope="module")
def jax_run(env):
    """The JAX CLI's one epoch from the seeded weights: its trainer (the
    jitted step is reused below) and its final state (numpy)."""
    mp = pytest.MonkeyPatch()
    seeded = jax.tree_util.tree_map(jnp.asarray, env["params"])
    mp.setattr(jtrain.LauraTrainer, "init_state",
               lambda self, key: jtrain.TrainState(step=jnp.int32(0), params=seeded,
                                                   opt_state=self.optimizer.init(seeded)))
    got = {}
    real_run = jtrain.LauraTrainer.run

    def run(self, state, *a, **kw):
        got["trainer"] = self
        out = real_run(self, state, *a, **kw)
        got["state"] = jtrain.TrainState(step=np.asarray(out.step), params=np_tree(out.params),
                                         opt_state=np_tree(out.opt_state))
        return out

    mp.setattr(jtrain.LauraTrainer, "run", run)
    try:
        jcli.main(_cli_args(env["root"], env["root"] / "jax_exp"))
    finally:
        mp.undo()
    return got


def _port_cli(env, monkeypatch, out, *extra):
    """The port's CLI on the CPU from the seeded weights."""
    real = tcli.build_laura_model

    def build(*a, **kw):
        model = real(*a, **kw)
        model.load_state_dict(env["sd"])
        return model

    monkeypatch.setattr(tcli, "build_laura_model", build)
    return tcli.main(_cli_args(env["root"], out, "--device", "cpu", *extra))


def _assert_params_close(sd, jax_params, model, steps):
    """Within PARAM_FRAC of the largest rate, but the attention key biases:
    their gradient is 0 in exact arithmetic (the softmax is invariant to a
    shift per query), so Adam turns each package's rounding noise into
    steps of up to about lr; those are held within 2 lr a step."""
    lr = _max_rate(steps)
    ref = laura_state_dict_from_jax(model, jax_params)
    for name, v in sd.items():
        d = (v.float() - ref[name]).abs().max().item()
        limit = 2 * steps * lr if name.endswith("linear_k.bias") else PARAM_FRAC * lr
        assert d <= limit, (name, d / lr)


def test_cli_one_epoch_matches_jax(env, jax_run, monkeypatch):
    out = env["root"] / "torch_exp"
    trainer, state = _port_cli(env, monkeypatch, out)
    assert state.step == int(jax_run["state"].step) == 3
    jrep = json.loads((env["root"] / "jax_exp" / "reporter.json").read_text())
    trep = json.loads((out / "reporter.json").read_text())
    for phase in ("train", "valid"):
        j, t = jrep["stats"]["1"][phase], trep["stats"]["1"][phase]
        assert set(j) == set(t), phase
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=STAT_RTOL, atol=1e-7, err_msg=f"{phase} {k}")
    _assert_params_close(state.model.state_dict(), jax_run["state"].params, state.model, 3)
    # the codebook: grafted from the codec, unchanged by training
    assert torch.equal(state.model.quantizer_codebook.embed, env["embed"])
    for name in ("checkpoint.pth", "1epoch.pth", "latest.pth", "valid.loss.best.pth", "reporter.json"):
        assert (out / name).exists(), name
    assert (out / "latest.pth").is_symlink() and (out / "valid.loss.best.pth").is_symlink()


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _step_batch(seed):
    rs = np.random.RandomState(seed)
    tl, cl = np.array([9, 6]), np.array([11, 14])
    text = np.full((2, 9), -1, np.int64)
    codec = np.full((2, 14, NQ), -1, np.int64)
    for b in range(2):
        text[b, : tl[b]] = rs.randint(0, len(TOKENS), tl[b])
        codec[b, : cl[b]] = rs.randint(0, BINS, (cl[b], NQ))
    return dict(text=text, text_lengths=tl, codec=codec, codec_lengths=cl)


def test_two_steps_from_a_carried_state_match_jax(env, jax_run):
    """The JAX CLI's final state carried into the port; two more steps in
    each package (Adam, warmuplr, clip 5): stats rtol 1e-4, parameters
    within 0.05 lr, the Adam counts equal, the codebook unchanged."""
    jt, jstate = jax_run["trainer"], jax_run["state"]
    _, _, tm = laura_pair(_config_dict(), token_list=TOKENS, seed=4)
    options = ttrain.LauraTrainerOptions(optim_conf={"lr": LR}, scheduler_conf={"warmup_steps": WARMUP})
    trainer = ttrain.LauraTrainer(tm, options)
    state = laura_train_state_from_jax(tm, jstate, trainer.optimizer)
    embed = tm.quantizer_codebook.embed.clone()
    js = jax.tree_util.tree_map(jnp.asarray, jstate)
    step_fn = jt._step_fn()
    for i in range(2):
        batch = _step_batch(20 + i)
        js, jstats = step_fn(js, jt._to_device(batch), jax.random.PRNGKey(0))
        state, stats = trainer.train_step(state, trainer.to_device(batch), torch.Generator())
        jstats = {k: float(v) for k, v in jstats.items()}
        assert set(jstats) == set(stats)
        for k, v in stats.items():
            np.testing.assert_allclose(float(v), jstats[k], rtol=STAT_RTOL, atol=1e-7, err_msg=k)
    assert state.step == int(js.step) == 5
    _assert_params_close(tm.state_dict(), np_tree(js.params), tm, 5)
    assert torch.equal(tm.quantizer_codebook.embed, embed)
    assert state.opt_state[1]["count"] == int(js.opt_state[1][0].count) == 5


def test_laura_train_state_from_jax(env, jax_run):
    """Parameters, Adam's moments and counts and the step carried exactly;
    the codebook's moments dropped."""
    jstate = jax_run["state"]
    _, _, tm = laura_pair(_config_dict(), token_list=TOKENS, seed=5)
    state = laura_train_state_from_jax(tm, jstate)
    assert state.step == 3
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    assert "quantizer_codebook.embed" not in names and len(names) == len(list(tm.parameters())) - 1
    ref = laura_state_dict_from_jax(tm, jstate.params)
    for n, v in tm.state_dict().items():
        assert torch.equal(v, ref[n]), n
    (adam,) = [s for s in state.opt_state if isinstance(s, dict)]
    jadam = jstate.opt_state[1][0]  # optax.chain(clip, adam = chain(scale_by_adam, schedule))
    assert adam["count"] == int(jadam.count) == 3
    for key in ("mu", "nu"):
        sd = laura_state_dict_from_jax(tm, getattr(jadam, key))
        assert len(adam[key]) == len(names)
        for n, t in zip(names, adam[key]):
            assert torch.equal(t, sd[n]), (key, n)


def test_nonfinite_step_changes_nothing(env):
    _, _, tm = laura_pair(_config_dict(), token_list=TOKENS, seed=6)
    trainer = ttrain.LauraTrainer(tm, ttrain.LauraTrainerOptions())
    state = trainer.init_state()
    batch = trainer.to_device(_step_batch(30))
    state, stats = trainer.train_step(state, batch, torch.Generator())
    assert float(stats["nonfinite_skip"]) == 0.0
    with torch.no_grad():
        tm.codec_lm.decoder.bias[3] = float("inf")  # the loss and every gradient go non-finite
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    mu_before = [m.clone() for m in state.opt_state[1]["mu"]]
    count = state.opt_state[1]["count"]
    state, stats = trainer.train_step(state, batch, torch.Generator())
    assert float(stats["nonfinite_skip"]) == 1.0 and not np.isfinite(float(stats["grad_norm"]))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert state.opt_state[1]["count"] == count
    assert all(torch.equal(a, b) for a, b in zip(state.opt_state[1]["mu"], mu_before))
    assert state.step == 2


def test_resume_to_epoch_3_is_exact(env, monkeypatch):
    """Epochs 1-2, then a resumed run to epoch 3, equal one run to epoch 3
    bit for bit; the resumed state equals checkpoint.pth; epochs 1-2 of
    reporter.json unchanged."""
    a, b = env["root"] / "resume_a", env["root"] / "resume_b"
    _, s2 = _port_cli(env, monkeypatch, a, "--max_epoch", "2")
    rep2 = json.loads((a / "reporter.json").read_text())
    template = ttrain.LauraTrainer(s2.model, ttrain.LauraTrainerOptions()).init_state()
    loaded = load_train_state(str(a / "checkpoint.pth"), template)
    assert loaded.step == 6
    for (n, v), w in zip(loaded.model.state_dict().items(), s2.model.state_dict().values()):
        assert torch.equal(v, w), n
    _, s3 = _port_cli(env, monkeypatch, a, "--max_epoch", "3")
    _, ref = _port_cli(env, monkeypatch, b, "--max_epoch", "3")
    assert s3.step == ref.step == 9
    for (n, v), w in zip(s3.model.state_dict().items(), ref.model.state_dict().values()):
        assert torch.equal(v, w), n
    rep3 = json.loads((a / "reporter.json").read_text())
    assert rep3["stats"]["1"] == rep2["stats"]["1"] and rep3["stats"]["2"] == rep2["stats"]["2"]
    assert rep3["stats"]["3"] == json.loads((b / "reporter.json").read_text())["stats"]["3"]
    assert sorted(p.name for p in a.glob("*epoch.pth")) == ["2epoch.pth", "3epoch.pth"]  # keep_nbest_models 2


def test_latest_served_by_text2audio_inference(env, monkeypatch):
    """latest.pth loads into cli/text2audio_inference's model exactly, and
    the CLI writes finite wavs from it."""
    import funcodec_tpu_torch.cli.text2audio_inference as tinf
    from funcodec_tpu_torch.data.wav_io import read_wav

    root = env["root"]
    exp = root / "serve_exp"
    _, state = _port_cli(env, monkeypatch, exp)
    cfg = _config_dict()
    cfg["audio_max_duration"] = 0.4  # 10 groups a request: random weights emit no eos
    (root / "serve.yaml").write_text(yaml.safe_dump(cfg))
    (root / "syn_text").write_text("s0 t1 t2 t3\ns1 t4 t5\n")
    files = dict(config_file=root / "serve.yaml", model_file=exp / "latest.pth", codec_config_file=root / "codec.yaml",
                 codec_model_file=root / "codec.pth", token_list=root / "tokens.txt")
    served = tinf.Text2Audio(**{k: str(v) for k, v in files.items()}, token_type="word", device="cpu")
    common = [a for k, v in files.items() for a in (f"--{k}", str(v))] + ["--token_type", "word"]
    for (n, v), w in zip(served.model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(v, w), n
    tinf.main(common + ["--text_scp", str(root / "syn_text"), "--output_dir", str(root / "syn"), "--device", "cpu",
                        "--sampling", "false"])
    wavs = sorted((root / "syn").glob("*.wav"))
    assert len(wavs) == 4
    for w in wavs:
        _, x = read_wav(w)
        assert x.shape == (10 * 8,) and np.isfinite(x).all()


def test_preprocessor_matches_jax():
    """One RandomState seed: the same crops of long codec matrices, the same
    token ids; short ones pass untouched."""
    rs = np.random.RandomState(40)
    j = JPre(True, audio_max_duration=1, codec_token_rate=10, token_list=TOKENS, token_type="word",
             rng=np.random.RandomState(7))
    t = TPre(True, audio_max_duration=1, codec_token_rate=10, token_list=TOKENS, token_type="word",
             rng=np.random.RandomState(7))
    for i in range(12):
        codec = rs.randint(0, BINS, (rs.randint(4, 30), NQ)).astype(np.float32)
        text = " ".join(TOKENS[k] for k in rs.randint(0, len(TOKENS), 5))
        a = j(f"u{i}", {"codec": codec.copy(), "text": text})
        b = t(f"u{i}", {"codec": codec.copy(), "text": text})
        assert a["codec"].dtype == b["codec"].dtype == np.int64
        np.testing.assert_array_equal(a["codec"], b["codec"])
        np.testing.assert_array_equal(a["text"], b["text"])
        assert len(b["codec"]) == min(len(codec), 10)
        st = [s for s in range(len(codec) - len(b["codec"]) + 1) if (codec[s: s + len(b["codec"])] == b["codec"]).all()]
        assert st, "the crop is not a window of the utterance"
    assert t.vocab_size == len(TOKENS)
