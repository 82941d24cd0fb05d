"""The port's codec tooling against funcodec_tpu's, on the CPU.

- utils/misc: ``codec_flops_tree`` on tests/test_flops_tree.py's small model
  (labels, parameter counts, output shapes and line format equal to JAX's;
  conv and LSTM rows equal to 2 x MACs counted here; group percentages
  summing to 100 +- 1; the same tree whatever the kernel flags), and
  ``model_summary`` / ``count_parameters`` per branch equal to JAX's.
- utils/shape_utils: ``calc_shape`` / ``generate_data_list`` /
  ``collect_stats`` give equal files and statistics (exactly).
- cli/dump_to_wav_ark: arks, scps and length files byte-equal to the JAX
  CLI's (the same resampler).
- cli/average_nbest: the result equals the mean of the n best epoch files
  and JAX's averaging of the same weights within 1e-7.
- cli/codec_eval: quality.json within 1e-6 relative of the JAX CLI's.
- --stat_flops through cli/codec_inference and cli/codec_train: the tree
  logged is codec_flops_tree's.
"""

import json
import logging
import re

import numpy as np
import pytest
import torch
import yaml

import jax

from funcodec_tpu.data import wav_io as jwav
from funcodec_tpu.tasks.codec import build_codec_model as jbuild
from funcodec_tpu_torch.compat.from_jax import state_dict_from_jax
from funcodec_tpu_torch.ops import conv as conv_ops
from funcodec_tpu_torch.quant import rvq as trvq
from funcodec_tpu_torch.tasks.codec import build_codec_model as tbuild
from funcodec_tpu_torch.utils import misc as tmisc

torch.set_num_threads(1)

# tests/test_flops_tree.py's model as a config dict (the encoder's latents are odim wide)
FLOPS_CONFIG = {
    "input_size": 1,
    "encoder_conf": {"n_filters": 8, "ratios": [4, 2], "norm": "time_group_norm"},
    "decoder_conf": {"n_filters": 8, "ratios": [4, 2], "norm": "time_group_norm"},
    "quantizer_conf": {"codebook_size": 32, "num_quantizers": 2, "kmeans_init": False},
    "model_conf": {"odim": 16},
}
ROW = re.compile(r"^(\s*)(.+?): flops (\S+)\((\d+\.\d+)%\), param\. (\S+)\((\d+\.\d+)%\)(?:  out=(\(.*\)))?$")


def _jax_params(model, seed=0):
    """Seeded numpy values in the shapes of model.init (no init compile)."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda s: (0.1 * rs.randn(*s.shape)).astype(s.dtype), shapes)


@pytest.fixture(scope="module")
def flops_pair():
    from funcodec_tpu.utils.misc import codec_flops_tree as jtree

    jm, _ = jbuild(FLOPS_CONFIG)
    params, state = jm.init(jax.random.PRNGKey(0))
    tm, _ = tbuild(FLOPS_CONFIG, device="cpu")
    return jtree(jm, params, state, samples=1600), tmisc.codec_flops_tree(tm, samples=1600), tm


def _rows(tree):
    return [ROW.match(line) for line in tree.splitlines()[1:]]


def test_flops_tree_layout_matches_jax(flops_pair):
    """Every line parses; labels, depth, parameter counts and output shapes
    are JAX's; only the FLOPs columns differ (module docstring of utils/misc)."""
    j_tree, t_tree, _ = flops_pair
    j_rows, t_rows = _rows(j_tree), _rows(t_tree)
    assert all(j_rows) and all(t_rows), t_tree
    assert len(t_rows) == len(j_rows) >= 20
    for j, t in zip(j_rows, t_rows):
        assert (t[1], t[2], t[5], t[7]) == (j[1], j[2], j[5], j[7]), (t.group(0), j.group(0))


def test_flops_tree_counts_are_two_macs(flops_pair):
    """conv / convtr rows are 2 x B x T x Cout x Cin x K (the transposed ones
    over their input frames), the 2-layer LSTM 2 x T x layers x 4H x 2H,
    the quantizer 2 x T' x n_q x bins x D; group percentages sum to 100 +- 1."""
    _, t_tree, tm = flops_pair
    rows = {m[2]: m for m in _rows(t_tree)}

    def count(text):
        scale = {"K": 1e3, "M": 1e6, "G": 1e9, "B": 1}[text[-1]]
        return float(text[:-1]) * scale

    def close(label, want):
        got = count(rows[label][3])
        assert abs(got - want) <= 0.005 * want + 10, (label, got, want)

    close("0.conv k7 s1 1->8", 2 * 1600 * 8 * 1 * 7)
    close("3.conv k4 s2 8->16", 2 * 800 * 16 * 8 * 4)
    close("6.conv k8 s4 16->32", 2 * 200 * 32 * 16 * 8)
    close("7.lstm", 2 * 200 * 2 * 4 * 32 * 64)
    close("9.conv k7 s1 32->16", 2 * 200 * 16 * 32 * 7)
    close("3.convtr k8 s4 32->16", 2 * 200 * 32 * 16 * 8)
    close("quantizer", 2 * 200 * 2 * 32 * 16)
    top = [float(m[4]) for m in _rows(t_tree) if not m[1] and m[2] != "TOTAL"]
    assert len(top) == 3 and abs(sum(top) - 100.0) < 1.0
    # the quantizer's parameters are its codebooks
    assert rows["quantizer"][5] == tmisc._clever_format(2 * 32 * 16)


def test_flops_tree_is_the_same_whatever_the_kernel_flags(flops_pair):
    _, t_tree, tm = flops_pair
    saved = conv_ops.FUSED_STRIDE1, conv_ops.FUSED_RESBLOCK, trvq.FUSED_RVQ
    try:
        conv_ops.FUSED_STRIDE1 = conv_ops.FUSED_RESBLOCK = trvq.FUSED_RVQ = True
        assert tmisc.codec_flops_tree(tm, samples=1600) == t_tree
    finally:
        conv_ops.FUSED_STRIDE1, conv_ops.FUSED_RESBLOCK, trvq.FUSED_RVQ = saved


CONTEXT = {"model": "transformer", "model_conf": {"attention_heads": 2, "linear_units": 32, "num_blocks": 1},
           "mask_conf": {"mask_ratio_range": [0.0, 0.2], "num_mask": 2}, "ce_loss_weight": 1.0}


@pytest.mark.parametrize("model_conf", [
    {"odim": 16},
    {"odim": 16, "context_loss_weight": 1.0, "context_loss_conf": CONTEXT},
    {"odim": 16, "ppg_conf": {"ppg_dim": 12, "ppg_usage_mod": "supervision"}},
    {"odim": 16, "ppg_conf": {"ppg_dim": 12, "ppg_usage_mod": "ptts"}},
], ids=["encodec", "context", "semantic-supervision", "semantic-ptts"])
def test_model_summary_per_branch_matches_jax(model_conf):
    """The same branches with the same counts (the JAX params dict's order
    is not kept by eval_shape, so the lines are compared as a set)."""
    from funcodec_tpu.utils.misc import count_parameters as jcount
    from funcodec_tpu.utils.misc import model_summary as jsummary

    config = dict(FLOPS_CONFIG, model_conf=model_conf)
    if "ppg_conf" in model_conf:
        config["model"] = "codec_semantic_aug"
    jm, _ = jbuild(config)
    params, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tm, _ = tbuild(config, device="cpu")
    assert tmisc.count_parameters(tm) == jcount(params)
    t_lines, j_lines = tmisc.model_summary(tm, "g").splitlines(), jsummary(params, "g").splitlines()
    assert t_lines[0] == j_lines[0] and t_lines[-1] == j_lines[-1]
    assert sorted(t_lines[1:-1]) == sorted(j_lines[1:-1])


def test_count_parameters_and_estimate_flops():
    """test_data_utils.test_model_summary_and_flops on the port: a dict tree,
    and estimate_flops' keys (a (4, 8) x (8, 8) matmul is 512 FLOPs)."""
    tree = {"a": {"w": torch.zeros(4, 8)}, "b": torch.zeros(16)}
    assert tmisc.count_parameters(tree) == 48
    assert "TOTAL: 48" in tmisc.model_summary(tree)
    cost = tmisc.estimate_flops(lambda x: x @ torch.ones(8, 8), torch.ones(4, 8))
    assert cost == {"flops": 512.0, "bytes_accessed": float(2 * 4 * 8 * 4)}


# ---------------------------------------------------------------------------
# shape scan, data list, stats
# ---------------------------------------------------------------------------


@pytest.fixture()
def wav_corpus(tmp_path):
    """tests/test_data_utils.py's corpus: 5 utterances of 900-2232 samples."""
    rng = np.random.RandomState(0)
    (tmp_path / "train").mkdir()
    lines = []
    for i in range(5):
        w = (0.2 * rng.randn(900 + 333 * i)).astype(np.float32)
        p = tmp_path / f"u{i}.wav"
        jwav.write_wav(p, np.clip(w, -1, 1), 16000)
        lines.append(f"u{i} {p}")
    (tmp_path / "train" / "wav.scp").write_text("\n".join(lines) + "\n")
    return tmp_path


def test_calc_shape_and_data_list_match_jax(wav_corpus):
    from funcodec_tpu.utils import shape_utils as jshape
    from funcodec_tpu_torch.utils import shape_utils as tshape

    for pkg, out in ((jshape, "j"), (tshape, "t")):
        kept, dropped = pkg.calc_shape(str(wav_corpus), "train", str(wav_corpus / out), min_length=1000,
                                       max_length=2000, num_workers=2)
        assert (kept, dropped) == (3, 2)  # u0 (900) and u4 (2232) dropped
    assert ((wav_corpus / "t" / "train" / "speech_shape").read_bytes()
            == (wav_corpus / "j" / "train" / "speech_shape").read_bytes())
    j_list = (wav_corpus / "train" / "j.list")
    jshape.generate_data_list(str(wav_corpus), "train", out_name="j.list")
    t_path = tshape.generate_data_list(str(wav_corpus), "train", out_name="t.list")
    assert open(t_path, "rb").read() == j_list.read_bytes()
    assert [json.loads(line)["key"] for line in open(t_path)] == [f"u{i}" for i in range(5)]


def test_collect_stats_matches_jax(wav_corpus):
    from funcodec_tpu.data.dataset import CodecDataset as JDataset
    from funcodec_tpu.utils.shape_utils import collect_stats as jcollect
    from funcodec_tpu_torch.data.dataset import CodecDataset as TDataset
    from funcodec_tpu_torch.utils.shape_utils import collect_stats as tcollect

    src = [(str(wav_corpus / "train" / "wav.scp"), "speech", "sound")]
    j = jcollect(JDataset(src), str(wav_corpus / "js"))
    t = tcollect(TDataset(src), str(wav_corpus / "ts"))
    assert set(t) == set(j) == {"sum", "sq_sum", "count"}
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
    assert int(t["count"]) == sum(900 + 333 * i for i in range(5))
    assert (wav_corpus / "ts" / "speech_shape").read_bytes() == (wav_corpus / "js" / "speech_shape").read_bytes()
    saved = np.load(wav_corpus / "ts" / "speech_stats.npz")
    np.testing.assert_array_equal(saved["sq_sum"], j["sq_sum"])


# ---------------------------------------------------------------------------
# the recipe CLIs
# ---------------------------------------------------------------------------


def test_dump_to_wav_ark_is_byte_equal_to_jax(tmp_path):
    """24 kHz (mono and one stereo file) and 16 kHz inputs, a loud one
    whose resampled peaks pass 1 (rescaled), a list entry that cannot be
    read, 2 shards: every file equal to the JAX CLI's (the scp's paths up
    to the output directory)."""
    from funcodec_tpu.cli.dump_to_wav_ark import main as jmain
    from funcodec_tpu_torch.cli.dump_to_wav_ark import main as tmain

    rs = np.random.RandomState(3)
    src = tmp_path / "src"
    src.mkdir()
    lines = []
    for i, (n, sr, ch) in enumerate([(24000, 24000, 1), (13001, 24000, 2), (16000, 16000, 1), (7000, 24000, 1),
                                     (9000, 16000, 1)]):
        x = (0.4 if i == 3 else 0.2) * (rs.randn(n, ch) if ch > 1 else rs.randn(n))
        jwav.write_wav(src / f"u{i}.wav", np.clip(x, -1, 1).astype(np.float32), sr)
        lines.append(f"u{i} {src / f'u{i}.wav'}")
    lines.append(f"bad {src / 'missing.wav'}")
    (tmp_path / "wav.scp").write_text("\n".join(lines) + "\n")
    args = ["--wav_scp", str(tmp_path / "wav.scp"), "--sample_rate", "16000", "--nj", "2"]
    jmain(args + ["--out_dir", str(tmp_path / "j")])
    assert tmain(args + ["--out_dir", str(tmp_path / "t")]) == 5
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert "wav.01.ark" in names and "length.txt" in names
    for name in names:
        j, t = (tmp_path / "j" / name).read_bytes(), (tmp_path / "t" / name).read_bytes()
        if name.endswith(".scp"):
            j = j.replace(str(tmp_path / "j").encode(), b"OUT")
            t = t.replace(str(tmp_path / "t").encode(), b"OUT")
        assert t == j, name


def _trainer_dir(tmp_path, tm, jm, config, epochs=3):
    """A training directory as both trainers leave it: config.yaml,
    reporter.json with the valid criterion of `epochs` epochs, and each
    epoch's weights (seeded) as the port's {e}epoch.pth and JAX's {e}epoch.ckpt."""
    from funcodec_tpu.train.checkpoint import save_weights as jsave

    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "config.yaml").write_text(yaml.safe_dump(config))
    crit = [3.0, 1.0, 2.0, 4.0][:epochs]  # best first: epochs 2, 3, 1
    stats = {str(e + 1): {"valid": {"generator_multi_spectral_recon_loss": c, "loss": -c}, "train": {"loss": c}}
             for e, c in enumerate(crit)}
    (exp / "reporter.json").write_text(json.dumps({"stats": stats, "epoch": epochs}))
    weights = {}
    for e in range(1, epochs + 1):
        params, state = _jax_params(jm, seed=e)
        sd = state_dict_from_jax(tm, jax.tree_util.tree_map(np.asarray, params),
                                 jax.tree_util.tree_map(np.asarray, state))
        torch.save(sd, exp / f"{e}epoch.pth")
        jsave(str(exp / f"{e}epoch.ckpt"), params, state)
        weights[e] = sd
    return exp, weights


def test_average_nbest_matches_the_mean_and_jax(tmp_path):
    from funcodec_tpu.train.checkpoint import average_checkpoints as javerage
    from funcodec_tpu.train.reporter import Reporter as JReporter
    from funcodec_tpu_torch.cli.average_nbest import main as tmain
    from funcodec_tpu_torch.train.reporter import Reporter as TReporter

    jm, _ = jbuild(FLOPS_CONFIG)
    tm, _ = tbuild(FLOPS_CONFIG, device="cpu")
    exp, weights = _trainer_dir(tmp_path, tm, jm, FLOPS_CONFIG)
    report = json.loads((exp / "reporter.json").read_text())
    for reporter in (TReporter(), JReporter()):
        reporter.load_state_dict(report)
        assert reporter.sort_epochs("valid", "generator_multi_spectral_recon_loss", "min") == [2, 3, 1]
    out = tmain(["--exp_dir", str(exp), "--nbest", "2"])
    assert out.endswith("valid.generator_multi_spectral_recon_loss.ave_2best.pth")
    avg = torch.load(out, weights_only=True)
    names = {n for n, _ in tm.named_parameters()}
    assert set(avg) == set(weights[2])
    for k, v in avg.items():
        want = (weights[2][k].double() + weights[3][k].double()) / 2 if k in names else weights[2][k]
        np.testing.assert_allclose(v.numpy(), want.numpy(), rtol=0, atol=1e-7, err_msg=k)
    j_params, j_state = javerage([str(exp / "2epoch.ckpt"), str(exp / "3epoch.ckpt")], jm)
    j_sd = state_dict_from_jax(tm, j_params, jax.tree_util.tree_map(np.asarray, j_state))
    for k, v in avg.items():
        np.testing.assert_allclose(v.numpy(), j_sd[k].numpy(), rtol=0, atol=1e-7, err_msg=k)
    tm.load_state_dict(avg)  # a weights file the codec CLIs load
    # another criterion, all epochs
    out = tmain(["--exp_dir", str(exp), "--criterion", "valid.loss.max", "--nbest", "5"])
    assert out.endswith("valid.loss.ave_3best.pth")


def test_codec_eval_matches_jax(tmp_path):
    """tests/test_data_utils.test_codec_eval_cli's pairs, one reconstruction
    at 24 kHz (resampled to 16 kHz) and one missing: quality.json within
    1e-6 relative of the JAX CLI's."""
    from funcodec_tpu.cli.codec_eval import main as jmain
    from funcodec_tpu_torch.cli.codec_eval import main as tmain

    rng = np.random.RandomState(1)
    (tmp_path / "deg").mkdir()
    lines = []
    for i in range(4):
        t = np.arange(8000) / 16000.0
        ref = sum(0.3 / (k + 1) * np.sin(2 * np.pi * (200 + 100 * i) * (k + 1) * t) for k in range(8))
        ref = (ref + 0.05 * rng.randn(len(t))).astype(np.float32)
        deg = ref + 0.02 * rng.randn(len(ref)).astype(np.float32)
        jwav.write_wav(tmp_path / f"u{i}.wav", ref, 16000)
        if i == 1:
            jwav.write_wav(tmp_path / "deg" / f"u{i}_fake.wav", jwav.resample(deg, 16000, 24000), 24000)
        elif i < 3:
            jwav.write_wav(tmp_path / "deg" / f"u{i}_rec.wav", deg, 16000)
        lines.append(f"u{i} {tmp_path}/u{i}.wav")
    (tmp_path / "wav.scp").write_text("\n".join(lines) + "\n")
    args = ["--ref_scp", str(tmp_path / "wav.scp"), "--deg_dir", str(tmp_path / "deg")]
    jmain(args + ["--output_dir", str(tmp_path / "j")])
    result = tmain(args + ["--output_dir", str(tmp_path / "t")])
    j = json.loads((tmp_path / "j" / "quality.json").read_text())
    t = json.loads((tmp_path / "t" / "quality.json").read_text())
    assert t == json.loads(json.dumps(result))
    assert set(t["per_utt"]) == set(j["per_utt"]) == {"u0", "u1", "u2"}
    assert set(t["mean"]) == {"lsd_db", "mel_distortion", "si_snr_db", "stoi", "nsim"}
    for k, v in j["mean"].items():
        np.testing.assert_allclose(t["mean"][k], v, rtol=1e-6, err_msg=k)
    for u, m in j["per_utt"].items():
        for k, v in m.items():
            np.testing.assert_allclose(t["per_utt"][u][k], v, rtol=1e-6, err_msg=f"{u} {k}")


# ---------------------------------------------------------------------------
# --stat_flops through the CLIs
# ---------------------------------------------------------------------------


def _logged_tree(caplog):
    trees = [r.getMessage() for r in caplog.records if "serving-path cost tree" in r.getMessage()]
    assert len(trees) == 1
    return trees[0].strip("\n")


def test_stat_flops_through_codec_inference(tmp_path, caplog):
    from funcodec_tpu_torch.cli.codec_inference import main

    tm, _ = tbuild(FLOPS_CONFIG, device="cpu")
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(FLOPS_CONFIG))
    torch.save(tm.state_dict(), tmp_path / "model.pth")
    jwav.write_wav(tmp_path / "a.wav", (0.2 * np.random.RandomState(0).randn(1600)).astype(np.float32), 16000)
    (tmp_path / "wav.scp").write_text(f"a {tmp_path / 'a.wav'}\n")
    with caplog.at_level(logging.INFO):
        main(["--config_file", str(tmp_path / "config.yaml"), "--model_file", str(tmp_path / "model.pth"),
              "--output_dir", str(tmp_path / "out"), "--data_path_and_name_and_type",
              f"{tmp_path / 'wav.scp'},speech,sound", "--device", "cpu", "--stat_flops"])
    assert _logged_tree(caplog) == tmisc.codec_flops_tree(tm, samples=16000)
    assert (tmp_path / "out" / "codecs.txt").exists()


def test_stat_flops_through_codec_train(tmp_path, caplog):
    from funcodec_tpu_torch.cli.codec_train import main

    config = dict(FLOPS_CONFIG, speech_max_length=3200, batch_size=2, use_tensorboard=False)
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config))
    rs = np.random.RandomState(0)
    for split in ("train", "valid"):
        (tmp_path / split).mkdir()
        with open(tmp_path / split / "wav.scp", "w") as f:
            for i in range(2):
                jwav.write_wav(tmp_path / split / f"u{i}.wav", (0.2 * rs.randn(4000)).astype(np.float32), 16000)
                f.write(f"u{i} {tmp_path / split / f'u{i}.wav'}\n")
    with caplog.at_level(logging.INFO):
        trainer, state = main(["--config", str(tmp_path / "config.yaml"), "--output_dir", str(tmp_path / "exp"),
                               "--train_wav_scp", str(tmp_path / "train" / "wav.scp"), "--valid_wav_scp",
                               str(tmp_path / "valid" / "wav.scp"), "--device", "cpu", "--dry_run",
                               "--stat_flops"])
    assert _logged_tree(caplog) == tmisc.codec_flops_tree(state.model, samples=3200)
    summaries = [r.getMessage() for r in caplog.records if r.getMessage().startswith("generator summary:")]
    assert summaries == [tmisc.model_summary(state.model, "generator")]
