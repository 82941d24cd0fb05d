"""The port's codec trainer, on the CPU (no JAX): the mirror of
tests/test_trainer.py's contract for ``python -m funcodec_tpu_torch.cli.codec_train``.

Sizes are tests/test_trainer.py's TINY_CONFIG (k-means init, quantizer
dropout) and its corpus (6 tones + noise of 4,096-6,656 samples, cropped to
4,096); TensorBoard off (its import costs seconds). Covered: the checkpoint
contract (checkpoint.pth, {epoch}epoch.pth, latest.pth and best links,
n-best pruning, config.yaml, validation dumps, reporter.json), resume, the
trained weights served by cli/codec_inference, the shape file, the device
cache with stats_interval 2 (and its refusal of RIR / noise),
--print_config / --dry_run / --stat_flops; the train state's save -> load
bit for bit (Adam moments, multi_steps counters, the add_noise generator);
exact resume (2 epochs against 1 + resume + 1, dropout and k-means on, bit
for bit, on a corpus of utterances no longer than the crop, which draw
nothing on the host); the packed-weight caches rebuilt after in-place
updates; the profiler window.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import funcodec_tpu_torch.train.gan_trainer as gan_trainer
from funcodec_tpu_torch.cli import codec_inference
from funcodec_tpu_torch.cli.codec_train import main
from funcodec_tpu_torch.data.wav_io import write_wav
from funcodec_tpu_torch.tasks.codec import build_codec_model
from funcodec_tpu_torch.train import checkpoint
from funcodec_tpu_torch.train.step import create_gan_train_state, make_gan_train_step, make_optimizer
from tests.test_trainer import TINY_CONFIG

torch.set_num_threads(1)

CONFIG = {**TINY_CONFIG, "use_tensorboard": False}
BEST = "valid.generator_multi_spectral_recon_loss.best.pth"


def _write_corpus(root: Path, lengths, config) -> Path:
    rng = np.random.RandomState(0)
    (root / "wavs").mkdir(parents=True, exist_ok=True)
    lines = []
    for i, t in enumerate(lengths):
        w = (0.2 * np.sin(2 * np.pi * (100 + 40 * i) * np.arange(t) / 16000) + 0.02 * rng.randn(t)).astype(np.float32)
        p = root / "wavs" / f"u{i}.wav"
        write_wav(p, w, 16000)
        lines.append(f"u{i} {p}")
    (root / "wav.scp").write_text("\n".join(lines) + "\n")
    (root / "config.yaml").write_text(yaml.safe_dump(config))
    return root


def _args(root: Path, out: Path, *extra):
    return ["--config", str(root / "config.yaml"), "--output_dir", str(out), "--train_wav_scp",
            str(root / "wav.scp"), "--valid_wav_scp", str(root / "wav.scp"), "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_trainer.py's corpus: 6 utterances of 4,096 + 512 i samples."""
    return _write_corpus(tmp_path_factory.mktemp("train"), [4096 + 512 * i for i in range(6)], CONFIG)


@pytest.fixture(scope="module")
def trained(corpus):
    out = corpus / "exp"
    main(_args(corpus, out))
    return out, json.loads((out / "reporter.json").read_text())


def test_codec_train_cli_end_to_end(trained):
    out, rep = trained
    # artifacts of the checkpoint contract (trainer.py:369-509), PyTorch names
    assert (out / "checkpoint.pth").exists()
    assert (out / "2epoch.pth").exists()
    assert (out / "latest.pth").is_symlink() and os.readlink(out / "latest.pth") == "2epoch.pth"
    assert (out / "config.yaml").exists()
    assert (out / BEST).is_symlink() and (out / BEST).exists()
    assert len(list(out.glob("*epoch.pth"))) <= 2  # keep_nbest_models 1: the best + the current epoch
    assert len(list((out / "valid_wavs").rglob("*.wav"))) >= 2
    assert set(rep["stats"]) == {"1", "2"} and rep["epoch"] == 2
    for epoch in ("1", "2"):
        for phase in ("train", "valid"):
            stats = rep["stats"][epoch][phase]
            assert stats and all(np.isfinite(v) for v in stats.values()), (epoch, phase)
    for k in ("lsd_db", "mel_distortion", "si_snr_db", "stoi", "nsim", "generator_multi_spectral_recon_loss"):
        assert k in rep["stats"]["2"]["valid"]
    state = torch.load(out / "checkpoint.pth", weights_only=True)
    assert state["step"] == 6
    assert state["opt_state_g"][0]["count"] == 6 and state["opt_state_d"][0]["count"] == 6


def test_resume_continues(corpus, trained):
    """Re-running with a higher max_epoch resumes from the checkpoint and
    leaves epochs 1-2 as they were."""
    out, rep = trained
    main(_args(corpus, out, "--max_epoch", "3"))
    assert (out / "3epoch.pth").exists()
    new = json.loads((out / "reporter.json").read_text())
    assert set(new["stats"]) == {"1", "2", "3"}
    assert new["stats"]["1"] == rep["stats"]["1"] and new["stats"]["2"] == rep["stats"]["2"]
    assert torch.load(out / "checkpoint.pth", weights_only=True)["step"] == 9


def test_trained_weights_serve_through_codec_inference(corpus, trained):
    out, _ = trained
    serve = corpus / "serve"
    codec_inference.main(["--config_file", str(out / "config.yaml"), "--model_file", str(out / "latest.pth"),
                          "--output_dir", str(serve), "--data_path_and_name_and_type",
                          f"{corpus / 'wav.scp'},speech,sound", "--batch_size", "2", "--device", "cpu",
                          "--bit_width", "16000"])
    lines = (serve / "codecs.txt").read_text().splitlines()
    assert len(lines) == 6
    s2t = codec_inference.Speech2Token(str(out / "config.yaml"), str(out / "latest.pth"), device="cpu")
    assert float(s2t.model.quantizer.state.inited.sum()) > 0  # codebooks were trained
    model, _ = build_codec_model(yaml.safe_load((out / "config.yaml").read_text()), device="cpu")
    checkpoint.load_checkpoint_params(str(out / "latest.pth"), model)
    for name, t in s2t.model.state_dict().items():
        assert torch.equal(t, model.state_dict()[name]), name
    x = torch.zeros(1, 2048) + 0.01
    res = s2t.model.inference(x)
    assert res["recon_speech"].shape == (1, 2048)


def test_average_checkpoints(tmp_path):
    model, _ = build_codec_model(CONFIG, device="cpu")
    paths = []
    for seed in (1, 2):
        m, _ = build_codec_model(CONFIG, device="cpu", generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            m.quantizer.state.embed.fill_(float(seed))
        paths.append(str(tmp_path / f"{seed}epoch.pth"))
        checkpoint.save_weights(paths[-1], m)
    avg = checkpoint.average_checkpoints(paths, model)
    a, b = (checkpoint.load_checkpoint_params(p) for p in paths)
    for name, _ in model.named_parameters():
        want = ((a[name].double() + b[name].double()) / 2).float()
        assert torch.equal(avg[name], want), name
    assert torch.equal(avg["quantizer.rq.model.embed"], a["quantizer.rq.model.embed"])
    model.load_state_dict(avg)


def test_shape_file_avoids_corpus_decode(corpus, tmp_path):
    """With a speech_shape file (reference abs_task.py:1177-1184),
    sorted/length batch building reads no audio."""
    from funcodec_tpu_torch.data.dataset import CodecDataset
    from funcodec_tpu_torch.train.gan_trainer import GANCodecTrainer, TrainerOptions

    shape_file = tmp_path / "speech_shape"
    shape_file.write_text("".join(f"u{i} {4096 + 512 * i}\n" for i in range(6)))
    model, disc = build_codec_model(CONFIG, device="cpu")

    class CountingDataset(CodecDataset):
        reads = 0

        def __getitem__(self, uttid):
            type(self).reads += 1
            return super().__getitem__(uttid)

    ds = CountingDataset([(str(corpus / "wav.scp"), "speech", "sound")])
    options = TrainerOptions(output_dir=str(tmp_path / "exp"), max_epoch=0, batch_size=2, batch_type="length",
                             batch_bins=16384, train_shape_file=str(shape_file), num_workers=0, resume=False,
                             use_tensorboard=False)
    trainer = GANCodecTrainer(model, disc, options)
    CountingDataset.reads = 0
    trainer.run(trainer.init_state(), ds, ds)
    assert CountingDataset.reads == 0, f"batch building decoded {CountingDataset.reads} utterances"


def test_codec_train_device_cache(corpus, tmp_path, monkeypatch):
    """device_cache + stats_interval 2: the corpus staged once, crops cut on
    the device, stats fetched every 2nd step (2 of 4 steps; one fetch per
    validation batch besides). The same checkpoint and reporter contract;
    RIR / noise augmentation is refused."""
    fetches = []
    real_fetch = gan_trainer.fetch_stats
    monkeypatch.setattr(gan_trainer, "fetch_stats", lambda stats: fetches.append(len(stats)) or real_fetch(stats))
    cfg = dict(CONFIG, device_cache=True, stats_interval=2, num_iters_per_epoch=4, max_epoch=1, log_interval=2)
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
    root = tmp_path
    (root / "wav.scp").write_text((corpus / "wav.scp").read_text())
    out = tmp_path / "exp"
    main(_args(root, out))
    assert len(fetches) == 2 + 3  # two training fetches, three validation batches
    assert (out / "1epoch.pth").exists()
    tr = json.loads((out / "reporter.json").read_text())["stats"]["1"]["train"]
    assert np.isfinite(tr["generator_loss"]) and np.isfinite(tr["discriminator_loss"])
    assert torch.load(out / "checkpoint.pth", weights_only=True)["step"] == 4
    (root / "config.yaml").write_text(yaml.safe_dump(dict(cfg, rir_scp=str(corpus / "wav.scp"))))
    with pytest.raises(ValueError, match="device_cache"):
        main(_args(root, tmp_path / "exp2"))


def test_print_config_dry_run_and_unported_flags(corpus, tmp_path, capsys, caplog):
    """--print_config, --dry_run, and --stat_flops (which raised until the
    tooling was ported, and now logs the cost tree at speech_max_length);
    the card by default, with no fallback to the CPU."""
    import logging

    from funcodec_tpu_torch.utils.misc import codec_flops_tree

    main(_args(corpus, tmp_path / "p", "--print_config", "--batch_size", "3"))
    printed = yaml.safe_load(capsys.readouterr().out)
    assert printed["batch_size"] == 3 and printed["encoder_conf"] == CONFIG["encoder_conf"]
    trainer, state = main(_args(corpus, tmp_path / "d", "--dry_run"))
    assert state.step == 0 and (tmp_path / "d" / "config.yaml").exists()
    assert not (tmp_path / "d" / "checkpoint.pth").exists()
    assert trainer.device == torch.device("cpu")
    with caplog.at_level(logging.INFO):
        _, state = main(_args(corpus, tmp_path / "f", "--stat_flops", "--dry_run"))
    trees = [r.getMessage() for r in caplog.records if "cost tree" in r.getMessage()]
    samples = CONFIG.get("speech_max_length", 16000)
    assert trees == ["\n" + codec_flops_tree(state.model, samples=samples)] and f"{samples} samples" in trees[0]
    if not torch.cuda.is_available():  # the card by default, and no fallback to the CPU
        args = _args(corpus, tmp_path / "c")[:-2]
        with pytest.raises(RuntimeError, match="is_available"):
            main(args)


# ---------------------------------------------------------------------------
# checkpoints and exact resume
# ---------------------------------------------------------------------------


def _tensors(tree, prefix=""):
    """{path: leaf} of a train-state dict (tensors, ints, generator states)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _tensors(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _tensors(v, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Generator):
        return {prefix: tree.get_state()}
    return {prefix: tree}


def _assert_same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        if isinstance(ta[k], torch.Tensor):
            assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k
        else:
            assert ta[k] == tb[k], k


def _live(state):
    """A live GANTrainState as a comparable dict (no file in between)."""
    return dict(step=state.step, model=state.model.state_dict(), discriminator=state.discriminator.state_dict(),
                opt_state_g=state.opt_state_g, opt_state_d=state.opt_state_d, gen_loss_carry=state.gen_loss_carry)


def _noisy_state(seed):
    model, disc = build_codec_model(CONFIG, device="cpu", generator=torch.Generator().manual_seed(seed))
    opt_g = make_optimizer(lr=1e-3, grad_noise=True, accum_grad=2, grad_clip=5.0)
    opt_d = make_optimizer(lr=1e-3, accum_grad=2, weight_decay=0.01)
    return create_gan_train_state(model, disc, opt_g, opt_d), make_gan_train_step(model, disc, opt_g, opt_d,
                                                                                shared_forward=True)


def test_train_state_save_load_bit_exact(tmp_path):
    """Every tensor, counter (Adam, multi_steps, learning-rate counts) and the
    gradient-noise generator's state come back bit for bit; the restored
    state then takes the same next step."""
    state, step = _noisy_state(0)
    x = {"speech": torch.from_numpy((0.3 * np.random.RandomState(0).randn(2, 4096)).astype(np.float32))}
    for i in range(3):
        state, _ = step(state, x, gan_trainer.step_generator(torch.device("cpu"), 0, i))
    path = tmp_path / "checkpoint.pth"
    checkpoint.save_train_state(str(path), state)
    other, other_step = _noisy_state(5)
    restored = checkpoint.load_train_state(str(path), other)
    _assert_same(_live(restored), _live(state))
    _assert_same(torch.load(path, weights_only=True), checkpoint.train_state_dict(state))
    assert restored.opt_state_g["mini_step"] == 1 and restored.opt_state_g["gradient_step"] == 1
    assert restored.opt_state_g["inner"][0]["count"] == 1  # the noise generator drew once
    a, _ = step(state, x, gan_trainer.step_generator(torch.device("cpu"), 0, 3))
    b, _ = other_step(restored, x, gan_trainer.step_generator(torch.device("cpu"), 0, 3))
    _assert_same(_live(b), _live(a))


def test_resume_is_exact(tmp_path):
    """2 epochs in one run against 1 epoch + resume + 1 epoch, with the
    recipe's draws on (k-means init, quantizer dropout): the same
    parameters, optimizer states, codebooks and carry, bit for bit."""
    cfg = dict(CONFIG, max_epoch=2, num_iters_per_epoch=2, num_valid_dump_wavs=1)
    root = _write_corpus(tmp_path / "c", [2048 + 512 * i for i in range(5)], cfg)  # all padded: no host draws
    main(_args(root, tmp_path / "one"))
    main(_args(root, tmp_path / "two", "--max_epoch", "1"))
    main(_args(root, tmp_path / "two", "--max_epoch", "2"))
    one = torch.load(tmp_path / "one" / "checkpoint.pth", weights_only=True)
    two = torch.load(tmp_path / "two" / "checkpoint.pth", weights_only=True)
    assert one["step"] == two["step"] == 4
    _assert_same(two, one)
    rep_one = json.loads((tmp_path / "one" / "reporter.json").read_text())["stats"]
    rep_two = json.loads((tmp_path / "two" / "reporter.json").read_text())["stats"]
    timing = ("iter_time", "step_time")
    for e in ("1", "2"):
        for phase in ("train", "valid"):
            assert ({k: v for k, v in rep_one[e][phase].items() if k not in timing}
                    == {k: v for k, v in rep_two[e][phase].items() if k not in timing}), (e, phase)


def test_packed_weight_caches_follow_in_place_updates():
    """The fused kernels' packed-weight caches key on (data_ptr, _version):
    after the optimizer's in-place update of the fp32 masters and the
    codebooks' commit, the next pack is a fresh one of the new values."""
    from funcodec_tpu_torch.models.seanet import SEANetResnetBlock
    from funcodec_tpu_torch.ops import conv_kernel, resblock_kernel
    from funcodec_tpu_torch.quant import rvq_kernel
    from funcodec_tpu_torch.quant.rvq import RVQConfig, RVQState, RVQTensors

    state, step = _noisy_state(0)
    block = next(m for m in state.model.modules() if isinstance(m, SEANetResnetBlock))
    convs = (block.block[1], block.block[3], block.shortcut)
    head = state.model.encoder.model[0]
    w, b = head.params()[:2]

    def packs():
        return (conv_kernel.packed_conv_weights(w, b, torch.float32, 0),
                resblock_kernel.packed_weights(*convs, torch.float32))

    before = packs()
    assert packs()[0] is before[0] and packs()[1] is before[1]  # a hit while nothing changed
    before_w = before[0]["w"].clone()  # an fp32 pack of a 1-channel conv is a view of the weight
    x = {"speech": torch.from_numpy((0.3 * np.random.RandomState(1).randn(2, 4096)).astype(np.float32))}
    for i in range(2):  # accum_grad 2: the second step updates the masters
        state, _ = step(state, x, gan_trainer.step_generator(torch.device("cpu"), 0, i))
    after = packs()
    for got, old in zip(after, before):
        assert got is not old
    with torch.no_grad():
        fresh_conv = conv_kernel.pack_weight(w, torch.float32, 0)
    assert torch.equal(after[0]["w"], fresh_conv) and not torch.equal(before_w, fresh_conv)
    assert torch.equal(after[1]["w1"], convs[0].params()[0].detach().permute(0, 2, 1))
    codebooks = RVQState(RVQConfig(dim=128, codebook_size=40, num_quantizers=2))  # k-means init: zeros
    first = rvq_kernel.prepared_codebooks(codebooks.embed)
    new = torch.randn(2, 40, 128, generator=torch.Generator().manual_seed(0))
    codebooks.commit(RVQTensors(torch.ones(2), torch.ones(2, 40), new, new.clone()))
    second = rvq_kernel.prepared_codebooks(codebooks.embed)
    assert second is not first and torch.equal(second["embed"], new.to(torch.bfloat16))


def test_profiler_window(tmp_path):
    from funcodec_tpu_torch.utils.profiling import StepTraceCapture

    off = StepTraceCapture(None)
    off.tick(5)
    off.stop()
    cap = StepTraceCapture(str(tmp_path / "prof"), start_step=0, num_steps=2)
    assert cap.start_step == 1  # step 0 is never traced
    for s in range(5):
        cap.tick(s)
        torch.randn(64, 64) @ torch.randn(64, 64)
    cap.stop()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert "Name" in (tmp_path / "prof" / "key_averages.txt").read_text()
