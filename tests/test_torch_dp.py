"""Data parallelism in the port (parallel/dist.py) against one process and
against the JAX package's "data" mesh, on the CPU.

The port's ranks are spawned processes in a gloo group (a ``file://``
rendezvous under tmp_path, a 120 s group timeout, a join timeout), each with
one thread; they run tests/torch_dp_workers.py, which imports no JAX. One
process's run and the JAX references run in the test process (the JAX mesh
on the 8 CPU devices of tests/conftest.py).

- The GAN step (tests/test_dp_exactness.py's ``_gan_setup`` model, SGD lr
  1e-2, 3 shared steps, B = 8): at world 2 and 4 with k-means init and
  "effective" expiry (the global draws), against world 1 within JAX's own
  rtol 2e-4, atol 2e-5 (params, discriminator params, codebooks, stats),
  every rank's parameters and codebooks bit for bit equal; and, with no
  draws (k-means off, expiry "reference") and Adam lr 1e-3, against JAX's
  jitted step on a mesh of the same size within the two-step parity's
  0.05 lr (tests/test_torch_gan_two_steps.py, its norm-removed bias
  exempted by name).
- The Laura step (tests/test_dp_exactness.py's batch: 8 rows whose two
  halves hold 37 and 33 codec tokens; SGD lr 1e-2, clip 5; scheduled
  sampling at 0.5): at world 2 against world 1 with the port's draws, and
  against JAX's 2-device mesh with JAX's uniforms fed in, within rtol 2e-4,
  atol 2e-5; ranks bit for bit equal.
- cli/codec_train at world 2 (``--device cpu --data_parallel 2``): two
  epochs in which rank 0 alone writes checkpoint.pth, then a resume to
  epoch 3 through ``main`` (which spawns), against one process's
  uninterrupted three epochs.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dp_workers as workers
from funcodec_tpu.parallel.mesh import data_mesh, put_batch
from funcodec_tpu.train import step as jstep
from funcodec_tpu_torch.parallel import dist
from test_torch_gan_step import build_pair
from test_torch_gan_two_steps import _norm_removed_biases

torch.set_num_threads(1)

K_STEPS = 3
RTOL, ATOL = 2e-4, 2e-5  # tests/test_dp_exactness.py
JOIN_TIMEOUT_S = 300
ADAM_LR = 1e-3


def spawn(tmp_path: Path, world: int, jobs):
    """Run `jobs` on `world` spawned ranks: [each rank's results]."""
    d = Path(tmp_path) / f"world{world}"
    d.mkdir(parents=True, exist_ok=True)
    torch.save(jobs, d / "jobs.pt")
    dist.spawn_ranks(workers.rank_main, world, (dist.file_init_method(d), str(d / "jobs.pt"), str(d)),
                     timeout_s=JOIN_TIMEOUT_S)
    out = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]
    assert not any(o["jax_imported"] for o in out)  # the ranks never imported JAX
    return [o["results"] for o in out]


def assert_ranks_equal(results, keys):
    """Every rank's tensors under `keys` bit for bit equal to rank 0's."""
    for r, res in enumerate(results[1:], 1):
        for key in keys:
            for name, t in res[key].items():
                assert torch.equal(t, results[0][key][name]), (r, key, name)


def assert_close(got, want, what):
    for name, t in want.items():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"{what} {name}")


def assert_stats_close(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL, err_msg=f"step {i} {k}")


# ---------------------------------------------------------------------------
# helpers without a process group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 2, 6, 8, 9, 12, 16, 15])
@pytest.mark.parametrize("max_devices", [1, 3, 4, 8])
def test_world_size_is_the_data_mesh_rule(batch, max_devices):
    mesh = data_mesh(batch, max_devices)
    assert dist.data_world_size(batch, max_devices) == (1 if mesh is None else mesh.devices.size)


def test_rows_are_partition_spec_data_blocks():
    x = np.arange(24).reshape(8, 3)
    groups = [dist.DataGroup(rank=r, world=4, device=torch.device("cpu"), backend="gloo") for r in range(4)]
    blocks = [dist.local_rows(x, g) for g in groups]
    np.testing.assert_array_equal(np.concatenate(blocks), x)
    assert all(b.shape == (2, 3) for b in blocks)
    with pytest.raises(ValueError):
        dist.local_rows(x[:7], groups[0])
    uneven = [dist.local_rows(list(range(7)), g, uneven=True) for g in groups]
    assert uneven == [[0, 1], [2, 3], [4, 5], [6]]
    assert [dist.local_rows([9], g, uneven=True) for g in groups] == [[9], [], [], []]
    # a draw at the global shape, split: one process's draw
    whole = torch.rand(8, 5, generator=torch.Generator().manual_seed(3))
    parts = [dist.draw_rows(lambda n: torch.rand(n, 5, generator=torch.Generator().manual_seed(3)), 2, g)
             for g in groups]
    assert torch.equal(torch.cat(parts), whole)
    idx = torch.tensor([0, 3, 5, 7])
    local, mine = dist.owned_rows(idx, 2, groups[2])
    assert mine.tolist() == [False, False, True, False] and local.tolist()[2] == 1
    assert dist.is_writer(None) and dist.is_writer(groups[0]) and not dist.is_writer(groups[1])
    assert dist.backend_for("cpu") == "gloo" and dist.backend_for("cuda:1") == "nccl"


def test_device_cache_cuts_each_rank_its_rows(tmp_path):
    """Every rank stages the corpus and cuts its block of each batch's crops,
    at the offsets one process draws."""
    from funcodec_tpu_torch.data.dataset import CodecDataset
    from funcodec_tpu_torch.data.device_cache import DeviceCachedCrops
    from funcodec_tpu_torch.data.wav_io import write_wav

    rs = np.random.RandomState(0)
    lines = []
    for i in range(6):
        write_wav(tmp_path / f"u{i}.wav", (0.1 * rs.randn(800 + 300 * i)).astype(np.float32), 16000)
        lines.append(f"u{i} {tmp_path / f'u{i}.wav'}")
    (tmp_path / "wav.scp").write_text("\n".join(lines) + "\n")
    ds = CodecDataset([(str(tmp_path / "wav.scp"), "speech", "sound")])
    ids = [f"u{i}" for i in range(6)]
    cache = DeviceCachedCrops(ds, ids, crop_len=1000, seed=3, device="cpu")
    batches = [ids[:4], ids[2:]]
    whole = list(cache.epoch_loader(batches, 2))
    groups = [dist.DataGroup(rank=r, world=2, device=torch.device("cpu"), backend="gloo") for r in range(2)]
    parts = [list(cache.epoch_loader(batches, 2, g)) for g in groups]
    for b, (keys, batch) in enumerate(whole):
        assert parts[0][b][0] + parts[1][b][0] == keys
        assert torch.equal(torch.cat([parts[0][b][1]["speech"], parts[1][b][1]["speech"]]), batch["speech"])


def test_codec_train_world_size_is_make_meshs():
    from funcodec_tpu_torch.cli.codec_train import world_size

    cpu = torch.device("cpu")
    assert world_size(16, cpu, -1) == 1  # the CPU: one process unless asked
    assert world_size(16, cpu, 4) == 4 and world_size(6, cpu, 4) == 3 and world_size(7, cpu, 4) == 1
    assert world_size(16, torch.device("cuda"), -1) == max(1, torch.cuda.device_count())


# ---------------------------------------------------------------------------
# the GAN step
# ---------------------------------------------------------------------------


def gan_config(kmeans_init: bool, expiry_mode: str) -> dict:
    """tests/test_dp_exactness.py's _gan_setup as a config dict."""
    seanet = {"norm": "time_group_norm", "n_filters": 4, "ratios": [4, 2]}
    return {
        "encoder_conf": dict(seanet), "decoder_conf": dict(seanet),
        "quantizer_conf": {"codebook_size": 16, "num_quantizers": 4, "ema_decay": 0.9, "kmeans_init": kmeans_init,
                           "sampling_rate": 16000, "encoder_hop_length": 8, "expiry_mode": expiry_mode},
        "model_conf": {"odim": 16, "multi_spectral_window_powers_of_two": [5, 6]},
        "discriminator_conf": {"disc_conf_list": [{
            "name": "encodec_multi_scale_stft_discriminator", "filters": 4, "n_ffts": [256], "hop_lengths": [64],
            "win_lengths": [256]}]},
    }


SPEECH = (np.random.RandomState(0).randn(8, 1024) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def gan_specs():
    """(the drawn spec: k-means and effective expiry from seeded weights,
    the JAX pair of the no-draw spec and that spec: JAX's weights, Adam)."""
    drawn = dict(config=gan_config(True, "effective"), speech=SPEECH, steps=K_STEPS, lr=1e-2, optim="sgd")
    pair = build_pair(gan_config(False, "reference"))
    plain = dict(config=gan_config(False, "reference"), speech=SPEECH, steps=K_STEPS, lr=ADAM_LR, optim="adam",
                 model_sd=pair.tm.state_dict(), disc_sd=pair.tdisc.state_dict())
    return drawn, pair, plain


@pytest.fixture(scope="module")
def gan_world1(gan_specs):
    return workers.gan_steps(gan_specs[0], None)


@pytest.fixture(scope="module", params=[2, 4])
def gan_world(request, gan_specs, tmp_path_factory):
    drawn, _, plain = gan_specs
    world = request.param
    return world, spawn(tmp_path_factory.mktemp("gan"), world, [("gan_steps", drawn), ("gan_steps", plain)])


def test_gan_step_dp_matches_one_process(gan_world, gan_world1):
    """k-means init on the global latents and effective expiry over the
    global rows: the trajectory of one process, ranks bit for bit equal."""
    world, results = gan_world
    ranks = [r[0] for r in results]
    one = gan_world1
    assert_ranks_equal(ranks, ("model", "disc"))
    assert_stats_close(ranks[0]["stats"], one["stats"])
    assert_close(ranks[0]["model"], one["model"], f"world {world} generator")  # the codebooks among them
    assert_close(ranks[0]["disc"], one["disc"], f"world {world} discriminator")
    assert float(ranks[0]["model"]["quantizer.rq.model.inited"].min()) == 1.0  # k-means ran
    assert all(r["stats"] == ranks[0]["stats"] for r in ranks)


def _jax_mesh_steps(pair, world):
    mesh = Mesh(np.array(jax.devices()[:world]), axis_names=("data",))
    opt_g, opt_d = jstep.make_optimizer(lr=ADAM_LR), jstep.make_optimizer(lr=ADAM_LR)
    state = jstep.create_gan_train_state(pair.params, pair.disc_params, pair.state, opt_g, opt_d)
    rep, dsh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    step = jax.jit(jstep.make_gan_train_step(pair.jm, pair.jdisc, opt_g, opt_d, shared_forward=True),
                   in_shardings=(rep, {"speech": dsh}, rep), out_shardings=(rep, rep))
    stats = []
    for _ in range(K_STEPS):
        state, s = step(state, put_batch({"speech": SPEECH}, mesh), jax.random.PRNGKey(7))
        stats.append({k: float(v) for k, v in jax.device_get(s).items()})
    return jax.device_get(state), stats


def test_gan_step_dp_matches_the_jax_mesh(gan_world, gan_specs):
    """No draws, Adam: the port's ranks against JAX's jitted step on a mesh
    of the same size."""
    world, results = gan_world
    _, pair, _ = gan_specs
    ranks = [r[1] for r in results]
    assert_ranks_equal(ranks, ("model", "disc"))
    j_state, j_stats = _jax_mesh_steps(pair, world)
    port = ranks[0]
    for i, (t, j) in enumerate(zip(port["stats"], j_stats)):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=2e-3, atol=1e-5, err_msg=f"step {i} {k}")
    exempt = _norm_removed_biases(pair.tm)
    for what, got, want in (("generator", port["model"], pair.port_params(j_state.params)),
                            ("discriminator", port["disc"], pair.port_disc_params(j_state.disc_params))):
        for name, ref in want.items():
            if name in exempt:
                assert torch.isfinite(got[name]).all(), name
                continue
            d = np.abs(got[name].numpy() - np.asarray(ref)).max() / ADAM_LR
            assert d <= 0.05, f"{what} {name}: {d} lr"
    for name in ("cluster_size", "embed", "embed_avg", "inited"):
        np.testing.assert_allclose(port["model"][f"quantizer.rq.model.{name}"].numpy(),
                                   np.asarray(getattr(j_state.rvq_state, name)), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the Laura step
# ---------------------------------------------------------------------------


def _laura_batch():
    """tests/test_dp_exactness.py's batch at the port's tiny Laura widths:
    the two halves hold 37 and 33 codec tokens."""
    from test_torch_laura import BINS, DIN, NQ

    rs = np.random.RandomState(0)
    return dict(text=rs.randn(8, 6, DIN).astype(np.float32),
                text_lengths=np.array([6, 5, 4, 6, 6, 3, 5, 6]),
                codec=rs.randint(0, BINS, (8, 10, NQ)),
                codec_lengths=np.array([10, 8, 9, 10, 7, 10, 6, 10]))


@pytest.fixture(scope="module")
def laura_pair_and_specs():
    from test_torch_laura import laura_pair
    from test_torch_laura_train import config as laura_config

    cfg = laura_config("uni", ratio=0.5)
    jm, params, tm = laura_pair(cfg, seed=5)
    batch = _laura_batch()
    base = dict(config=cfg, model_sd=tm.state_dict(), batch=batch, steps=K_STEPS)
    # JAX's sampler uniforms of each step: the trainer's key fold_in(rng, step), its first split
    keys = [jax.random.split(jax.random.fold_in(jax.random.PRNGKey(11), t))[0] for t in range(K_STEPS)]
    uniforms = np.stack([np.asarray(jax.random.uniform(k, (8, 10, 2))) for k in keys])
    return jm, params, tm, base, dict(base, uniforms=uniforms)


@pytest.fixture(scope="module")
def laura_world2(laura_pair_and_specs, tmp_path_factory):
    *_, drawn, fed = laura_pair_and_specs
    return spawn(tmp_path_factory.mktemp("laura"), 2, [("laura_steps", drawn), ("laura_steps", fed)])


def test_laura_step_dp_matches_one_process(laura_world2, laura_pair_and_specs):
    """The port's draws at the global shape, global denominators: the
    trajectory of one process; ranks bit for bit equal."""
    *_, drawn, _ = laura_pair_and_specs
    ranks = [r[0] for r in laura_world2]
    one = workers.laura_steps(drawn, None)
    assert_ranks_equal(ranks, ("model",))
    assert_stats_close(ranks[0]["stats"], one["stats"])
    assert_close(ranks[0]["model"], one["model"], "laura")
    assert all(r["stats"] == ranks[0]["stats"] for r in ranks)


def test_laura_step_dp_matches_the_jax_mesh(laura_world2, laura_pair_and_specs):
    """JAX's uniforms fed in: the port's two ranks against JAX's trainer
    step on a 2-device mesh (tests/test_dp_exactness.py's _run_laura)."""
    from funcodec_tpu.train.laura_trainer import LauraTrainer, LauraTrainerOptions, TrainState
    from funcodec_tpu_torch.compat.from_jax import laura_state_dict_from_jax
    from test_torch_transformer import np_tree

    jm, params, tm, base, _ = laura_pair_and_specs
    ranks = [r[1] for r in laura_world2]
    assert_ranks_equal(ranks, ("model",))
    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("data",))
    jt = LauraTrainer(jm, LauraTrainerOptions(optim="sgd", optim_conf={"lr": 1e-2}, scheduler=None, grad_clip=5.0),
                      mesh=mesh)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(step=jnp.int32(0), params=jparams, opt_state=jt.optimizer.init(jparams))
    step = jt._step_fn()
    j_stats = []
    for _ in range(K_STEPS):
        state, s = step(state, put_batch(base["batch"], mesh), jax.random.PRNGKey(11))
        j_stats.append({k: float(v) for k, v in jax.device_get(s).items()})
    assert_stats_close(ranks[0]["stats"], j_stats)
    ref = laura_state_dict_from_jax(tm, np_tree(jax.device_get(state.params)))
    assert_close(ranks[0]["model"], ref, "laura vs JAX")


def test_laura_unequal_token_counts_need_global_denominators(laura_pair_and_specs):
    """The batch's halves hold unequal token counts, so the mean of the two
    halves' own losses (local denominators) is not the global loss: the
    tests above would see local denominators."""
    from funcodec_tpu_torch.parallel.dist import local_rows

    *_, tm, base, _ = laura_pair_and_specs
    batch = {k: torch.from_numpy(v) for k, v in base["batch"].items()}
    halves = [{k: local_rows(v, dist.DataGroup(r, 2, torch.device("cpu"), "gloo")) for k, v in batch.items()}
              for r in range(2)]
    assert [int(h["codec_lengths"].sum()) for h in halves] == [37, 33]
    cfg = tm.cfg
    tm.cfg = dataclasses.replace(cfg, codec_sampling_ratio=1.0)  # no draws: the ground truth
    try:
        with torch.no_grad():
            whole = float(tm(*batch.values(), None)[0])
            local = [float(tm(*h.values(), None)[0]) for h in halves]
    finally:
        tm.cfg = cfg
    # the local-denominator loss misses the global one by more than twice the tolerance held above
    assert abs(sum(local) / 2 - whole) > 2 * (ATOL + RTOL * abs(whole))


# ---------------------------------------------------------------------------
# cli/codec_train
# ---------------------------------------------------------------------------


def test_codec_train_world2_writes_once_and_resumes(tmp_path):
    """Two epochs at world 2 (rank 0 alone writes the train state), then a
    resume to epoch 3 through main, which spawns the ranks: bit for bit
    the state of three uninterrupted epochs at world 2, and the training
    stats of one process's within the tolerance above (SGD; a corpus no
    longer than the crop, so the host draws nothing). Batch 4: two rows a
    rank (torch's CPU convolution takes another path for one row, and its
    last-bit differences flip k-means ties between the zero-padded frames'
    equal latents); validation's last batch of one row leaves rank 1 none."""
    from funcodec_tpu_torch.cli.codec_train import main
    from test_torch_trainer import CONFIG, _args, _assert_same, _write_corpus

    cfg = dict(CONFIG, max_epoch=2, num_iters_per_epoch=1, num_valid_dump_wavs=1, batch_size=4, optim="sgd",
               optim2="sgd", optim_conf={"lr": 1e-2}, optim2_conf={"lr": 1e-2})
    root = _write_corpus(tmp_path / "c", [2048 + 512 * i for i in range(5)], cfg)
    resumed, whole, one = tmp_path / "resumed", tmp_path / "whole", tmp_path / "one"
    writes = tmp_path / "writes.txt"
    spawn(tmp_path / "ranks", 2, [("codec_train_rank", dict(argv=_args(root, resumed, "--data_parallel", "2"),
                                                            writes=str(writes)))])
    lines = writes.read_text().splitlines()
    assert [line.split()[0] for line in lines] == ["0", "0"]  # rank 0, once an epoch
    assert all(line.endswith("checkpoint.pth") for line in lines)
    rep2 = json.loads((resumed / "reporter.json").read_text())
    assert main(_args(root, resumed, "--data_parallel", "2", "--max_epoch", "3")) is None  # spawned
    assert main(_args(root, whole, "--data_parallel", "2", "--max_epoch", "3")) is None
    a = torch.load(resumed / "checkpoint.pth", weights_only=True)
    assert a["step"] == 3
    _assert_same(a, torch.load(whole / "checkpoint.pth", weights_only=True))
    rep3 = json.loads((resumed / "reporter.json").read_text())
    assert rep3["epoch"] == 3 and {e: rep3["stats"][e] for e in ("1", "2")} == rep2["stats"]
    main(_args(root, one, "--max_epoch", "3"))
    ref = json.loads((one / "reporter.json").read_text())["stats"]
    for e in ("1", "2", "3"):
        for k, v in ref[e]["train"].items():
            if k not in ("iter_time", "step_time"):
                np.testing.assert_allclose(rep3["stats"][e]["train"][k], v, rtol=RTOL, atol=ATOL, err_msg=(e, k))
        key = "generator_multi_spectral_recon_loss"
        np.testing.assert_allclose(rep3["stats"][e]["valid"][key], ref[e]["valid"][key], rtol=RTOL, atol=ATOL)
    assert (resumed / "3epoch.pth").exists() and (resumed / "latest.pth").is_symlink()
    assert yaml.safe_load((resumed / "config.yaml").read_text())["batch_size"] == 4
