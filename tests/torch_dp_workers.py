"""The rank processes of tests/test_torch_dp.py.

A test writes a list of jobs, (function name, spec), to a file and spawns
``world`` processes (``parallel.dist.spawn_ranks``) that each join a gloo
group through a ``file://`` rendezvous, run every job on their rows and
save what it returns; the test runs the same functions with no group, in
its own process, for one process's result. The processes start from a
fresh import of this module, which imports no JAX (the JAX references run
in the test process), and each pins one thread.
"""

import functools
import sys

import torch

from funcodec_tpu_torch.parallel.dist import destroy_process_group, init_process_group, local_rows, shard_rows

CPU = torch.device("cpu")


def gan_steps(spec, group):
    """spec["steps"] shared GAN steps (train/step.py) of spec["config"]'s
    model from spec's weights (or the seeded ones) on this rank's rows of
    spec["speech"], each step drawing from step_generator(cpu, 7, step).
    Returns the model's and the discriminator's state_dicts and each step's
    stats."""
    from funcodec_tpu_torch.tasks.codec import build_codec_model
    from funcodec_tpu_torch.train.gan_trainer import step_generator
    from funcodec_tpu_torch.train.step import create_gan_train_state, make_gan_train_step, make_optimizer

    model, disc = build_codec_model(spec["config"], device=CPU, generator=torch.Generator().manual_seed(0))
    if spec.get("model_sd") is not None:
        model.load_state_dict(spec["model_sd"])
        disc.load_state_dict(spec["disc_sd"])
    opt_g, opt_d = (make_optimizer(lr=spec["lr"], name=spec["optim"]) for _ in range(2))
    state = create_gan_train_state(model, disc, opt_g, opt_d)
    step = make_gan_train_step(model, disc, opt_g, opt_d, shared_forward=True, group=group)
    speech = local_rows(torch.from_numpy(spec["speech"]), group)
    stats = []
    for i in range(spec["steps"]):
        state, s = step(state, {"speech": speech}, step_generator(CPU, 7, i))
        stats.append({k: float(v) for k, v in s.items()})
    return dict(model=model.state_dict(), disc=disc.state_dict(), stats=stats,
                carry=float(state.gen_loss_carry))


def laura_steps(spec, group):
    """spec["steps"] Laura train steps (LauraTrainer's, SGD lr 1e-2, clip 5)
    of spec["config"]'s model from spec["model_sd"] on this rank's rows of
    spec["batch"] (not bucketed), drawing from step_generator(cpu, 11, step)
    or, given spec["uniforms"][step], the sampler's uniforms (the global
    batch's). Returns the model's state_dict and each step's stats."""
    from funcodec_tpu_torch.tasks.text2audio import build_laura_model
    from funcodec_tpu_torch.train.gan_trainer import step_generator
    from funcodec_tpu_torch.train.laura_trainer import LauraTrainer, LauraTrainerOptions

    model = build_laura_model(spec["config"], device=CPU)
    model.load_state_dict(spec["model_sd"])
    options = LauraTrainerOptions(optim="sgd", optim_conf={"lr": 1e-2}, scheduler=None, grad_clip=5.0)
    trainer = LauraTrainer(model, options, group=group)
    state = trainer.init_state()
    sampler = model.prob_sampler
    stats = []
    for i in range(spec["steps"]):
        if spec.get("uniforms") is not None:
            model.prob_sampler = functools.partial(sampler, uniform=torch.from_numpy(spec["uniforms"][i]))
        state, s = trainer.train_step(state, shard_rows(spec["batch"], group, CPU), step_generator(CPU, 11, i))
        stats.append({k: float(v) for k, v in s.items()})
    return dict(model=model.state_dict(), stats=stats)


def codec_train_rank(spec):
    """One rank of cli/codec_train through the CLI's own rank entry (which
    joins spec["init_method"]), recording to spec["writes"] which rank
    writes a train state."""
    import funcodec_tpu_torch.train.gan_trainer as gan_trainer
    from funcodec_tpu_torch.cli import codec_train

    rank, world = spec["rank"], spec["world"]
    save = gan_trainer.save_train_state

    def recorded(path, state):
        with open(spec["writes"], "a") as f:
            f.write(f"{rank} {path}\n")
        save(path, state)

    gan_trainer.save_train_state = recorded
    codec_train._rank_main(rank, world, spec["argv"], spec["init_method"], 1)
    return {}


def rank_main(rank: int, world: int, init_method: str, jobs_path: str, out_dir: str) -> None:
    """Run the jobs of jobs_path on this rank; save [results] to out_dir/rank{rank}.pt."""
    torch.set_num_threads(1)
    jobs = torch.load(jobs_path, weights_only=False)  # written by the test that spawned this
    if jobs[0][0] == "codec_train_rank":  # the CLI's entry joins the group itself
        results = [codec_train_rank(dict(spec, rank=rank, world=world, init_method=init_method)) for _, spec in jobs]
    else:
        group = init_process_group(CPU, init_method=init_method, world_size=world, rank=rank, timeout_s=120)
        try:
            results = [globals()[name](spec, group) for name, spec in jobs]
        finally:
            destroy_process_group(group)
    torch.save(dict(results=results, jax_imported="jax" in sys.modules), f"{out_dir}/rank{rank}.pt")

