"""The GAN training step (port of funcodec_tpu/train/step.py).

``make_gan_train_step`` returns step(state, batch, generator) -> (state,
stats), one optimizer turn of the discriminator then one of the generator
(gated by ``disc_train_interval`` and ``gen_train_interval``), with the
adaptive gate's carry (``gen_loss_carry``) in the state. With
``shared_forward`` the generator's encode -> RVQ -> decode runs once a step
and its detached reconstruction feeds the discriminator turn; otherwise the
discriminator turn runs its own generator forward, as the reference's
two-forward step does (so the RVQ EMA advances twice a step).

The modules own the fp32 master parameters and the RVQ buffers; the step
updates them in place. ``compute_dtype=torch.bfloat16`` runs each forward
and backward on bf16 copies of the parameters and of the batch
(``torch.func.functional_call``), so the gradients arrive in fp32 on the
masters; the RVQ buffers are not cast, and the fp32 islands of
models/encodec.py, ops/stft.py and quant/rvq.py stay where they are (no
autocast).

A turn whose global gradient norm is not finite changes nothing: not the
parameters, not the optimizer state, not the RVQ buffers (the new codebook
state is computed out of place and committed after the gate).

``make_optimizer`` builds the optimizers of the reference's registry names
as functional transformations (init(params) -> state; update(grads, state,
params) -> (updates, state)) with optax's arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.func import functional_call

from funcodec_tpu_torch.quant.rvq import codebook_health

Tensors = List[torch.Tensor]


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


class GradientTransformation(NamedTuple):
    """init(params) -> state; update(grads, state, params) -> (updates,
    state), over lists of tensors, out of place (optax's contract)."""

    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors], Tuple[Tensors, Any]]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def add_noise(eta: float, gamma: float, seed: int = 0) -> GradientTransformation:
    """Annealed gradient noise N(0, eta / (1 + t)^gamma) (optax.add_noise),
    drawn from a torch.Generator on the parameters' device seeded with `seed`."""

    def init(params):
        return dict(count=0, generator=torch.Generator(device=params[0].device).manual_seed(seed))

    def update(updates, state, params):
        count = state["count"] + 1
        std = (eta / count**gamma) ** 0.5
        gen = state["generator"]
        noisy = [u + std * torch.randn(u.shape, generator=gen, device=u.device, dtype=u.dtype) for u in updates]
        return noisy, dict(count=count, generator=gen)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale the updates to global norm max_norm where it is larger (optax)."""

    def update(updates, state, params):
        g_norm = global_norm(updates)
        scale = torch.where(g_norm < max_norm, torch.ones_like(g_norm), max_norm / g_norm)
        return torch._foreach_mul(updates, scale), state

    return GradientTransformation(lambda params: (), update)


def scale_by_adam(b1: float, b2: float, eps: float) -> GradientTransformation:
    """Adam's bias-corrected moment ratio mu_hat / (sqrt(nu_hat) + eps)."""

    def init(params):
        return dict(count=0, mu=[torch.zeros_like(p) for p in params], nu=[torch.zeros_like(p) for p in params])

    def update(updates, state, params):
        mu = torch._foreach_mul(state["mu"], b1)
        torch._foreach_add_(mu, torch._foreach_mul(updates, 1.0 - b1))
        nu = torch._foreach_mul(state["nu"], b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(updates, updates), 1.0 - b2))
        count = state["count"] + 1
        mu_hat = torch._foreach_div(mu, 1.0 - b1**count)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - b2**count))
        torch._foreach_add_(denom, eps)
        return torch._foreach_div(mu_hat, denom), dict(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params):
        return torch._foreach_add(updates, torch._foreach_mul(params, weight_decay)), state

    return GradientTransformation(lambda params: (), update)


def trace(momentum: float) -> GradientTransformation:
    """Heavy-ball momentum: t = g + momentum * t."""

    def init(params):
        return [torch.zeros_like(p) for p in params]

    def update(updates, state, params):
        t = torch._foreach_add(updates, torch._foreach_mul(state, momentum))
        return t, t

    return GradientTransformation(init, update)


def scale_by_learning_rate(lr: float, schedule: Optional[Callable[[int], float]] = None) -> GradientTransformation:
    """updates * -lr, or * -schedule(count) with count the updates so far."""

    def update(updates, state, params):
        rate = schedule(state) if schedule is not None else lr
        return torch._foreach_mul(updates, -float(rate)), state + 1

    return GradientTransformation(lambda params: 0, update)


def multi_steps(inner: GradientTransformation, every_k: int) -> GradientTransformation:
    """Gradient accumulation (optax.MultiSteps, grad mean): the inner
    optimizer steps on the mean of every `every_k` gradients; the updates
    in between are zero."""

    def init(params):
        return dict(mini_step=0, gradient_step=0, inner=inner.init(params),
                    acc=[torch.zeros_like(p) for p in params])

    def update(updates, state, params):
        n = state["mini_step"]
        acc = torch._foreach_add(state["acc"], torch._foreach_div(torch._foreach_sub(updates, state["acc"]), n + 1))
        if n < every_k - 1:
            return ([torch.zeros_like(u) for u in updates],
                    dict(state, mini_step=n + 1, acc=acc))
        final, new_inner = inner.update(acc, state["inner"], params)
        return final, dict(mini_step=0, gradient_step=state["gradient_step"] + 1, inner=new_inner,
                           acc=[torch.zeros_like(a) for a in acc])

    return GradientTransformation(init, update)


def make_optimizer(
    lr: float = 3e-4,
    betas: Tuple[float, float] = (0.5, 0.9),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: float = -1.0,
    schedule: Optional[Callable[[int], float]] = None,
    accum_grad: int = 1,
    grad_noise: bool = False,
    name: str = "adam",
    momentum: float = 0.0,
) -> GradientTransformation:
    """The optimizer of a reference registry name, as funcodec_tpu maps them
    onto optax: adam / adamw; fairseq_adam (Adam with decoupled weight
    decay, i.e. adamw when weight_decay > 0); lazy_adamw (adamw: the
    gradients are dense); sgd with momentum. Optionally annealed gradient
    noise, a global-norm clip, a learning-rate `schedule` (a function of the
    update count) and `accum_grad` gradient accumulation."""
    parts = []
    if grad_noise:
        parts.append(add_noise(eta=0.01, gamma=0.55, seed=0))
    if grad_clip and grad_clip > 0:
        parts.append(clip_by_global_norm(grad_clip))
    name = (name or "adam").lower()
    if name == "sgd":
        if momentum:
            parts.append(trace(momentum))
    elif name in ("adamw", "lazy_adamw") or (name in ("adam", "fairseq_adam") and weight_decay > 0):
        parts += [scale_by_adam(betas[0], betas[1], eps), add_decayed_weights(weight_decay)]
    elif name in ("adam", "fairseq_adam"):
        parts.append(scale_by_adam(betas[0], betas[1], eps))
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    parts.append(scale_by_learning_rate(lr, schedule))
    opt = chain(*parts)
    if accum_grad and accum_grad > 1:
        opt = multi_steps(opt, accum_grad)
    return opt


def apply_updates_if_finite(optimizer: GradientTransformation, grads: Tensors, opt_state, params: Tensors):
    """The optimizer step, gated on a finite global gradient norm: when the
    norm is inf or NaN nothing is applied and the optimizer state stays as
    it was. `params` are updated in place. Returns (opt_state, grad_norm,
    is_finite)."""
    grad_norm = global_norm(grads)
    is_finite = bool(torch.isfinite(grad_norm))
    if is_finite:
        updates, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            torch._foreach_add_(params, updates)
    return opt_state, grad_norm, is_finite


def cast_floating(tree, dtype: Optional[torch.dtype]):
    """fp32 tensors of a dict / list / tuple tree cast to `dtype` (a
    differentiable cast); other tensors and a None dtype leave it as it is."""
    if dtype is None:
        return tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(dtype)
    return tree


# ---------------------------------------------------------------------------
# the train state and step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GANTrainState:
    """The step count, the two modules (their parameters are the fp32
    masters, the model's quantizer holds the RVQ buffers), the optimizer
    states and the discriminator gate's carry (fp32, on the device)."""

    step: int
    model: nn.Module
    discriminator: nn.Module
    opt_state_g: Any
    opt_state_d: Any
    gen_loss_carry: torch.Tensor

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def disc_params(self) -> Dict[str, torch.Tensor]:
        return dict(self.discriminator.named_parameters())

    @property
    def rvq_state(self):
        return self.model.quantizer.state


def create_gan_train_state(model: nn.Module, discriminator: nn.Module, optimizer_g: GradientTransformation,
                           optimizer_d: GradientTransformation) -> GANTrainState:
    device = next(model.parameters()).device
    return GANTrainState(
        step=0,
        model=model,
        discriminator=discriminator,
        opt_state_g=optimizer_g.init(list(model.parameters())),
        opt_state_d=optimizer_d.init(list(discriminator.parameters())),
        gen_loss_carry=torch.zeros((), device=device),
    )


def _grads(loss: torch.Tensor, params: Sequence[torch.Tensor]) -> Tensors:
    grads = torch.autograd.grad(loss, list(params), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def _detached(module: nn.Module, compute_dtype: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    return cast_floating({n: p.detach() for n, p in module.named_parameters()}, compute_dtype)


def _disc_fn(discriminator: nn.Module, params: Dict[str, torch.Tensor]):
    return lambda x: functional_call(discriminator, params, (x,))


def generator_grads(model: nn.Module, discriminator: nn.Module, speech: torch.Tensor,
                    generator: torch.Generator, compute_dtype: Optional[torch.dtype] = None):
    """The generator turn's forward and backward: forward_generator on
    `compute_dtype` copies of the model's parameters and of the batch, the
    discriminator's parameters detached. Returns (out, gradients of the
    master parameters in named_parameters order)."""
    names, params = zip(*model.named_parameters())
    c_params = cast_floating(dict(zip(names, params)), compute_dtype)
    loss, out = functional_call(model, c_params, ("forward_generator",
                                                  _disc_fn(discriminator, _detached(discriminator, compute_dtype)),
                                                  cast_floating(speech, compute_dtype), generator))
    return out, _grads(loss, params)


def _zero_disc_stats(device, pit: bool = False) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), device=device)
    stats = dict(discriminator_total_loss=z, discriminator_loss=z, discriminator_grad_norm=z,
                 discriminator_nonfinite_skip=z)
    if pit:
        stats["pit_disc_loss"] = z
    return stats


def _zero_gen_stats(device) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), device=device)
    return dict(generator_loss=z, generator_recon_loss=z, generator_multi_spectral_recon_loss=z,
                generator_adv_loss=z, generator_feat_match_loss=z, generator_commit_loss=z,
                generator_enc_quant_loss=z, generator_grad_norm=z, generator_nonfinite_skip=z)


def _skip(finite: bool, device) -> torch.Tensor:
    return torch.tensor(0.0 if finite else 1.0, device=device)


def make_gan_train_step(
    model: nn.Module,
    discriminator: nn.Module,
    optimizer_g: GradientTransformation,
    optimizer_d: GradientTransformation,
    gen_train_interval: int = 1,
    disc_train_interval: int = 1,
    compute_dtype: Optional[torch.dtype] = None,
    shared_forward: bool = False,
):
    """step(state, {"speech": (B, T) fp32}, generator) -> (state, stats).

    ``shared_forward=False`` is the reference's two-forward step: the
    discriminator turn (its own generator forward without grad, the RVQ EMA
    advancing), then the generator turn against the updated discriminator.
    ``shared_forward=True`` runs one generator forward and backward a step
    and trains the discriminator on its detached reconstruction; the RVQ
    EMA advances once and the generator's adversarial loss sees the step's
    first discriminator (funcodec_tpu train/step.py shared_train_step).
    `generator` is the torch.Generator of the quantizer's draws.
    """

    pit = bool(getattr(model.cfg, "phase_invariant_training", False))

    def masters(module: nn.Module) -> Tensors:
        return list(module.parameters())

    def cast_params(module: nn.Module) -> Dict[str, torch.Tensor]:
        return cast_floating(dict(module.named_parameters()), compute_dtype)

    def apply_generator(state: GANTrainState, out, grads, run: bool, stats) -> None:
        """The generator's update when `run`; the RVQ state of its forward is
        committed whenever the gradients are finite."""
        if run:
            state.opt_state_g, norm, finite = apply_updates_if_finite(optimizer_g, grads, state.opt_state_g,
                                                                      masters(model))
        else:
            norm = global_norm(grads)
            finite = bool(torch.isfinite(norm))
        if finite:
            model.quantizer.state.commit(out["rvq_state"])
        if run and finite:
            state.gen_loss_carry = state.gen_loss_carry + out["gen_loss"]
        on = 1.0 if run else 0.0
        stats.update({k: v * on for k, v in out["stats"].items()})
        stats["generator_grad_norm"] = norm * on
        stats["generator_nonfinite_skip"] = _skip(finite, norm.device) * on

    def disc_turn(state: GANTrainState, speech, generator, stats) -> None:
        loss, out = functional_call(model, _detached(model, compute_dtype), (
            "forward_discriminator", _disc_fn(discriminator, cast_params(discriminator)),
            cast_floating(speech, compute_dtype), generator, state.gen_loss_carry))
        d_params = masters(discriminator)
        grads = _grads(loss, d_params)
        state.opt_state_d, norm, finite = apply_updates_if_finite(optimizer_d, grads, state.opt_state_d, d_params)
        # the RVQ buffers are also held back on a bad batch
        if finite:
            model.quantizer.state.commit(out["rvq_state"])
        state.gen_loss_carry = torch.zeros_like(state.gen_loss_carry)
        stats.update(out["stats"])
        stats["discriminator_grad_norm"] = norm
        stats["discriminator_nonfinite_skip"] = _skip(finite, norm.device)

    def add_codebook_health(stats) -> None:
        rvq_cfg = getattr(model.quantizer, "rvq_cfg", None)
        if rvq_cfg is not None:
            stats["rvq_dead_codes"], stats["rvq_usage_perplexity"] = codebook_health(
                rvq_cfg, model.quantizer.state)

    def train_step(state: GANTrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        speech = batch["speech"]
        stats: Dict[str, torch.Tensor] = {}
        if state.step % disc_train_interval == 0:
            disc_turn(state, speech, generator, stats)
        else:
            stats.update(_zero_disc_stats(speech.device, pit))
        if state.step % gen_train_interval == 0:
            apply_generator(state, *generator_grads(model, discriminator, speech, generator, compute_dtype), True,
                            stats)
        else:
            stats.update(_zero_gen_stats(speech.device))
        add_codebook_health(stats)
        state.step += 1
        return state, stats

    def shared_train_step(state: GANTrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        speech = batch["speech"]
        stats: Dict[str, torch.Tensor] = {}
        # one generator forward and backward for the whole step
        g_out, g_grads = generator_grads(model, discriminator, speech, generator, compute_dtype)
        if state.step % disc_train_interval == 0:
            loss, d_out = model._discriminator_losses(
                _disc_fn(discriminator, cast_params(discriminator)), cast_floating(speech.float(), compute_dtype),
                cast_floating(g_out["fake"].detach(), compute_dtype), state.gen_loss_carry, generator=generator)
            d_params = masters(discriminator)
            grads = _grads(loss, d_params)
            state.opt_state_d, norm, finite = apply_updates_if_finite(optimizer_d, grads, state.opt_state_d,
                                                                      d_params)
            # the carry resets only when the disc turn runs
            state.gen_loss_carry = torch.zeros_like(state.gen_loss_carry)
            stats.update(d_out["stats"])
            stats["discriminator_grad_norm"] = norm
            stats["discriminator_nonfinite_skip"] = _skip(finite, norm.device)
        else:
            stats.update(_zero_disc_stats(speech.device, pit))
        apply_generator(state, g_out, g_grads, state.step % gen_train_interval == 0, stats)
        add_codebook_health(stats)
        state.step += 1
        return state, stats

    return shared_train_step if shared_forward else train_step
