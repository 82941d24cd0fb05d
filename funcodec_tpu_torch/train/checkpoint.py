"""Checkpoints in PyTorch's format, with n-best bookkeeping (port of
funcodec_tpu/train/checkpoint.py).

Behavioral reference: funcodec/train/trainer.py:369-509 (checkpoint.pth with
model+optimizers+reporter, {n}epoch.pth weights, latest.pth symlink,
per-criterion best symlinks, n-best pruning + weight averaging via
util_funcs/average_nbest_models.py:18). The port writes the reference's
files and names; the JAX package writes flax msgpack ``.ckpt`` files instead.

- A weights file (``{epoch}epoch.pth``) is the generator's ``state_dict()``
  on the CPU, under the reference FunCodec names, the RVQ codebook buffers
  included: ``Speech2Token``, ``build_codec_model(...).load_state_dict`` and
  the JAX package's ``compat/torch_import.import_encodec`` read it.
- A train state (``checkpoint.pth``) holds the step, both modules'
  state_dicts (the fp32 masters and the RVQ buffers), both functional
  optimizer states (nested dicts, lists and tuples of tensors and ints; a
  ``torch.Generator`` in them, as ``add_noise`` holds, is stored as its
  ``get_state()``) and the discriminator gate's carry. Only tensors and
  builtins, so it loads with ``torch.load(weights_only=True)``. A Laura
  train state (train/laura_trainer.py) holds the step, the model's
  state_dict (the frozen codebook included) and its one optimizer state.

Every file is written to a temporary name and moved into place with
``os.replace``, so a crash never leaves a half-written checkpoint.

Under data parallelism the ranks hold the same state, so rank 0 alone
writes (the trainers call the writers there and the other ranks wait at a
barrier until the files are on disk); every rank resumes from the same
``checkpoint.pth``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from funcodec_tpu_torch.compat.from_jax import load_torch_state_dict
from funcodec_tpu_torch.train.step import GANTrainState

_GENERATOR = "torch_generator_state"


def _save(obj: Any, path: str) -> None:
    tmp = str(path) + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def _to_host(tree: Any) -> Any:
    """An optimizer state as torch.load(weights_only=True) reads it: tensors
    on the CPU, each torch.Generator as {_GENERATOR: its get_state()}."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, torch.Generator):
        return {_GENERATOR: tree.get_state()}
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _restore(template: Any, saved: Any) -> Any:
    """`saved` (from _to_host) in the template's structure: tensors on the
    template's device, the template's generators set to the saved state."""
    if isinstance(template, torch.Tensor):
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, torch.Generator):
        template.set_state(saved[_GENERATOR])
        return template
    if isinstance(template, dict):
        if set(template) != set(saved):
            raise ValueError(f"checkpoint: keys {sorted(saved)} for a state with {sorted(template)}")
        return {k: _restore(template[k], saved[k]) for k in template}
    if isinstance(template, (list, tuple)):
        if len(template) != len(saved):
            raise ValueError(f"checkpoint: {len(saved)} entries for a state with {len(template)}")
        return type(template)(_restore(t, s) for t, s in zip(template, saved))
    return saved


def save_weights(path: str, model: torch.nn.Module) -> None:
    """The generator's state_dict (parameters and codebooks) on the CPU."""
    _save(_cpu_state_dict(model), path)


def load_checkpoint_params(path: str, model: Optional[torch.nn.Module] = None) -> Dict[str, torch.Tensor]:
    """A weights file's state_dict (on the CPU), loaded into `model` when
    one is given (a model built from the same config)."""
    sd = load_torch_state_dict(path)
    if model is not None:
        model.load_state_dict(sd)
    return sd


def train_state_dict(state) -> Dict[str, Any]:
    """A GANTrainState or a LauraTrainState as checkpoint.pth holds it
    (everything on the CPU)."""
    if not isinstance(state, GANTrainState):
        return {"step": int(state.step), "model": _cpu_state_dict(state.model), "opt_state": _to_host(state.opt_state)}
    return {
        "step": int(state.step),
        "model": _cpu_state_dict(state.model),
        "discriminator": _cpu_state_dict(state.discriminator),
        "opt_state_g": _to_host(state.opt_state_g),
        "opt_state_d": _to_host(state.opt_state_d),
        "gen_loss_carry": state.gen_loss_carry.detach().cpu(),
    }


def save_train_state(path: str, state) -> None:
    _save(train_state_dict(state), path)


def load_train_state(path: str, template):
    """Restore checkpoint.pth into `template`, a train state of the same
    kind, model(s) and optimizer(s): the modules in place, the optimizer
    states (and a GAN state's carry) on their device. Returns the template."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    template.model.load_state_dict(saved["model"])
    template.step = int(saved["step"])
    if not isinstance(template, GANTrainState):
        template.opt_state = _restore(template.opt_state, saved["opt_state"])
        return template
    template.discriminator.load_state_dict(saved["discriminator"])
    template.opt_state_g = _restore(template.opt_state_g, saved["opt_state_g"])
    template.opt_state_d = _restore(template.opt_state_d, saved["opt_state_d"])
    template.gen_loss_carry = _restore(template.gen_loss_carry, saved["gen_loss_carry"])
    return template


def update_symlink(target: str, link: str) -> None:
    """Point `link` at `target` (relative), replacing any existing link."""
    link_p = Path(link)
    if link_p.is_symlink() or link_p.exists():
        link_p.unlink()
    link_p.symlink_to(os.path.basename(target))


def average_checkpoints(paths: List[str], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """n-best weight averaging (util_funcs/average_nbest_models.py:18): the
    mean of the parameters in fp64, back in fp32; the buffers (codebooks)
    of the first file, as the JAX package keeps its first RVQ state."""
    assert paths
    names = {n for n, _ in model.named_parameters()}
    avg = load_checkpoint_params(paths[0])
    acc = {k: v.double() for k, v in avg.items() if k in names}
    for p in paths[1:]:
        sd = load_checkpoint_params(p)
        for k in acc:
            acc[k] += sd[k].double()
    for k, v in acc.items():
        avg[k] = (v / float(len(paths))).to(torch.float32)
    return avg
