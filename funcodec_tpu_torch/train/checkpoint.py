"""Checkpoints in PyTorch's format, with n-best bookkeeping (port of
funcodec_tpu/train/checkpoint.py).

Behavioral reference: funcodec/train/trainer.py:369-509 (checkpoint.pth with
model+optimizers+reporter, {n}epoch.pth weights, latest.pth symlink,
per-criterion best symlinks, n-best pruning + weight averaging via
util_funcs/average_nbest_models.py:18). The port writes the reference's
files and names; it also reads the JAX package's flax msgpack ``.ckpt``
files and writes its weights files (the ``*_jax_*`` functions below).

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

The JAX package's files (funcodec_tpu/train/checkpoint.py), read through
compat/flax_msgpack and carried by compat/from_jax:

- a weights file (``{epoch}epoch.ckpt``, ``latest.ckpt``, an average) is
  ``{"params": ..., "rvq_state": ...}`` (a Laura one ``{"params"}``):
  ``load_jax_checkpoint_params`` / ``load_jax_params`` load it into a port
  model built from the same config, ``save_jax_weights`` writes one from a
  JAX-structured tree (compat/torch_import) with JAX's bytes, and
  ``average_jax_checkpoints`` averages them as JAX does;
- a train state (``checkpoint.ckpt``) is the JAX GANTrainState or Laura
  TrainState by field; ``load_jax_train_state`` carries it into a port
  train state (the Adam moments and counts, the step, the gate carry).

``load_codec_weights`` / ``load_laura_weights`` dispatch on the suffix as
the JAX CLIs do: ``.pth``, ``.pt`` and ``.bin`` are PyTorch state_dicts,
any other file is a JAX checkpoint.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from funcodec_tpu_torch.compat import flax_msgpack
from funcodec_tpu_torch.compat.from_jax import (
    laura_state_dict_from_jax,
    laura_train_state_from_jax,
    load_torch_state_dict,
    state_dict_from_jax,
    train_state_from_jax,
)
from funcodec_tpu_torch.train.step import GANTrainState

TORCH_SUFFIXES = (".pth", ".pt", ".bin")  # anything else is a JAX checkpoint, as the JAX CLIs read it

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


# ---------------------------------------------------------------------------
# the JAX package's .ckpt files
# ---------------------------------------------------------------------------


def is_torch_file(path) -> bool:
    return str(path).endswith(TORCH_SUFFIXES)


def read_jax_file(path) -> Any:
    """The tree of a JAX checkpoint (compat/flax_msgpack.restore: maps,
    numpy arrays). Bytes that are not one raise a ValueError naming the file."""
    data = Path(path).read_bytes()
    try:
        return flax_msgpack.restore(data)
    except ValueError as e:
        raise ValueError(f"{path}: not a JAX checkpoint (flax msgpack): {e}") from None


def _jax_weights(path, tree, keys=("params", "rvq_state")) -> Dict[str, Any]:
    if not isinstance(tree, dict) or not set(keys) <= set(tree):
        have = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path}: a JAX weights file holds {list(keys)}, this one {have}")
    return tree


def _write_bytes(path, data: bytes) -> None:
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _jax_host(tree: Any) -> Any:
    """funcodec_tpu's _to_host, jax.tree_util.tree_map(np.asarray, tree):
    dicts rebuilt with their keys sorted, lists, tuples and namedtuples
    kept, each leaf an array (a torch tensor stays one)."""
    if isinstance(tree, dict):
        return {k: _jax_host(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_jax_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax_host(v) for v in tree)
    if tree is None or isinstance(tree, torch.Tensor):
        return tree
    return np.asarray(tree)


def save_jax_weights(path: str, params: Any, rvq_state: Any = None) -> None:
    """funcodec_tpu save_weights: a JAX-structured params tree (and the
    codebooks, an RVQState) as the JAX package writes them, byte for byte."""
    payload = {"params": _jax_host(params)}
    if rvq_state is not None:
        payload["rvq_state"] = _jax_host(rvq_state)
    _write_bytes(path, flax_msgpack.to_bytes(payload))


def save_jax_tree(path: str, tree: Any) -> None:
    """A restored tree (maps in their file's order) written back as it is."""
    _write_bytes(path, flax_msgpack.to_bytes(tree))


def load_jax_checkpoint_params(path: str, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A JAX codec weights file ({"params", "rvq_state"}) loaded into `model`,
    a port codec built from the same config; returns its state_dict (CPU)."""
    return _carry_codec(path, _jax_weights(path, read_jax_file(path)), model)


def _carry_codec(path, tree, model) -> Dict[str, torch.Tensor]:
    try:
        sd = state_dict_from_jax(model, tree["params"], tree["rvq_state"])
        model.load_state_dict(sd)
    except (KeyError, ValueError, RuntimeError) as e:
        raise ValueError(f"{path}: the JAX weights do not fit the model of this config: {e}") from e
    return sd


def load_jax_params(path: str, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A JAX params-only weights file (a Laura checkpoint) loaded into
    `model`, the port's LauraGenModel of the same config; returns its state_dict."""
    tree = _jax_weights(path, read_jax_file(path), keys=("params",))
    try:
        sd = laura_state_dict_from_jax(model, tree["params"])
        model.load_state_dict(sd)
    except (KeyError, ValueError, RuntimeError) as e:
        raise ValueError(f"{path}: the JAX weights do not fit the model of this config: {e}") from e
    return sd


def load_codec_weights(path: str, model: torch.nn.Module) -> None:
    """A codec weights file into `model`: a PyTorch state_dict (FunCodec's
    .pth, the port trainer's files) or a JAX checkpoint, by the suffix."""
    if is_torch_file(path):
        model.load_state_dict(load_torch_state_dict(path))
    else:
        load_jax_checkpoint_params(path, model)


def load_laura_weights(path: str, model: torch.nn.Module) -> None:
    """A LauraGenModel weights file into `model`, by the suffix."""
    if is_torch_file(path):
        model.load_state_dict(load_torch_state_dict(path))
    else:
        load_jax_params(path, model)


def load_jax_train_state(path: str, template, *optimizers):
    """A JAX checkpoint.ckpt as a port train state over `template`'s
    module(s) (a GANTrainState: pass the generator's and the
    discriminator's optimizers; a LauraTrainState: its one optimizer),
    through compat/from_jax.train_state_from_jax /
    laura_train_state_from_jax."""
    tree = read_jax_file(path)
    try:
        if isinstance(template, GANTrainState):
            return train_state_from_jax(template.model, template.discriminator, tree, *optimizers)
        return laura_train_state_from_jax(template.model, tree, *optimizers)
    except (KeyError, ValueError, RuntimeError) as e:
        raise ValueError(f"{path}: the JAX train state does not fit this trainer's models: {e}") from e


def _f64(x) -> np.ndarray:
    return x.double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)


def _leaf_shapes(tree, path: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaf_shapes(sub, f"{path}/{key}").items()}
    return {path: None if tree is None else tuple(getattr(tree, "shape", ()))}


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return None if trees[0] is None else fn(*trees)


def average_jax_checkpoints(paths: List[str], model: torch.nn.Module) -> Dict[str, Any]:
    """funcodec_tpu average_checkpoints over JAX weights files: the float64
    sum of every parameter, divided by the count and cast to fp32, with the
    first file's rvq_state. Returns the tree {"params", "rvq_state"} in the
    first file's order, which ``save_jax_tree`` writes with the JAX
    average's bytes (the JAX package writes its dicts key-sorted and its
    lists in index order, the order the JAX average writes). The first file
    must load into `model`; every other must hold the same names and shapes."""
    assert paths
    first = _jax_weights(paths[0], read_jax_file(paths[0]))
    _carry_codec(paths[0], first, model)
    shapes = _leaf_shapes(first["params"])
    acc = _tree_map(_f64, first["params"])
    for p in paths[1:]:
        params = _jax_weights(p, read_jax_file(p))["params"]
        if _leaf_shapes(params) != shapes:
            raise ValueError(f"{p}: its parameters are not those of {paths[0]}")
        acc = _tree_map(lambda a, b: a + _f64(b), acc, params)
    n = float(len(paths))
    return {"params": _tree_map(lambda a: (a / n).astype(np.float32), acc), "rvq_state": first["rvq_state"]}
