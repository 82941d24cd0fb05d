"""Seeded weights from a list of tensor specs, drawn on the device in one call.

Both sides get the same tensors: the program loads them with
``load_state_dict`` and the reference reads them by name. Nothing of the
program draws them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str, float]
# the laws whose elements come from the one U(-1, 1) draw
DRAWN = ("uniform", "one_plus_uniform")


def draw(specs: List[Spec], seed: int, device, served: Dict[str, torch.dtype]) -> Dict[str, torch.Tensor]:
    """{name: tensor} for specs (name, shape, law, bound): one U(-1, 1) draw of
    every "uniform" and "one_plus_uniform" element from a generator on
    `device` seeded with `seed`, each slice times its bound
    ("one_plus_uniform" then plus 1, a gain around 1); "ones" / "zeros"
    constants; "copy:<name>" a copy of an earlier tensor. `served` maps a
    name prefix to the type the tensor is served in (the first prefix that
    matches; float32 otherwise), and each tensor is rounded to it."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    drawn = [(shape, b) for _, shape, lw, b in specs if lw in DRAWN]
    sizes = [_numel(shape) for shape, _ in drawn]
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0, generator=gen)
    flat *= torch.repeat_interleave(torch.tensor([b for _, b in drawn], device=device),
                                    torch.tensor(sizes, device=device))
    at = 0
    out: Dict[str, torch.Tensor] = {}
    for name, shape, law, _ in specs:
        if law in DRAWN:
            n = _numel(shape)
            t = flat[at: at + n].view(shape)
            at += n
            if law == "one_plus_uniform":
                t = t + 1.0
        elif law == "ones":
            t = torch.ones(shape, device=device)
        elif law == "zeros":
            t = torch.zeros(shape, device=device)
        elif law.startswith("copy:"):
            t = out[law[5:]].float().clone()
        else:
            raise ValueError(f"unknown law {law!r} for {name}")
        dtype = next((d for prefix, d in served.items() if name.startswith(prefix)), torch.float32)
        out[name] = t.to(dtype)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
