"""Activation functions (port of funcodec_tpu/ops/activations.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x + (1/(alpha+1e-9)) * sin^2(alpha*x); `alpha` broadcasts against x
    (shape (1, C, 1) for torch's (B, C, T) layout)."""
    s = torch.sin(alpha * x)
    return x + s * s / (alpha + 1e-9)


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return F.elu(x, alpha)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


_ACTS = {
    "elu": elu,
    "relu": F.relu,
    "leakyrelu": leaky_relu,
    "leaky_relu": leaky_relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "swish": F.silu,
}


def get_activation_fn(name: str, **kwargs):
    """Resolve an activation by (torch) name to a pure function of x.

    Parametric activations (snake) are handled by the layer modules, which
    own their parameters.
    """
    key = name.lower()
    if key == "snake":
        raise ValueError("snake is parametric; use snake(x, alpha)")
    fn = _ACTS.get(key)
    if fn is None:
        raise ValueError(f"unknown activation {name}")
    if key == "elu":
        alpha = kwargs.get("alpha", 1.0)
        return lambda x: elu(x, alpha)
    if key in ("leakyrelu", "leaky_relu"):
        slope = kwargs.get("negative_slope", 0.01)
        return lambda x: leaky_relu(x, slope)
    return fn
