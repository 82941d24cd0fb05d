"""Small shared utilities: one-shot hints, parameter census, FLOPs (port of funcodec_tpu/utils/misc.py).

Behavioral reference: funcodec/utils/hinter.py:8-13 (hint_once),
funcodec/torch_utils/model_summary.py (the parameter census logged at
abs_task.py:1276; the thop-style FLOPs tree of --stat_flops,
gan_speech_codec.py:345-355).

The FLOPs of the tree (``codec_flops_tree``) are counted from the layers'
shapes, not by tracing what runs: 2 x the multiply-accumulates of each
convolution, transposed convolution (its useful products, before the trim),
LSTM gate matmul, attention and linear matmul, and of the RVQ's distance
matmuls. Elementwise work (norms, pads, activations, biases, softmax) counts
0. A tracer such as ``torch.utils.flop_counter.FlopCounterMode`` sees no
kernel bound through ctypes, so it would count the fused SEANet blocks as 0
and the tree would change with the kernel flags; a count from shapes does
not, and nothing of the model runs.

Two traits of the JAX package's tree (XLA's cost analysis of each layer's
jitted function) are not copied, measured on tests/test_flops_tree.py's
small model at B = 1 x 1,600 samples:

- XLA adds the norm, pad and bias work to a conv's row: encoder conv 0
  (k7, 1 -> 8) reads 320.03K there against 179.2K at 2 x MACs, and conv 3
  (k4 s2, 8 -> 16) 960.00K against 819.2K.
- XLA counts a scan's body once: the 2-layer LSTM reads 3.35M there,
  while 2 x MACs over its 200 frames is about 6.55M.

Labels, parameter counts, output shapes (JAX's (B, T, C) layout), the
line format and the percentage columns are the JAX package's.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from funcodec_tpu_torch.ops.pad import conv_padding_total, extra_padding_for_conv1d

_hinted = set()


def hint_once(message: str, uid: str, rank: int = 0) -> None:
    """Log a message once per uid (utils/hinter.py:8-13)."""
    if uid not in _hinted:
        _hinted.add(uid)
        logging.info(message)


def count_parameters(tree: Any) -> int:
    """Elements of a module's parameters, or of the tensors / arrays of a
    dict / list / tuple tree (None counts 0)."""
    if tree is None:
        return 0
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(count_parameters(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_parameters(v) for v in tree)
    return int(np.prod(tree.shape))


def _branches(tree: Any) -> List[Tuple[str, Any]]:
    """A module's top-level branches (its direct parameters, then its
    children in registration order) or a dict's items."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters(recurse=False)) + list(tree.named_children())
    return list(tree.items()) if isinstance(tree, dict) else []


def model_summary(params: Any, name: str = "model") -> str:
    """Parameter census with a per-top-level-branch breakdown."""
    lines = [f"{name} summary:"]
    total = count_parameters(params)
    for k, v in _branches(params):
        n = count_parameters(v)
        lines.append(f"  {k}: {n:,} params ({100.0 * n / max(total, 1):.1f}%)")
    lines.append(f"  TOTAL: {total:,} params ({total * 4 / 1e6:.2f} MB fp32)")
    return "\n".join(lines)


def estimate_flops(fn: Callable, *example_args) -> Dict[str, float]:
    """The torch counterpart of the JAX package's XLA cost analysis of a
    callable: ``flops`` as torch.utils.flop_counter.FlopCounterMode counts
    the ops that dispatch (matmuls and convolutions; a kernel bound through
    ctypes counts 0), ``bytes_accessed`` the bytes of the tensor arguments
    and outputs, each read or written once."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        out = fn(*example_args)
    leaves = list(example_args) + list(out if isinstance(out, (list, tuple)) else [out])
    nbytes = sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": float(nbytes)}


def _clever_format(n: float) -> str:
    """thop.clever_format's unit scaling ('%.2f')."""
    for thresh, unit in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(n) >= thresh:
            return f"{n / thresh:.2f}{unit}"
    return f"{n:.2f}B" if n else "0.00B"


def _layer_label(i: int, kind: str, spec: Any) -> str:
    if kind == "conv":
        shape = "x".join(str(s) for s in np.atleast_1d(spec.kernel_size))
        tag = "convtr" if getattr(spec, "transposed", False) else "conv"
        return (f"{i}.{tag} k{shape} s{spec.stride} "
                f"{spec.in_channels}->{spec.out_channels}")
    if kind == "resblock":
        block, shortcut = spec
        c = block[1][1].in_channels if len(block) > 1 else "?"
        return f"{i}.resblock C{c}" + ("" if shortcut is not None else " (true_skip)")
    if kind in ("act", "snake"):
        name = spec[0] if isinstance(spec, tuple) else kind
        return f"{i}.act {name}"
    return f"{i}.{kind}"


def _conv_cost(spec, shape: Tuple[int, ...]) -> Tuple[float, Tuple[int, ...]]:
    """(2 x MACs, output shape) of a 1D streamable conv on (B, T, Cin)."""
    if spec.ndim != 1:
        raise NotImplementedError("the cost tree covers 1D SEANet layers")
    B, T, _ = shape
    k, s, cin, cout, g = spec.kernel_size, spec.stride, spec.in_channels, spec.out_channels, spec.groups
    if spec.transposed:
        # (T - 1) * s + K products per input frame's K taps; the streamable trim leaves T * s
        return 2.0 * B * T * cin * (cout // g) * k, (B, T * s, cout)
    d = spec.dilation
    pad = conv_padding_total(k, s, d)
    length = T + pad + extra_padding_for_conv1d(T, k, s, pad)
    t_out = (length - ((k - 1) * d + 1)) // s + 1
    return 2.0 * B * t_out * cout * (cin // g) * k, (B, t_out, cout)


def _transformer_cost(cfg, shape: Tuple[int, ...]) -> float:
    """2 x MACs of a transformer encoder on (B, T, input_size): the input
    linear, per block the q/k/v/out projections, the scores and the
    weighted sum, and the FFN."""
    B, T, _ = shape
    d, u = cfg.attention_dim, cfg.linear_units
    macs = B * T * cfg.input_size * d if cfg.input_layer in ("linear", "linear_relu") else 0
    per_block = B * T * (4 * d * d + 2 * d * u) + 2 * B * T * T * d
    return 2.0 * (macs + cfg.num_blocks * per_block)


def _layer_cost(kind: str, spec: Any, shape: Tuple[int, ...]) -> Tuple[float, Tuple[int, ...]]:
    if kind == "conv":
        return _conv_cost(spec, shape)
    if kind == "resblock":
        block, shortcut = spec
        flops, out = 0.0, shape
        for k, s in block:
            f, out = _layer_cost(k, s, out)
            flops += f
        if shortcut is not None:
            flops += _conv_cost(shortcut, shape)[0]
        return flops, out
    if kind == "lstm":
        dim, num_layers, _ = spec
        B, T, _ = shape
        return 2.0 * B * T * num_layers * 4 * dim * (dim + dim), shape
    if kind == "tfm":
        from funcodec_tpu_torch.models.seanet import seq_tfm_cfg

        return _transformer_cost(seq_tfm_cfg(spec), shape), shape
    if kind in ("act", "snake"):
        return 0.0, shape
    raise NotImplementedError(f"no cost rule for layer kind {kind!r}")


def layer_cost_rows(layers: Sequence[Tuple[str, Any]], modules: Sequence[nn.Module], shape: Tuple[int, ...]):
    """Per-layer (label, flops, params, out_shape) of a SEANet layer list
    and its modules, from an input of `shape` (B, T, C) (the thop-per-module
    role of torch_utils/model_summary.py:tree_layer_info); returns (rows,
    the last output shape)."""
    rows = []
    for i, ((kind, spec), module) in enumerate(zip(layers, modules, strict=True)):
        flops, shape = _layer_cost(kind, spec, shape)
        rows.append((_layer_label(i, kind, spec), flops, count_parameters(module), tuple(shape)))
    return rows, shape


def quantizer_cost(quantizer: nn.Module, batch: int, frames: int) -> Tuple[float, int]:
    """(2 x MACs, parameters) of the eval quantizer over (batch, frames)
    latents: the projections and each stage's distance matmul against its
    codebook; the parameters count the codebooks too (an identity
    quantizer: none)."""
    state = getattr(quantizer, "state", None)
    embed = state.embed if state is not None else None
    flops = 0.0
    if embed is not None:
        n_q, bins, dim = embed.shape
        flops += 2.0 * batch * frames * n_q * bins * dim
    for name in ("input_proj", "output_proj"):
        lin = getattr(quantizer, name, None)
        if lin is not None:
            flops += 2.0 * batch * frames * lin.in_features * lin.out_features
    return flops, count_parameters(quantizer) + (0 if embed is None else embed.numel())


def codec_flops_tree(model: nn.Module, batch: int = 1, samples: int = 16000) -> str:
    """Per-layer FLOPs/params tree of a 1D codec model's serving path
    (encoder layers -> quantizer -> decoder layers) at `batch` x `samples`
    of the encoder's input channels, formatted like the reference's
    tree_layer_info (model_summary.py:74-98): each line 'name: flops X(p%),
    param. Y(p%)'. Printed by --stat_flops (gan_speech_codec.py:345-355,
    codec_inference.py:328-342). Counts from shapes (module docstring):
    nothing runs, so the tree is the same whatever the kernel flags."""
    shape = (batch, samples, model.encoder.cfg.input_size)
    enc_rows, (_, frames, _) = layer_cost_rows(model.encoder.layers, list(model.encoder.model), shape)
    q_flops, q_params = quantizer_cost(model.quantizer, batch, frames)
    dec_rows, _ = layer_cost_rows(model.decoder.layers, list(model.decoder.model),
                                  (batch, frames, model.decoder.cfg.dimension))

    groups = [("encoder", enc_rows), ("decoder", dec_rows)]
    total_flops = sum(f for _, rows in groups for _, f, _, _ in rows) + q_flops
    total_params = sum(p for _, rows in groups for _, _, p, _ in rows) + q_params

    def fmt(depth, name, flops, nparams, shape=None):
        tail = f"  out={shape}" if shape else ""
        return ("  " * depth + f"{name}: flops {_clever_format(flops)}"
                f"({flops / max(total_flops, 1) * 100.0:.2f}%), "
                f"param. {_clever_format(nparams)}"
                f"({nparams / max(total_params, 1) * 100.0:.2f}%)" + tail)

    lines = [f"serving-path cost tree (B={batch}, {samples} samples, 2 x MACs from layer shapes):"]
    lines.append(fmt(0, "encoder", sum(r[1] for r in enc_rows), sum(r[2] for r in enc_rows)))
    lines += [fmt(1, n, f, p, s) for n, f, p, s in enc_rows]
    lines.append(fmt(0, "quantizer", q_flops, q_params))
    lines.append(fmt(0, "decoder", sum(r[1] for r in dec_rows), sum(r[2] for r in dec_rows)))
    lines += [fmt(1, n, f, p, s) for n, f, p, s in dec_rows]
    lines.append(fmt(0, "TOTAL", total_flops, total_params))
    return "\n".join(lines)
