"""The port's ops/augment.py against funcodec_tpu/ops/augment.py, on the CPU.

jax.random and torch draw different spans, so the masks are held exactly
given JAX's spans (recomputed from the JAX key as its functions split it);
the port's own draws, from a torch.Generator, by their invariants;
utterance_mvn within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import funcodec_tpu.ops.augment as jaug
from funcodec_tpu_torch.ops import augment as taug

torch.set_num_threads(1)

B, T, D = 4, 50, 12
RATIO = {"freq_mask_width_range": [0, 4], "num_freq_mask": 2, "time_mask_width_ratio_range": [0.0, 0.2],
         "num_time_mask": 2}
WIDTH = {"freq_mask_width_range": [1, 3], "num_freq_mask": 1, "time_mask_width_range": [1, 8], "num_time_mask": 3}


def jax_spans(key, shape, conf):
    """The SpecAug spans funcodec_tpu.ops.augment.spec_aug draws from `key`
    for a (B, T, D) input: ((freq widths, starts), (time widths, starts))."""
    B, T, D = shape
    k1, k2 = jax.random.split(key)

    def draw(k, lo, hi, L, n):
        k_w, k_s = jax.random.split(k)
        return (np.array(jax.random.randint(k_w, (B, n), lo, hi)),
                np.array(jax.random.randint(k_s, (B, n), 0, max(L - 1, 1))))

    fr = conf["freq_mask_width_range"]
    freq = draw(k1, fr[0], max(fr[1], fr[0] + 1), D, conf["num_freq_mask"])
    if "time_mask_width_ratio_range" in conf:
        r = conf["time_mask_width_ratio_range"]
        lo = int(r[0] * T)
        time = draw(k2, lo, max(int(r[1] * T), lo + 1), T, conf["num_time_mask"])
    else:
        tr = conf["time_mask_width_range"]
        time = draw(k2, tr[0], max(tr[1], tr[0] + 1), T, conf["num_time_mask"])
    return freq, time


def _x(seed):
    return np.random.RandomState(seed).rand(B, T, D).astype(np.float32) + 1.0  # no zeros of its own


def _spans(a):
    return tuple(torch.from_numpy(v) for v in a)


@pytest.mark.parametrize("axis,width_range,num", [(1, (0, 9), 2), (2, (2, 5), 3)], ids=["time", "feature"])
def test_mask_along_axis_given_jax_spans(axis, width_range, num):
    x = _x(1)
    key = jax.random.PRNGKey(7)
    ref = jaug.mask_along_axis(jnp.asarray(x), key, axis, width_range, num)
    k_w, k_s = jax.random.split(key)
    L = x.shape[axis]
    widths = np.array(jax.random.randint(k_w, (B, num), width_range[0], max(width_range[1], width_range[0] + 1)))
    starts = np.array(jax.random.randint(k_s, (B, num), 0, max(L - 1, 1)))
    ours = taug.mask_along_axis(torch.from_numpy(x), None, axis, width_range, num, *_spans((widths, starts)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert (ours.numpy() == 0).any()


def test_variable_max_width_given_jax_spans():
    x = _x(2)
    key = jax.random.PRNGKey(8)
    ref, ref_mask = jaug.mask_along_axis_variable_max_width(jnp.asarray(x), key, (0.05, 0.3), 2, return_mask=True)
    k_w, k_s = jax.random.split(key)
    widths = np.array(jax.random.randint(k_w, (B, 2), int(0.05 * T), int(0.3 * T)))
    starts = np.array(jax.random.randint(k_s, (B, 2), 0, T - 1))
    ours, mask = taug.mask_along_axis_variable_max_width(torch.from_numpy(x), None, (0.05, 0.3), 2, return_mask=True,
                                                         widths=torch.from_numpy(widths),
                                                         starts=torch.from_numpy(starts))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


@pytest.mark.parametrize("conf", [RATIO, WIDTH], ids=["ratio_time_masks", "width_time_masks"])
def test_spec_aug_given_jax_spans(conf):
    x = _x(3)
    key = jax.random.PRNGKey(9)
    ref = jaug.spec_aug(jnp.asarray(x), key, **conf)
    freq, time = jax_spans(key, x.shape, conf)
    ours = taug.spec_aug(torch.from_numpy(x), None, freq_spans=_spans(freq), time_spans=_spans(time), **conf)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_spec_aug_drawn_from_a_generator_by_its_invariants():
    """Drawn spans: masked positions are whole feature columns or time rows,
    at most num_mask spans narrower than the range's top each; one seed
    draws the same masks; the variable-width masks cover at most num_mask
    times the top ratio."""
    rs = np.random.RandomState(14)
    x = torch.from_numpy(rs.rand(16, 200, 40).astype(np.float32) + 1.0)
    kw = dict(freq_mask_width_range=(0, 6), num_freq_mask=2, time_mask_width_range=(0, 10), num_time_mask=2)
    out = taug.spec_aug(x, torch.Generator().manual_seed(3), **kw)
    zero = out == 0
    cols = zero.all(dim=1)  # (B, D): a feature masked at every time
    rows = zero.all(dim=2)  # (B, T)
    assert torch.equal(zero, cols[:, None, :] | rows[:, :, None])
    assert (cols.sum(-1) <= 2 * 5).all() and (rows.sum(-1) <= 2 * 9).all()
    assert cols.any() and rows.any()
    assert torch.equal(out, taug.spec_aug(x, torch.Generator().manual_seed(3), **kw))
    share = taug.mask_along_axis_variable_max_width(x, torch.Generator().manual_seed(4), (0.0, 0.1), 2,
                                                    return_mask=True)[1].float().mean().item()
    assert 0.0 < share <= 0.2


def test_utterance_mvn_matches_jax():
    rs = np.random.RandomState(15)
    x = rs.randn(3, 12, 5).astype(np.float32) * 3 + 2
    lengths = np.array([12, 7, 1])
    for kw in (dict(), dict(norm_vars=True)):
        for ln in (None, lengths):
            ref = jaug.utterance_mvn(jnp.asarray(x), None if ln is None else jnp.asarray(ln), **kw)
            ours = taug.utterance_mvn(torch.from_numpy(x), None if ln is None else torch.from_numpy(ln), **kw)
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=0, err_msg=str(kw))
