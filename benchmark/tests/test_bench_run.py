"""A whole run of each cell on the CPU at a tiny size: the result line's
schema, the judged window, and faults planted in the timed path that must
make ``correct`` false."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark.harness import codec as codec_side
from benchmark.harness.main import emit, execute

CELLS = ["encodec_nq32ds320.serve_batch"]
SEED = 2**31 + 977  # seeds run past 32 signed bits


def _run(root, cell, trace=False, seed=SEED):
    return execute(cell, seed, 1.0, trace, torch.device("cpu"), time.perf_counter(), root=root)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(tiny_root, cell, trace, capsys):
    res = _run(tiny_root, cell, trace)
    emit(res)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
        allowed = {m["name"] for m in spec["per_layer"] if cell in m["workloads"]}
        assert set(out["metrics"]) <= allowed
    else:
        want = {m["name"] for m in spec["end_to_end"] if cell in m.get("workloads", [cell])}
        assert set(out["metrics"]) == want and "setup_s" in want
    for m in out["metrics"].values():
        assert np.isfinite(m["value"]) and m["unit"]
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def _altered_token(collect):
    def wrapped(self, out):
        tokens, recon = collect(self, out)
        tokens = tokens.copy()
        tokens[:, :, 0] = (tokens[:, :, 0] + 7) % self.codec.bins  # a token altered in every row
        return tokens, recon
    return wrapped


def _half_batch(collect):
    def wrapped(self, out):
        tokens, recon = collect(self, out)
        half = (tokens.shape[1] + 1) // 2
        tokens, recon = tokens.copy(), recon.copy()
        rest = tokens.shape[1] - half
        tokens[:, half:] = tokens[:, :rest]  # the second half never computed: the first half's answers
        recon[half:] = recon[:rest]
        return tokens, recon
    return wrapped


FAULTS = [(c, name, fault) for c in CELLS for name, fault in (("token", _altered_token), ("half_batch", _half_batch))]


@pytest.mark.parametrize("cell,name,fault", FAULTS, ids=[f"{c}-{n}" for c, n, _ in FAULTS])
def test_fault_in_timed_path_is_not_correct(tiny_root, monkeypatch, cell, name, fault):
    monkeypatch.setattr(codec_side.CodecProgram, "collect", fault(codec_side.CodecProgram.collect))
    res = _run(tiny_root, cell)
    assert res["correct"] is False, res["checks"]


def _affine_dropped(apply_post_norm):
    """Every group norm's gain and shift left out: the norms as 1 and 0."""
    def wrapped(spec, y, norm_scale, norm_bias):
        if norm_scale is not None:
            norm_scale, norm_bias = torch.ones_like(norm_scale), torch.zeros_like(norm_bias)
        return apply_post_norm(spec, y, norm_scale, norm_bias)
    return wrapped


@pytest.mark.parametrize("cell", CELLS)
def test_group_norm_affine_dropped_is_not_correct(tiny_root, monkeypatch, cell):
    """The norms' drawn gains and shifts reach what is served: a timed path
    that drops them (here the plain path's, which the CPU runs) is caught."""
    from funcodec_tpu_torch.ops import conv

    monkeypatch.setattr(conv, "apply_post_norm", _affine_dropped(conv.apply_post_norm))
    res = _run(tiny_root, cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("dropped", [False, True])
def test_fused_resblock_affine_dropped_is_not_correct_on_the_card(tiny_root, monkeypatch, cuda, cell, dropped):
    """The same fault inside the fused resblock kernel's finalize: it is
    handed gains of 1 and shifts of 0, and the same run without the fault
    holds (the kernel runs on the card only, at the configuration's own
    widths and limits; the traffic stays tiny)."""
    import shutil

    from benchmark.tests.conftest import ROOT
    from funcodec_tpu_torch.ops import resblock_kernel

    for part in ("configs/encodec_nq32ds320.json", "workloads/encodec_nq32ds320.serve_batch.json"):
        shutil.copy(ROOT / "benchmark" / part, tiny_root / "benchmark" / part)

    packed = resblock_kernel.packed_weights

    def drop(*args, **kwargs):
        w = dict(packed(*args, **kwargs))
        for k in ("g1", "g2", "gs"):
            w[k] = torch.ones_like(w[k])
        for k in ("be1", "be2", "bes"):
            w[k] = torch.zeros_like(w[k])
        return w

    if dropped:
        monkeypatch.setattr(resblock_kernel, "packed_weights", drop)
    res = execute(cell, SEED, 2.0, False, cuda, time.perf_counter(), root=tiny_root)
    assert res["correct"] is not dropped, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_is_not_correct(tiny_root, monkeypatch, cell):
    """The control: the reference in fp8 put in the program's place."""
    from benchmark.reference import judge

    def control_collect(self, out):
        tokens, recon = out
        return tokens, recon

    def control_serve(self, pcm, ilens):
        rows = [judge.control_outputs(self.codec, self.sd, dict(pcm=pcm[i], ilen=n), self.n_q, "cpu")
                for i, n in enumerate(ilens)]
        tokens = np.stack([r["tokens"] for r in rows], axis=1)
        recon = np.zeros(pcm.shape, np.int16)
        for i, r in enumerate(rows):
            recon[i, : len(r["recon"])] = r["recon"]
        return tokens, recon

    monkeypatch.setattr(codec_side.CodecProgram, "serve", control_serve)
    monkeypatch.setattr(codec_side.CodecProgram, "collect", control_collect)
    res = _run(tiny_root, cell)
    assert res["correct"] is False, res["checks"]
