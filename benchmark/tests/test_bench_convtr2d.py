"""The FreqCodec cell's transposed 2D convs: their shapes and bytes at the
cell's request (costs/convtr2d.py), and the reader of
``convtr2d_roofline.freq`` on a slice with and without the port's kernel."""

import json

import pytest
import torch

from benchmark.costs import convtr2d as costs
from benchmark.costs.codec import PEAKS
from benchmark.costs.freqcodec import is_conv2d
from benchmark.harness import cell as cells
from benchmark.harness.context import Run
from benchmark.harness.trace import DeviceTrace
from benchmark.reference import freqcodec as fref
from benchmark.tests.conftest import ROOT

CELL = "freqcodec_gr8.serve_batch"
B, T = 64, 97_280  # the cell's batch: 5.825 s in a 16-frame bucket
KERNEL = "{anon}::convtr2d_kernel<1, 2>"


def _codec():
    config = json.loads((ROOT / "benchmark/configs/freqcodec_gr8.json").read_text())
    return fref.FreqCodec.from_config(config["funcodec"])


def test_the_cell_shapes_and_bytes():
    """x (64, 512, 1, 305) ... (64, 64, 64, 610) in, the kept outputs out; 16 -> 8 channels a group."""
    calls = costs.convtr2d_calls(_codec(), T)
    got = [(s["cin"], s["cout"], s["groups"], tuple(s["stride"]), i, o) for s, i, o in calls]
    assert got == [(512, 256, 32, (4, 1), (1, 305), (4, 305)), (256, 128, 16, (4, 1), (4, 305), (16, 305)),
                   (128, 64, 8, (4, 2), (16, 305), (64, 610)), (64, 32, 4, (4, 1), (64, 610), (257, 610))]
    x = B * (512 * 305 + 256 * 4 * 305 + 128 * 16 * 305 + 64 * 64 * 610)
    y = B * (256 * 4 * 305 + 128 * 16 * 305 + 64 * 64 * 610 + 32 * 257 * 610)
    w = sum(s["cin"] * 8 * s["k"][0] * s["k"][1] + s["cout"] for s, _, _ in calls)
    assert sum(costs.call_bytes(s, B, i, o) for s, i, o in calls) == 2 * (x + y + w)
    assert costs.convtr2d_bound_s(_codec(), B, T) == pytest.approx(2 * (x + y + w) / PEAKS["hbm_bytes_per_s"])
    assert 1.5e9 < 2 * (x + y + w) < 1.6e9


def test_names_are_the_kernels_alone():
    assert costs.is_convtr2d(KERNEL) and not is_conv2d(KERNEL)
    for name in ("dgrad_engine<__nv_bfloat16, 128, 6, 7, 3, 3, 5, false>", "scaleTensor_kernel<float, float>",
                 "{anon}::tgn_apply_kernel<__nv_bfloat16, 0>"):
        assert not costs.is_convtr2d(name), name


@pytest.mark.parametrize("ops,expect", [([], None), ([("dgrad_engine<__nv_bfloat16>", 0, 5_000)], None),
                                        ([(KERNEL, 0, 400_000), (KERNEL, 500_000, 900_000)], "share")],
                         ids=["no_ops", "cudnn_route", "kernel"])
def test_reader(ops, expect):
    run = Run(cells.load(CELL), 2**31 + 5, 1.0, True, torch.device("cpu"))
    run.work.update(batches=[(B, T), (B, T)], codec=_codec(), n_q=32)
    read = cells.metric_reader("convtr2d_roofline.freq")
    assert read(run) is None  # no trace
    run.tracer.result = DeviceTrace(ops, [], 0, 1_000_000)
    got = read(run)
    if expect is None:
        assert got is None
    else:  # two batches' bound over the 0.8 ms the two launches took
        assert got == pytest.approx(100.0 * 2 * costs.convtr2d_bound_s(_codec(), B, T) / 0.8e-3)
