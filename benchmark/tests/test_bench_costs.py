"""The copied FLOP count against torch's FlopCounterMode on the plain path,
and the kernels' bytes against the tensors' sizes."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.costs import codec as costs
from benchmark.reference import codec as ref

BENCH = Path(__file__).resolve().parents[1]


def _codec(n_filters=4):
    c = json.loads((BENCH / "configs/encodec_nq32ds320.json").read_text())["funcodec"]
    c["encoder_conf"]["n_filters"] = n_filters
    c["decoder_conf"]["n_filters"] = n_filters
    c["quantizer_conf"].update(num_quantizers=4, codebook_size=64)
    c["model_conf"]["odim"] = 16
    return ref.Codec.from_config(c)


def test_serve_flops_match_flop_counter_on_the_plain_path():
    """The reference's convs and RVQ search run under FlopCounterMode; it
    does not count torch's fused LSTM, so the LSTM's gate matmuls are run
    step by step under it at the same shapes."""
    from benchmark.harness import weights

    codec = _codec()
    sd = weights.draw(codec.param_specs(), 3, "cpu", {})
    B, T = 2, 320 * 32
    wav = torch.randn(B, T) * 0.1
    with FlopCounterMode(display=False) as fc:
        z, scale = ref.encode_latents(codec, sd, wav)
        idx = ref.rvq_encode(codec, sd, z, 4)
        ref.decode(codec, sd, ref.rvq_decode(sd, idx), scale)
    frames, d = z.shape[1], 2 ** len(codec.encoder.ratios) * codec.encoder.n_filters
    with FlopCounterMode(display=False) as lstm_fc:
        for _ in range(2 * codec.encoder.lstm):  # the encoder's and the decoder's layers
            w_ih, w_hh, h = torch.randn(4 * d, d), torch.randn(4 * d, d), torch.randn(B, d)
            for _ in range(frames):
                h.matmul(w_ih.T) + h.matmul(w_hh.T)
    assert costs.serve_flops(codec, B, T, 4) == pytest.approx(
        fc.get_total_flops() + lstm_fc.get_total_flops(), rel=1e-9)


def test_resblock_bytes_are_the_tensor_sizes():
    codec = _codec(n_filters=32)
    B, T = 3, 320 * 16
    calls = costs.resblock_calls(codec, T)
    assert [c for c, _, _ in calls] == [32, 64, 128, 256, 256, 128, 64, 32]
    assert [t for _, t, _ in calls] == [T, T // 2, T // 8, T // 40, T // 40, T // 8, T // 2, T]
    nbytes = 0
    for C, t, s in calls:
        x = torch.empty(B, C, t, dtype=torch.bfloat16)
        ws = [torch.empty(c["cout"], c["cin"], c["k"], dtype=torch.bfloat16) for _, c in s["block"] + [s["shortcut"]]]
        nbytes += 2 * x.numel() * x.element_size() + sum(w.numel() * w.element_size() for w in ws)
    assert costs.resblock_bound_s(codec, B, T) == pytest.approx(nbytes / costs.PEAKS["hbm_bytes_per_s"])


def test_rvq_bound_at_the_flagship_request():
    """B = 64 x 10 s, 32 stages: bound by operations, 0.271 ms (chip_smoke's)."""
    codec = ref.Codec.from_config(json.loads((BENCH / "configs/encodec_nq32ds320.json").read_text())["funcodec"])
    assert costs.rvq_bound_s(codec, 64, 160000, 32) == pytest.approx(2.0 * 32000 * 32 * 1024 * 128 / 989e12)
    assert costs.resblock_bound_s(codec, 64, 160000) * 1e3 == pytest.approx(2.11, abs=0.06)
