"""The FreqCodec cell on the CPU at a small size: found by name, its
reference's parameter list against the port's state dict at full width,
its FLOP count against a hand count and torch's FlopCounterMode, its
readers on a run without the program's new spans, a whole run's result
line, and the faults that must make ``correct`` false (the fp8 control, an
altered token, half a batch left out, the 2D norms' affine dropped).

The small FreqCodec keeps gr8's shape: grouped 2D convs (conv_group_ratio
2 at n_filters 8), two (4, .) frequency stages with the time stride 2, a
2-layer LSTM; n_fft 32 and hop 16 so that two stages take the 17 bins to 1
(the released 257 bins take four); 4 x 64 codebooks, 16-d latents, fp32.
"""

import json
import math
import shutil
import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.costs import freqcodec as costs
from benchmark.harness import cell as cells
from benchmark.harness import freqcodec as freq_side
from benchmark.harness import weights
from benchmark.harness.context import Run
from benchmark.harness.main import emit, execute
from benchmark.harness.trace import DeviceTrace
from benchmark.reference import codec as ref
from benchmark.reference import freqcodec as fref
from benchmark.tests.conftest import ROOT

CELL = "freqcodec_gr8.serve_batch"
SEED = 2**31 + 977  # seeds run past 32 signed bits
NEW = ["stft_device_ms.freq", "istft_device_ms.freq", "encode_device_ms.freq", "quantize_device_ms.freq",
       "decode_device_ms.freq", "conv2d_ms.freq", "idle_share.freq", "mfu.freq"]
SPAN_READERS = NEW[:5]


def narrow(config: dict) -> dict:
    f = config["funcodec"]
    for side in ("encoder_conf", "decoder_conf"):
        f[side].update(n_filters=8, ratios=[[4, 1], [4, 2]], conv_group_ratio=2)
    f["decoder_conf"]["tr_conv_group_ratio"] = 2
    f["quantizer_conf"].update(num_quantizers=4, codebook_size=64, encoder_hop_length=32)
    f["model_conf"].update(odim=16, domain_n_fft=32, domain_hop_length=16)
    config.update(dtype="float32", bit_width=12000)  # 4 quantizers of 6 bits at 500 Hz
    return config


def _config(small=True) -> dict:
    c = json.loads((ROOT / "benchmark/configs/freqcodec_gr8.json").read_text())
    return narrow(c) if small else c


@pytest.fixture()
def freq_root(tiny_root):
    """tiny_root with the FreqCodec configuration narrowed as above (tiny_root's
    own narrowing leaves gr8 without groups) and utterances of 0.3-0.8 s."""
    bench = tiny_root / "benchmark"
    (bench / "configs/freqcodec_gr8.json").write_text(json.dumps(_config()))
    mix = json.loads((bench / "traffic/freq_corpus_mean_b64.json").read_text())
    mix["length_s"] = {"law": "uniform", "min": 0.3, "max": 0.8}
    (bench / "traffic/freq_corpus_mean_b64.json").write_text(json.dumps(mix))
    return tiny_root


def _run(root, trace=False, seconds=1.0):
    return execute(CELL, SEED, seconds, trace, torch.device("cpu"), time.perf_counter(), root=root)


def test_cell_is_found_by_name():
    cell = cells.load(CELL)
    assert cell.chips == 1 and cell.config_name == "freqcodec_gr8" and cell.traffic["driver"] == "freqcodec_batch"
    assert set(cell.workload["limits"]) == {"token_gap", "gap_max", "recon_err"}
    assert set(cell.workload["why"]) == set(cell.workload["limits"])
    assert [m["name"] for m in cell.end_to_end] == ["serve_audio_s_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == NEW
    assert cells.reader_path("idle_share.freq").name == "idle_share.py"
    base = json.loads((ROOT / "benchmark/traffic/corpus_mean_b64.json").read_text())
    mix = dict(cell.traffic)
    assert mix.pop("driver") == "freqcodec_batch" and base.pop("driver") == "codec_batch"
    mix.pop("why"), base.pop("why")
    assert mix == base  # the EnCodec cell's mix, served by FreqCodec


def test_param_specs_match_the_port_state_dict_at_full_width():
    from funcodec_tpu_torch.tasks.codec import build_codec_model

    conf = _config(small=False)
    codec = fref.FreqCodec.from_config(conf["funcodec"])
    specs = {n: tuple(s) for n, s, _, _ in codec.param_specs()}
    model, _ = build_codec_model(conf["funcodec"], device="cpu", generator=torch.Generator().manual_seed(0))
    assert specs == {n: tuple(t.shape) for n, t in model.state_dict().items()}
    params = sum(int(np.prod(s)) for n, s in specs.items() if not n.startswith("quantizer."))
    assert params == conf["parameters"] == 9_932_201 == sum(p.numel() for p in model.parameters())
    # 5.825 s in a 304-frame bucket: the center STFT's 609 frames, 305 codec frames
    assert codec.frames(304 * 320) == 305 and codec.frames(304 * 320 - 1) == 304


def test_flops_by_hand_at_a_small_shape():
    """Each layer of the small encoder and decoder at B = 2 x 64 samples (5
    STFT frames, 17 bins), counted by hand: a grouped conv's output sees
    Cin / groups inputs, a transposed conv's input reaches Cout / groups outputs."""
    codec = fref.FreqCodec.from_config(_config()["funcodec"])
    B, T = 2, 64
    enc, dec = costs.stacks(codec, T)
    got = [(k, i, o, costs.layer_flops(k, s, B, i, o)) for k, s, i, o in enc + dec]
    conv = [(k, i, o, f) for k, i, o, f in got if f]
    want = [
        ("conv2d", (17, 5), (17, 5), 2 * B * 17 * 5 * 8 * 3 * 49),          # 3 -> 8, 7x7
        ("resblock2d", (17, 5), (17, 5), 2 * B * 17 * 5 * (4 * 8 * 9 + 8 * 4 * 1 + 8 * 4 * 1)),  # groups 1, 1, 2
        ("conv2d", (17, 5), (4, 3), 2 * B * 4 * 3 * 16 * 4 * 8 * 4),        # 8 -> 16, (8, 4) / (4, 2), groups 2
        ("resblock2d", (4, 3), (4, 3), 2 * B * 4 * 3 * (8 * 8 * 9 + 16 * 4 * 1 + 16 * 4 * 1)),  # groups 2, 2, 4
        ("conv2d", (4, 3), (1, 3), 2 * B * 1 * 3 * 32 * 4 * 8 * 2),         # 16 -> 32, (8, 2) / (4, 1), groups 4
        ("lstm", (None, 3), (None, 3), 2 * B * 3 * 2 * 4 * 32 * 2 * 32),
        ("conv", (None, 3), (None, 3), 2 * B * 3 * 16 * 32 * 7),            # 32 -> 16, k7
        ("conv", (None, 3), (None, 3), 2 * B * 3 * 32 * 16 * 7),            # 16 -> 32, k7
        ("lstm", (None, 3), (None, 3), 2 * B * 3 * 2 * 4 * 32 * 2 * 32),
        ("convtr2d", (1, 3), (4, 3), 2 * B * 1 * 3 * 32 * 2 * 8 * 2),       # 32 -> 16, (8, 2) / (4, 1), groups 8
        ("resblock2d", (4, 3), (4, 3), 2 * B * 4 * 3 * (8 * 8 * 9 + 16 * 4 * 1 + 16 * 4 * 1)),
        ("convtr2d", (4, 3), (17, 6), 2 * B * 4 * 3 * 16 * 2 * 8 * 4),      # 16 -> 8, (8, 4) / (4, 2), groups 4
        ("resblock2d", (17, 6), (17, 6), 2 * B * 17 * 6 * (4 * 8 * 9 + 8 * 4 * 1 + 8 * 4 * 1)),
        ("conv2d", (17, 6), (17, 6), 2 * B * 17 * 6 * 3 * 8 * 49),          # 8 -> 3, 7x7
    ]
    assert conv == want
    frames = enc[-1][3][1]
    assert costs.serve_flops(codec, B, T, 4) == sum(f for *_, f in want) + 2 * B * frames * 4 * 64 * 16


def test_flops_match_flop_counter_on_the_reference():
    """The reference's convs, transposed convs and RVQ search under
    FlopCounterMode; the LSTM's gate matmuls (which it does not count in
    torch's fused LSTM) step by step at the same shapes."""
    codec = fref.FreqCodec.from_config(_config()["funcodec"])
    sd = weights.draw(codec.param_specs(), 3, "cpu", {})
    B, T = 2, 32 * 16 * 3
    wav = torch.randn(B, T) * 0.1
    with FlopCounterMode(display=False) as fc:
        z, scale = fref.encode_latents(codec, sd, wav)
        idx = ref.rvq_encode(codec, sd, z, 4)
        fref.decode(codec, sd, ref.rvq_decode(sd, idx), scale)
    frames, d = z.shape[1], 2 ** len(codec.encoder.ratios) * codec.encoder.n_filters
    assert frames == codec.frames(T)
    with FlopCounterMode(display=False) as lstm_fc:
        for _ in range(2 * codec.encoder.lstm):
            w_ih, w_hh, h = torch.randn(4 * d, d), torch.randn(4 * d, d), torch.randn(B, d)
            for _ in range(frames):
                h.matmul(w_ih.T) + h.matmul(w_hh.T)
    assert costs.serve_flops(codec, B, T, 4) == pytest.approx(fc.get_total_flops() + lstm_fc.get_total_flops(),
                                                              rel=1e-9)


def test_conv2d_names():
    for name in ("cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>", "dgrad_engine<__nv_bfloat16, 128>",
                 "cutlass__5x_cudnn::Kernel<cutlass_tensorop_s1688fprop_optimized_tf32_256x64_16x4_nhwc_align4>",
                 "precomputed_convolve_sgemm<__nv_bfloat16, 1024>", "sm90_xmma_fprop_implicit_gemm_bf16bf16"):
        assert costs.is_conv2d(name), name
    for name in ("funcodec::conv::tc::conv1d_s1_tc<64, 16, false>", "{anon}::tgn_apply_kernel<__nv_bfloat16, 0>",
                 "{anon}::rvq_encode_wgmma_kernel", "elemWiseRNNcell<__nv_bfloat16>", "nvjet_tst_64x32_64x16_4x2_h_bz_TNT",
                 "at::native::{anon}::reflection_pad2d_out_kernel<c10::BFloat16>", "vector_fft_c2r<512u, EPT<8u>>"):
        assert not costs.is_conv2d(name), name


@pytest.mark.parametrize("program", ["without spans", "without the module"])
def test_readers_return_none_without_the_spans(monkeypatch, program):
    """A traced slice in which the program recorded none of the new spans
    (the parent's program), or a program without the profiling module: the
    span readers and the conv reader find nothing and say so."""
    import sys

    from funcodec_tpu_torch.utils import profiling

    cell = cells.load(CELL)
    run = Run(cell, SEED, 1.0, True, torch.device("cpu"))
    run.tracer.result = DeviceTrace([("nvjet_tst_64x32", 10, 20)], [], 0, 1_000_000)
    run.work.update(batches=[(2, 3200)], codec=fref.FreqCodec.from_config(_config()["funcodec"]), n_q=4)
    profiling.clear()
    if program == "without the module":
        monkeypatch.setitem(sys.modules, "funcodec_tpu_torch.utils.profiling", None)
    for name in SPAN_READERS + ["conv2d_ms.freq"]:
        assert cells.metric_reader(name)(run) is None, name
    assert cells.metric_reader("idle_share.freq")(run) == pytest.approx(99.999)
    assert cells.metric_reader("mfu.freq")(run) > 0


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(freq_root, trace, capsys):
    res = _run(freq_root, trace)
    emit(res)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    if trace:
        assert set(out["metrics"]) <= set(NEW) and "mfu.freq" in out["metrics"]
        # no CUDA events and no device ops on the CPU: the span and conv readers find nothing
        assert not set(out["metrics"]) & set(SPAN_READERS + ["conv2d_ms.freq"])
    else:
        assert set(out["metrics"]) == {"serve_audio_s_per_s", "setup_s"}


def test_program_spans_nest(freq_root, monkeypatch):
    """The traced slice's stft / istft spans sit inside encode / decode, one
    a batch, with the batch's request id."""
    from benchmark.harness import main
    from funcodec_tpu_torch.utils import profiling

    runs = []

    class Kept(main.Run):
        def __post_init__(self):
            super().__post_init__()
            runs.append(self)

    monkeypatch.setattr(main, "Run", Kept)
    profiling.clear()
    main.execute(CELL, SEED, 1.0, True, torch.device("cpu"), time.perf_counter(), root=freq_root)
    t = runs[0].tracer.result
    got = profiling.spans(within=(t.t0_ns, t.t1_ns))
    n = len(runs[0].work["batches"])
    for child, parent in (("stft", "encode"), ("istft", "decode")):
        kids = [s for s in got if s.name == child]
        assert len(kids) == n > 0 and all(s.parent == parent for s in kids)
    ids = {s.request_id for s in got if s.name in ("stft", "istft")}
    assert ids == {s.request_id for s in got if s.name == "dispatch"}


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


@pytest.mark.parametrize("fault", [_altered_token, _half_batch], ids=["token", "half_batch"])
def test_fault_in_timed_path_is_not_correct(freq_root, monkeypatch, fault):
    monkeypatch.setattr(freq_side.FreqProgram, "collect", fault(freq_side.FreqProgram.collect))
    res = _run(freq_root)
    assert res["correct"] is False, res["checks"]


def _affine_dropped(apply_post_norm):
    """Every 2D group norm's gain and shift left out: the norms as 1 and 0."""
    def wrapped(spec, y, norm_scale, norm_bias):
        if norm_scale is not None and y.dim() == 4:
            norm_scale, norm_bias = torch.ones_like(norm_scale), torch.zeros_like(norm_bias)
        return apply_post_norm(spec, y, norm_scale, norm_bias)
    return wrapped


def test_2d_norm_affine_dropped_is_not_correct(freq_root, monkeypatch):
    from funcodec_tpu_torch.ops import conv

    monkeypatch.setattr(conv, "apply_post_norm", _affine_dropped(conv.apply_post_norm))
    res = _run(freq_root)
    assert res["correct"] is False, res["checks"]


def test_fp8_control_is_not_correct(freq_root, monkeypatch):
    """The control: the reference in fp8 put in the program's place."""
    def control_collect(self, out):
        return out

    def control_serve(self, pcm, ilens):
        rows = [freq_side.control_outputs(self.codec, self.sd, dict(pcm=pcm[i], ilen=n), self.n_q, "cpu")
                for i, n in enumerate(ilens)]
        tokens = np.stack([r["tokens"] for r in rows], axis=1)
        recon = np.zeros(pcm.shape, np.int16)
        for i, r in enumerate(rows):
            recon[i, : len(r["recon"])] = r["recon"]
        return tokens, recon

    monkeypatch.setattr(freq_side.FreqProgram, "serve", control_serve)
    monkeypatch.setattr(freq_side.FreqProgram, "collect", control_collect)
    res = _run(freq_root)
    assert res["correct"] is False, res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("dropped", [False, True])
def test_2d_norm_affine_dropped_is_not_correct_on_the_card(tiny_root, monkeypatch, cuda, dropped):
    """The same fault on the card, where the 2D norms run the tgn_norm kernels:
    at the configuration's own widths and limits (the traffic stays
    tiny_root's), the run without the fault holds and the run with it fails."""
    from funcodec_tpu_torch.ops import conv

    for part in ("configs/freqcodec_gr8.json", "workloads/freqcodec_gr8.serve_batch.json"):
        shutil.copy(ROOT / "benchmark" / part, tiny_root / "benchmark" / part)
    if dropped:
        monkeypatch.setattr(conv, "apply_post_norm", _affine_dropped(conv.apply_post_norm))
    res = execute(CELL, SEED, 2.0, False, cuda, time.perf_counter(), root=tiny_root)
    assert res["correct"] is not dropped, res["checks"]
    assert math.isfinite(res["checks"]["recon_err"]["value"])
