"""The LauraTTS cell on the CPU at a small size: found by name with exactly
its metrics, its reference's parameter list against the port's state dict
at full width, a whole run's result line and its readers, the window's
count (only requests completed inside it), and the faults that must make
``correct`` false (the fp8 control, the rel-pos biases dropped, a KV-cache
write one position off).

The small LauraTTS keeps the recipe's topology (conformer text and codec
encoders with rel-pos attention and no conv module, a rel-pos uni-PE codec
LM predicting 2 groups) at widths of 16, one conformer block and two LM
layers, over tiny_root's narrowed codec (4 x 32 codebooks, 16-d latents),
all in float32: 16 requests of 10-40 groups through 4 slots.
"""

import json
import time

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.harness import laura as laura_side
from benchmark.harness.context import Run
from benchmark.harness.main import emit, execute
from benchmark.reference import laura as lref
from benchmark.tests.conftest import ROOT

CELL = "lauratts_libritts.serve_batch"
SEED = 2**31 + 977  # seeds run past 32 signed bits
NEW = ["lm_step_host_ms.tts", "lm_step_device_ms.tts", "admit_device_ms.tts", "synth_device_ms.tts",
       "host_wait_ms.tts", "slot_occupancy.tts", "idle_share.tts", "mfu.tts"]
LIMITS = {"logit_err": 1e-3, "recon_err": 1e-3, "graph_flip": 0}  # float32 against float32: rounding alone reads ~1e-6


def narrow(config: dict) -> dict:
    enc = dict(output_size=16, attention_heads=2, linear_units=24, num_blocks=1)
    lm = config["laura"]
    lm["input_size"] = 24
    lm["text_encoder_conf"].update(enc)
    lm["codec_encoder_conf"].update(enc)
    lm["model_conf"]["codec_conf"].update(num_quantizers=4, codebook_size=32, codebook_dim=16)
    lm["model_conf"]["codec_lm_conf"].update(embed_unit=16, att_unit=16, head=2, unit=24, layer=2)
    config.update(dtype="float32")
    return config


@pytest.fixture()
def laura_root(tiny_root):
    """tiny_root (its codec narrowed to 4 x 32 codebooks of 16 dims, fp32)
    with the LM narrowed to match and a backlog of 16 short requests."""
    bench = tiny_root / "benchmark"
    path = bench / "configs/lauratts_libritts.json"
    path.write_text(json.dumps(narrow(json.loads(path.read_text()))))
    path = bench / "traffic/tts_backlog_s64.json"
    mix = json.loads(path.read_text())
    mix.update(requests=16, cap_groups={"law": "uniform", "min": 10, "max": 40}, slots=4, segment_steps=5,
               trace_seconds=0.5, sample_max=4)
    path.write_text(json.dumps(mix))
    (bench / f"workloads/{CELL}.json").write_text(json.dumps({"limits": LIMITS}))
    return tiny_root


def _run(root, trace=False, seconds=1.0):
    return execute(CELL, SEED, seconds, trace, torch.device("cpu"), time.perf_counter(), root=root)


def test_cell_is_found_by_name():
    cell = cells.load(CELL)
    assert cell.chips == 1 and cell.config_name == "lauratts_libritts" and cell.traffic["driver"] == "tts_batch"
    assert set(cell.workload["limits"]) == {"logit_err", "recon_err", "graph_flip"} and cell.workload["limits"][
        "graph_flip"] == 0
    assert set(cell.workload["why"]) == set(cell.workload["limits"])
    assert [m["name"] for m in cell.end_to_end] == ["serve_audio_s_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == NEW
    assert cells.reader_path("idle_share.tts").name == "idle_share.py"
    assert cell.traffic["slots"] == 64 and cell.traffic["segment_steps"] == 25 and cell.traffic["requests"] == 2048
    assert cell.traffic["cap_groups"] == {"law": "uniform", "min": 100, "max": 482}
    assert cell.config["top_k"] == 25 and cell.config["dtype"] == "bfloat16"


def test_param_specs_match_the_port_state_dict_at_full_width():
    from funcodec_tpu_torch.tasks.text2audio import build_laura_model

    conf = json.loads((ROOT / "benchmark/configs/lauratts_libritts.json").read_text())
    m = lref.Laura.from_config(conf["laura"], len(conf["token_list"]))
    specs = {n: tuple(s) for n, s, _, _ in m.param_specs(laura_side.CODEBOOK)}
    model = build_laura_model(conf["laura"], token_list=conf["token_list"], device="meta")
    assert specs == {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert len(conf["token_list"]) == 78
    assert sum(int(np.prod(s)) for s in specs.values()) == conf["parameters"] == 88_395_778


def test_result_line_and_readers(laura_root, capsys):
    """A run's line (checks last, correct, both end-to-end metrics), then a
    traced run whose readers read the program's spans and counters (device
    times are None on the CPU: no CUDA events)."""
    res = _run(laura_root)
    emit(res)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out)[-1] == "checks" and out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(LIMITS) and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"serve_audio_s_per_s", "setup_s"}
    res = _run(laura_root, trace=True)
    assert res["correct"] is True, res["checks"]
    got = set(res["metrics"])
    assert {"lm_step_host_ms.tts", "host_wait_ms.tts", "slot_occupancy.tts", "idle_share.tts", "mfu.tts"} <= got
    assert got <= set(NEW)
    assert 0 < res["metrics"]["slot_occupancy.tts"]["value"] <= 100


def test_window_counts_only_requests_completed_inside_it(laura_root, monkeypatch):
    """A request counts when its gen is on the host inside the window: the
    polls' finished requests are counted, and what is in flight when the
    window closes is dropped (attempted = the finished ones)."""
    from benchmark.drivers import tts_batch

    cell = cells.load(CELL, laura_root)
    run = Run(cell, SEED, 0.5, False, torch.device("cpu"))
    st = tts_batch.setup(run)
    real_poll = st.prog.t2a.poll
    seen = []

    def poll():
        out = real_poll()
        seen.append(sum(len(o["tokens"]) for o in out.values()))
        return out

    monkeypatch.setattr(st.prog.t2a, "poll", poll)
    tts_batch.window(run, st)
    hop_s = st.prog.hop / st.prog.sr
    assert run.e2e["serve_audio_s_per_s"] > 0
    assert run.attempted == st.offered and run.failed == 0
    assert st.prog.t2a.session.busy  # rows were still in flight, and are not counted
    window_s = sum(seen) * hop_s / run.e2e["serve_audio_s_per_s"]
    assert 0.5 <= window_s < 5.0


def _pos_bias_dropped(monkeypatch):
    """Every rel-pos attention's pos_bias_u and pos_bias_v zeroed in the program."""
    from funcodec_tpu_torch.cli.text2audio_inference import Text2Audio

    start = Text2Audio.start_serving

    def dropped(self, *a, **kw):
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                if name.endswith(("pos_bias_u", "pos_bias_v")):
                    p.zero_()
        return start(self, *a, **kw)

    monkeypatch.setattr(Text2Audio, "start_serving", dropped)


def _kv_write_off_by_one(monkeypatch):
    """The per-row cache writes of every step one position past the row's head."""
    from funcodec_tpu_torch.models import transformer

    step = transformer.TransformerEncoder.step

    def shifted(self, cache, x_new, *a, **kw):
        if isinstance(cache.length, torch.Tensor) and x_new.shape[1] == 1:
            h, c = step(self, transformer.KVCache(cache.k, cache.v, cache.length + 1), x_new, *a, **kw)
            return h, transformer.KVCache(c.k, c.v, c.length - 1)
        return step(self, cache, x_new, *a, **kw)

    monkeypatch.setattr(transformer.TransformerEncoder, "step", shifted)


def _fp8_control(monkeypatch):
    """The control: the reference in fp8 put in the program's place (its
    logits and synthesis judged instead of the program's)."""
    from benchmark.drivers import tts_batch

    samples = tts_batch._samples

    def control(st):
        return laura_side.control(st.prog, samples(st), "cpu")

    monkeypatch.setattr(tts_batch, "_samples", control)


FAULTS = {"fp8_control": _fp8_control, "pos_bias_dropped": _pos_bias_dropped,
          "kv_write_off_by_one": _kv_write_off_by_one}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(laura_root, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = _run(laura_root)
    assert res["correct"] is False, res["checks"]
