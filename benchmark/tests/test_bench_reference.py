"""The plain reference against the port's plain CPU path, and the
reference's parameter list against the port's state dict."""

import json
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import weights
from benchmark.reference import codec as ref

BENCH = Path(__file__).resolve().parents[1]


def _config(narrow=True):
    from benchmark.tests.conftest import narrow as narrow_fn

    c = json.loads((BENCH / "configs/encodec_nq32ds320.json").read_text())
    return narrow_fn(c) if narrow else c


def test_param_specs_match_the_port_state_dict_at_full_width():
    from funcodec_tpu_torch.tasks.codec import build_codec_model

    conf = _config(narrow=False)
    codec = ref.Codec.from_config(conf["funcodec"])
    specs = {n: tuple(s) for n, s, _, _ in codec.param_specs()}
    model, _ = build_codec_model(conf["funcodec"], device="cpu", generator=torch.Generator().manual_seed(0))
    assert specs == {n: tuple(t.shape) for n, t in model.state_dict().items()}
    params = sum(int(np.prod(s)) for n, s in specs.items() if not n.startswith("quantizer."))
    assert params == conf["parameters"] == sum(p.numel() for p in model.parameters())


def test_reference_equals_the_port_plain_path(monkeypatch):
    """The port's plain fp32 path (kernel switches off: a run of a cell may
    have set them) serves the reference's tokens, and its PCM within one step."""
    from funcodec_tpu_torch.cli.codec_inference import Speech2Token
    from funcodec_tpu_torch.ops import conv
    from funcodec_tpu_torch.quant import rvq

    for module, flag in ((rvq, "FUSED_RVQ"), (conv, "FUSED_STRIDE1"), (conv, "FUSED_RESBLOCK")):
        monkeypatch.setattr(module, flag, False)
    torch.set_num_threads(1)
    c = _config()
    codec = ref.Codec.from_config(c["funcodec"])
    sd = weights.draw(codec.param_specs(), 2**40 + 3, "cpu", {})
    s2t = Speech2Token(c["funcodec"], None, dtype="float32", bit_width=c["bit_width"], device="cpu")
    s2t.model.load_state_dict(sd, strict=True)
    T = 320 * 48
    pcm = (np.random.default_rng(1).standard_normal((2, T)) * 3000).astype(np.int16)
    ilens = [T, T - 1000]
    codes, _, recon, _ = s2t.collect(s2t.dispatch(pcm, bit_width=c["bit_width"], pcm16_ilens=ilens))
    wav = torch.from_numpy(pcm.astype(np.float32) / 32768)
    idx, pcm16 = ref.serve(codec, sd, wav, torch.tensor(ilens), 4, ref.Precision())
    assert np.array_equal(np.asarray(codes[0]), idx.numpy())
    for i, n in enumerate(ilens):
        assert np.abs(recon[i, :n].astype(int) - pcm16[i, :n].numpy().astype(int)).max() <= 1


def test_weights_are_the_seed_s():
    codec = ref.Codec.from_config(_config()["funcodec"])
    a = weights.draw(codec.param_specs(), 2**33 + 1, "cpu", {"encoder.": torch.bfloat16})
    b = weights.draw(codec.param_specs(), 2**33 + 1, "cpu", {"encoder.": torch.bfloat16})
    c = weights.draw(codec.param_specs(), 2**33 + 2, "cpu", {"encoder.": torch.bfloat16})
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.model.0.conv.conv.weight"], c["decoder.model.0.conv.conv.weight"])
    assert a["encoder.model.0.conv.conv.weight"].dtype == torch.bfloat16
    assert a["quantizer.rq.model.embed"].dtype == torch.float32
    assert torch.equal(a["quantizer.rq.model.embed"], a["quantizer.rq.model.embed_avg"])
    w = a["decoder.model.0.conv.conv.weight"]
    assert w.abs().max() <= 1 / np.sqrt(w.shape[1] * w.shape[2])
    gains = torch.cat([t for k, t in a.items() if k.endswith("norm.weight")])
    shifts = torch.cat([t for k, t in a.items() if k.endswith("norm.bias")])
    assert (gains - 1).abs().max() <= ref.NORM_GAIN and (gains - 1).abs().mean() > ref.NORM_GAIN / 4
    assert shifts.abs().max() <= ref.NORM_SHIFT and shifts.abs().mean() > ref.NORM_SHIFT / 4
