"""The FreqCodec program under test and its check against the plain
reference (``reference/freqcodec.py``), beside ``harness/codec.py``'s
EnCodec ones.

``FreqProgram`` is ``CodecProgram`` built over the FreqCodec reference's
parameter list: the same configuration file keys, seeded weights that the
program loads and the reference reads, and ``Speech2Token``'s
``dispatch`` / ``collect`` as the CLI drives them. The judge's numbers are
``reference/judge.py``'s, computed with the FreqCodec reference:

- ``token_gap`` / ``gap_max``: along the served tokens, each codeword's score
  gap to the best codeword on the reference's residual, over the stage's
  score spread (mean over the request's frames and stages / the widest);
- ``recon_err``: relative L2 distance of the served PCM16 from the
  reference's decode of the served tokens, over the valid samples; a token
  flip is not in it (cuDNN's bf16 transposed 2D convs sum in another order
  from run to run, so a request served twice differs by ~1e-2 relative L2).

The reference runs one sampled row at a time, after the program is freed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import codec as codec_side
from benchmark.harness import weights
from benchmark.harness.context import Run
from benchmark.reference import codec as ref
from benchmark.reference import freqcodec as fref


class FreqProgram(codec_side.CodecProgram):
    """Speech2Token over the benchmark's weights, with the FreqCodec
    reference's view (``serve``, ``collect`` and ``free`` as CodecProgram's)."""

    def __init__(self, run: Run):
        conf = run.cell.config
        self.funcodec = conf["funcodec"]
        self.dtype = conf["dtype"]
        self.bit_width = conf["bit_width"]
        codec_side.set_flags(conf.get("flags", {}))
        from funcodec_tpu_torch.cli.codec_inference import Speech2Token

        self.codec = fref.FreqCodec.from_config(self.funcodec)
        served = codec_side.DTYPES[self.dtype]
        self.sd = weights.draw(self.codec.param_specs(), run.seed, run.device,
                               {"encoder.": served, "decoder.": served})
        self.s2t = Speech2Token(self.funcodec, None, dtype=self.dtype, bit_width=self.bit_width, device=run.device)
        self.s2t.model.load_state_dict(self.sd, strict=True)
        self.hop = self.s2t.hop_length
        self.sr = int(self.funcodec.get("sampling_rate", 16000))
        self.n_q = self.s2t.model.quantizer.n_q_for_bandwidth(self.bit_width)


def token_numbers(codec: fref.FreqCodec, sd, wav: torch.Tensor, tokens: torch.Tensor, ilen: int):
    """judge.token_numbers over the FreqCodec reference: the served tokens
    (n_q, frames) of the float waveform `wav` (T,) along the reference's
    residual, over the row's valid frames ceil(ilen / hop) (the CLI's trim)."""
    frames = -(-ilen // codec.hop)
    z, scale = fref.encode_latents(codec, sd, wav[None])
    embed = sd["quantizer.rq.model.embed"].float()
    r = z[0, :frames].float()
    gaps, q0_flip = [], 0.0
    for q in range(tokens.shape[0]):
        s = ref.scores(r, embed[q])
        chosen = tokens[q, :frames]
        best = s.max(dim=-1)
        gaps.append((best.values - s.gather(1, chosen[:, None])[:, 0]) / s.std(dim=-1))
        if q == 0:
            q0_flip = float((best.indices != chosen).float().mean())
        r = r - embed[q][chosen]
    gap = torch.stack(gaps)
    return {"token_gap": float(gap.mean()), "gap_max": float(gap.max()), "q0_flip": q0_flip}, scale


def judge_one(codec: fref.FreqCodec, sd, sample: dict, n_q: int, device) -> Dict[str, float]:
    """sample: pcm (padded row, int16), ilen, tokens (n_q, frames of the row),
    recon (ilen,) int16."""
    wav = torch.from_numpy(sample["pcm"].astype(np.float32) / 32768.0).to(device)
    tokens = torch.from_numpy(np.asarray(sample["tokens"], np.int64)).to(device)
    ilen = int(sample["ilen"])
    with torch.no_grad():
        numbers, scale = token_numbers(codec, sd, wav, tokens[:n_q], ilen)
        recon = fref.decode(codec, sd, ref.rvq_decode(sd, tokens[:, None, :]), scale)
        want = ref.pcm16_float(recon, torch.tensor([ilen], device=device))[0, :ilen]
        got = torch.from_numpy(np.asarray(sample["recon"], np.float32)).to(device)[:ilen]
        if got.shape != want.shape:  # a row served short of its valid samples
            err = float("inf")
        else:
            err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want).clamp_min(1e-9))
    return dict(numbers, recon_err=err)


def judge(codec: fref.FreqCodec, sd, samples: List[dict], n_q: int, device) -> Dict[str, float]:
    """The worst sampled request's numbers."""
    rows = [judge_one(codec, sd, s, n_q, device) for s in samples]
    return {k: max(r[k] for r in rows) for k in rows[0]} if rows else {}


def control_outputs(codec: fref.FreqCodec, sd, sample: dict, n_q: int, device) -> dict:
    """The reference in fp8 put in the program's place: the sample with its
    tokens and PCM16 recomputed by the fp8 control."""
    wav = torch.from_numpy(sample["pcm"].astype(np.float32) / 32768.0).to(device)[None]
    ilen = int(sample["ilen"])
    with torch.no_grad():
        idx, pcm = fref.serve(codec, sd, wav, torch.tensor([ilen], device=device), n_q, ref.Fp8())
    return dict(sample, tokens=idx[:, 0].cpu().numpy(), recon=pcm[0, :ilen].cpu().numpy())


def judge_samples(run: Run, prog: FreqProgram, samples: list) -> dict:
    return judge(prog.codec, prog.sd, samples, prog.n_q, run.device)


def control_samples(run: Run, prog: FreqProgram, samples: list) -> list:
    return [control_outputs(prog.codec, prog.sd, s, prog.n_q, run.device) for s in samples]


def check(run: Run, prog: FreqProgram, samples: list) -> None:
    prog.free()
    codec_side.record(run, judge_samples(run, prog, samples), len(samples))


def span_device_ms(run: Run, name: str) -> Optional[float]:
    """Device milliseconds a batch between the two CUDA events of the
    program's `name` span, mean over the traced slice's batches; None where
    the program records no such span (or no events: the CPU)."""
    try:
        from funcodec_tpu_torch.utils.profiling import device_ms
    except ImportError:  # a program without spans
        return None
    t, batches = run.tracer.result, run.work.get("batches")
    if t is None or not batches:
        return None
    ms = device_ms(name, within=(t.t0_ns, t.t1_ns))
    return None if ms is None else ms / len(batches)
