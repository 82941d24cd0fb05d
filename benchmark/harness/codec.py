"""The codec program under test, built from a configuration file, and what
the codec drivers share: seeded weights, the sample of requests kept for
the check, and the check itself.

The configuration file holds the FunCodec config as run (``funcodec``),
the serving type, the bit width and the program's kernel switches
(``flags``: module attribute -> value). The weights are the benchmark's,
drawn from the seed and loaded into the program; the reference reads the
same tensors.
"""

from __future__ import annotations

import importlib
import sys
from typing import List

import numpy as np
import torch

from benchmark.harness import weights
from benchmark.harness.context import Run
from benchmark.reference import codec as ref
from benchmark.reference import judge

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def set_flags(flags: dict) -> None:
    for path, value in flags.items():
        module, attr = path.rsplit(".", 1)
        setattr(importlib.import_module(module), attr, value)


class CodecProgram:
    """Speech2Token over the benchmark's weights, with the reference's view."""

    def __init__(self, run: Run):
        conf = run.cell.config
        self.funcodec = conf["funcodec"]
        self.dtype = conf["dtype"]
        self.bit_width = conf["bit_width"]
        set_flags(conf.get("flags", {}))
        from funcodec_tpu_torch.cli.codec_inference import Speech2Token

        self.codec = ref.Codec.from_config(self.funcodec)
        self.sd = weights.draw(self.codec.param_specs(), run.seed, run.device,
                               {"encoder.": DTYPES[self.dtype], "decoder.": DTYPES[self.dtype]})
        self.s2t = Speech2Token(self.funcodec, None, dtype=self.dtype, bit_width=self.bit_width, device=run.device)
        self.s2t.model.load_state_dict(self.sd, strict=True)
        self.hop = self.s2t.hop_length
        self.sr = int(self.funcodec.get("sampling_rate", 16000))
        self.n_q = self.s2t.model.quantizer.n_q_for_bandwidth(self.bit_width)

    def serve(self, pcm: np.ndarray, ilens: List[int]):
        """dispatch() as the CLI drives it: int16 PCM in, the recon as PCM16."""
        return self.s2t.dispatch(pcm, bit_width=self.bit_width, run_mod="inference", pcm16_ilens=ilens)

    def collect(self, out):
        codes, _, recon, _ = self.s2t.collect(out, need_sub_quants=False)
        return np.asarray(codes[0]), recon

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.s2t = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def keep(samples: list, pcm_row: np.ndarray, ilen: int, tokens: np.ndarray, recon: np.ndarray) -> None:
    """A request kept for the check: its padded input row, its valid
    length, the tokens of the row and the valid part of the PCM16."""
    samples.append(dict(pcm=pcm_row.copy(), ilen=int(ilen), tokens=tokens.copy(), recon=recon[:ilen].copy()))


def judge_samples(run: Run, prog: CodecProgram, samples: list) -> dict:
    """The kept requests' numbers against the float32 reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return judge.judge(prog.codec, prog.sd, samples, prog.n_q, run.device)


def control_samples(run: Run, prog: CodecProgram, samples: list) -> list:
    """The kept requests as the fp8 control serves them."""
    return [judge.control_outputs(prog.codec, prog.sd, s, prog.n_q, run.device) for s in samples]


def record(run: Run, numbers: dict, judged: int) -> None:
    """Each number with a limit in the cell's file is compared; the rest are
    printed for the record."""
    limits = run.cell.workload.get("limits", {})
    for name, value in numbers.items():
        if name in limits:
            run.checks[name] = [value, limits[name]]
        else:
            run.notes.append(f"{name} = {value!r} (recorded, not compared)")
    print(f"benchmark: judged {judged} requests of the window", file=sys.stderr)


def check(run: Run, prog: CodecProgram, samples: list) -> None:
    prog.free()
    record(run, judge_samples(run, prog, samples), len(samples))
