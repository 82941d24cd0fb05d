"""The TTS service's share (%) of the chip's bf16 peak over the traced
slice: the FLOPs of the shapes the program ran in it (every slot's decode
steps, the admitted requests' prefix embeddings and prefills, the
synthesised requests' text and codec encoders and SEANet decodes; from
shapes, costs/laura.py) over the slice's length."""

from benchmark.costs.codec import PEAKS
from benchmark.costs.laura import slice_flops


def read(run):
    t = run.tracer.result
    if t is None or t.window_s <= 0 or not run.work.get("steps"):
        return None
    return 100.0 * slice_flops(run) / (t.window_s * PEAKS["bf16_flops_per_s"])
