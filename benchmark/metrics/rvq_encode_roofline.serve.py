"""``rvq_encode`` against its roofline: bf16 latents and codebooks read,
indices and the codeword sum written; 2 x the distance MACs of every stage."""

from benchmark.costs.codec import roofline_share, rvq_bound_s


def read(run):
    return roofline_share(run, "rvq_encode", lambda codec, B, T: rvq_bound_s(codec, B, T, run.work["n_q"]))
