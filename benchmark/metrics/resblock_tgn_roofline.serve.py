"""``resblock_tgn`` (its passes and finalizes) against its roofline: each
block's bf16 x read and y written once, its weights once."""

from benchmark.costs.codec import resblock_bound_s, roofline_share


def read(run):
    return roofline_share(run, "resblock_tgn", resblock_bound_s)
