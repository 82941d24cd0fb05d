"""Data parallelism over torch.distributed (counterpart of funcodec_tpu/parallel)."""
