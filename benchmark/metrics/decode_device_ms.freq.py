"""Device milliseconds a batch between the two CUDA events of the program's
``decode`` span in the FreqCodec cell (the 1D head, LSTM and 2D SEANet
decoder, then the ``istft`` span); mean over the traced slice's batches.
None where the program records no such span (a program without it, or the
CPU)."""

from benchmark.harness.freqcodec import span_device_ms


def read(run):
    return span_device_ms(run, "decode")
