"""Device milliseconds a batch between the two CUDA events of the program's
``encode`` span in the FreqCodec cell (audio normalisation, the ``stft``
span and the 2D SEANet encoder with its LSTM and 1D tail); mean over the
traced slice's batches. None where the program records no such span (a
program without it, or the CPU)."""

from benchmark.harness.freqcodec import span_device_ms


def read(run):
    return span_device_ms(run, "encode")
