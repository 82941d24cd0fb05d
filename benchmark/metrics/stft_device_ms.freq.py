"""Device milliseconds a batch between the two CUDA events of the program's
``stft`` span (FreqCodec's feature build: the center STFT on cuFFT and the
log-magnitude / unit-phase features, models/freqcodec.FreqCodec._features),
inside ``encode``; mean over the traced slice's batches. None where the
program records no such span (a program without it, or the CPU)."""

from benchmark.harness.freqcodec import span_device_ms


def read(run):
    return span_device_ms(run, "stft")
