"""Device milliseconds a batch between the two CUDA events of the program's
``istft`` span (softplus(magnitude) times the phase and the iSTFT on cuFFT,
models/freqcodec.FreqCodec._waveform), inside ``decode``; mean over the
traced slice's batches. None where the program records no such span (a
program without it, or the CPU)."""

from benchmark.harness.freqcodec import span_device_ms


def read(run):
    return span_device_ms(run, "istft")
